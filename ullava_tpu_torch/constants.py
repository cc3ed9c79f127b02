"""Constants the serving path needs (the port keeps its own copy of the
JAX package's `constants.py`, which it does not import)."""

IGNORE_INDEX = -100

# Default token ids in the released 7B vocabulary.
DEFAULT_SEG_TOKEN_IDX = 32007
DEFAULT_LOC_TOKEN_IDX = 32008

# Image geometry: CLIP ViT-L/14 at 224x224 -> 16x16 = 256 patch tokens.
DEFAULT_IMAGE_SIZE = 224
DEFAULT_PATCH_SIZE = 14
DEFAULT_IMAGE_TOKEN_LEN = 256

# SAM geometry.
SAM_IMAGE_SIZE = 1024
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)

# CLIP normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
