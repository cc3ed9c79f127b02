"""Token strings and global constants (the port keeps its own copy of the
JAX package's `constants.py`, which it does not import)."""

IGNORE_INDEX = -100

# Special tokens.
DEFAULT_PAD_TOKEN = "[PAD]"
DEFAULT_BOS_TOKEN = "<s>"
DEFAULT_EOS_TOKEN = "</s>"
DEFAULT_UNK_TOKEN = "<unk>"

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<image_patch>"
DEFAULT_IMG_START_TOKEN = "<img_beg>"
DEFAULT_IMG_END_TOKEN = "</img_end>"

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VIDEO_PATCH_TOKEN = "<video_patch>"
DEFAULT_VID_START_TOKEN = "<vid_beg>"
DEFAULT_VID_END_TOKEN = "</vid_end>"

DEFAULT_SEG_TOKEN = "[SEG]"
DEFAULT_LOC_TOKEN = "[LOC]"
DEFAULT_TAG_START = "[tag]"
DEFAULT_TAG_END = "[/tag]"

# The six multimodal tokens added in stage 1 (the order fixes their ids).
MM_TOKENS = (
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMG_START_TOKEN,
    DEFAULT_IMG_END_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VID_END_TOKEN,
)

# Tokens added in stage 2.
STAGE2_TOKENS = (
    DEFAULT_SEG_TOKEN,
    DEFAULT_LOC_TOKEN,
    DEFAULT_TAG_START,
    DEFAULT_TAG_END,
)

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
