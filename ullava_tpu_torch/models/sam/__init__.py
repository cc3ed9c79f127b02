"""SAM (Segment Anything) in PyTorch (counterpart of `ullava_tpu/models/sam`):
ViTDet image encoder, prompt encoder with point, box, mask and text
prompts (the u-LLaVA [SEG] injection point), the two-way-transformer mask
decoder, `SamPredictor`, `SamAutomaticMaskGenerator` and the decoder
export."""

from ullava_tpu_torch.models.sam.image_encoder import (  # noqa: F401
    SamVisionConfig,
    encode as encode_sam_image,
)
from ullava_tpu_torch.models.sam.prompt_encoder import (  # noqa: F401
    SamPromptConfig,
    dense_positional_embedding,
    encode_prompts,
)
from ullava_tpu_torch.models.sam.mask_decoder import (  # noqa: F401
    SamDecoderConfig,
    decode_masks,
)
from ullava_tpu_torch.models.sam.build import (  # noqa: F401
    SamConfig,
    init_sam_params,
    sam_vit_b,
    sam_vit_h,
    sam_vit_l,
)
from ullava_tpu_torch.models.sam.export import (  # noqa: F401
    export_sam_decoder,
    load_sam_decoder,
    make_decoder_fn,
)
