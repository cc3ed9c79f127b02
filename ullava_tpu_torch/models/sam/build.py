"""SAM composition, pre- and post-processing (counterpart of
`ullava_tpu/models/sam/build.py`).

`jax.image.resize(..., "bilinear")` samples at half-pixel centres and
antialiases when it shrinks; `F.interpolate(mode="bilinear",
align_corners=False, antialias=True)` does the same in both directions
(antialias changes nothing when enlarging).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.constants import SAM_MEAN, SAM_STD
from ullava_tpu_torch.models.sam import image_encoder, mask_decoder, prompt_encoder

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamConfig:
    vision: image_encoder.SamVisionConfig = dataclasses.field(
        default_factory=image_encoder.SamVisionConfig
    )
    prompt: prompt_encoder.SamPromptConfig = dataclasses.field(
        default_factory=prompt_encoder.SamPromptConfig
    )
    decoder: mask_decoder.SamDecoderConfig = dataclasses.field(
        default_factory=mask_decoder.SamDecoderConfig
    )

    @classmethod
    def tiny(cls) -> "SamConfig":
        return cls(
            vision=image_encoder.SamVisionConfig.tiny(),
            prompt=prompt_encoder.SamPromptConfig.tiny(),
            decoder=mask_decoder.SamDecoderConfig.tiny(),
        )


def sam_vit_h(dtype=torch.bfloat16) -> SamConfig:
    """ViT-H: embed 1280, depth 32, heads 16, global [7, 15, 23, 31]."""
    return SamConfig(
        vision=image_encoder.SamVisionConfig(
            embed_dim=1280, depth=32, num_heads=16,
            global_attn_indexes=(7, 15, 23, 31), dtype=dtype,
        )
    )


def sam_vit_l(dtype=torch.bfloat16) -> SamConfig:
    """ViT-L: embed 1024, depth 24, heads 16 (head_dim 64), global [5, 11, 17, 23]."""
    return SamConfig(
        vision=image_encoder.SamVisionConfig(
            embed_dim=1024, depth=24, num_heads=16,
            global_attn_indexes=(5, 11, 17, 23), dtype=dtype,
        )
    )


def sam_vit_b(dtype=torch.bfloat16) -> SamConfig:
    """ViT-B: embed 768, depth 12, heads 12 (head_dim 64), global [2, 5, 8, 11]."""
    return SamConfig(
        vision=image_encoder.SamVisionConfig(
            embed_dim=768, depth=12, num_heads=12,
            global_attn_indexes=(2, 5, 8, 11), dtype=dtype,
        )
    )


def init_sam_params(
    cfg: SamConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    return {
        "image_encoder": image_encoder.init_params(cfg.vision, gen, device),
        "prompt_encoder": prompt_encoder.init_params(cfg.prompt, gen, device),
        "mask_decoder": mask_decoder.init_params(cfg.decoder, gen, device),
    }


def preprocess(pixel_values: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """[B, H, W, 3] uint8/float RGB -> SAM-normalized fp32, zero-padded at
    the bottom and right to [B, img_size, img_size, 3]. H, W must be <=
    img_size (the host resizes the longest side first)."""
    x = pixel_values.float()
    mean = torch.tensor(SAM_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(SAM_STD, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    _, H, W, _ = x.shape
    return F.pad(x, (0, 0, 0, img_size - W, 0, img_size - H))


def _resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes, half-pixel centres, antialiased
    when shrinking (`jax.image.resize` "bilinear")."""
    lead = x.shape[:-2]
    y = F.interpolate(
        x.float().reshape(1, -1, *x.shape[-2:]), size=tuple(size), mode="bilinear",
        align_corners=False, antialias=True,
    )
    return y.reshape(*lead, *size)


def upscale_masks_to_frame(low_res_masks: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """[B, M, h, w] logits -> bilinear resize to the padded [img_size]^2 frame."""
    return _resize(low_res_masks, (img_size, img_size))


def postprocess_masks_host(
    low_res_masks,  # [M, h, w] logits for ONE sample
    input_size: Tuple[int, int],  # pre-pad resized (H, W)
    original_size: Tuple[int, int],
    img_size: int = 1024,
) -> np.ndarray:
    """Host-side `Sam.postprocess_masks`: upscale to the frame, crop the
    padding, resize to the original resolution."""
    m = torch.as_tensor(np.asarray(low_res_masks, dtype=np.float32))
    up = _resize(m, (img_size, img_size))[:, : input_size[0], : input_size[1]]
    return _resize(up, tuple(original_size)).numpy()


def forward_masks(
    params: Params,
    cfg: SamConfig,
    image_embeddings: torch.Tensor,  # [B, g, g, D] from encode()
    text_embeds: torch.Tensor,  # [B, N, D] projected [SEG] states
    multimask_output: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-encode each text embedding as its own prompt and decode
    masks; returns (low_res_masks [B, N, 4g, 4g], iou_pred [B, N])."""
    B, N, D = text_embeds.shape
    flat_text = text_embeds.reshape(B * N, 1, D)
    sparse, dense = prompt_encoder.encode_prompts(
        params["prompt_encoder"], cfg.prompt, batch=B * N, text_embeds=flat_text
    )
    image_pe = prompt_encoder.dense_positional_embedding(params["prompt_encoder"], cfg.prompt)
    img = image_embeddings.repeat_interleave(N, dim=0)
    low_res, iou = mask_decoder.decode_masks(
        params["mask_decoder"], cfg.decoder, img, image_pe, sparse, dense,
        multimask_output=multimask_output,
    )
    M = low_res.shape[1]
    return (
        low_res.reshape(B, N * M, low_res.shape[2], low_res.shape[3]),
        iou.reshape(B, N * M),
    )
