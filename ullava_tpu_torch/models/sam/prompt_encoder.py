"""SAM prompt encoder with text-embedding prompts (counterpart of
`ullava_tpu/models/sam/prompt_encoder.py`). Serving feeds projected
[SEG] hidden states as the only sparse prompts and no mask prompt, so
point, box and mask prompts wait."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamPromptConfig:
    embed_dim: int = 256
    image_embedding_size: int = 64  # 1024 / 16
    input_image_size: int = 1024
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw) -> "SamPromptConfig":
        defaults = dict(embed_dim=16, image_embedding_size=4, input_image_size=64)
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: SamPromptConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    D = cfg.embed_dim
    return {
        # PositionEmbeddingRandom gaussian matrix, scale 1.0
        "pe_gaussian": normal(gen, (2, D // 2), cfg.dtype, device, std=1.0),
        "no_mask": normal(gen, (D,), cfg.dtype, device),
    }


def _pe_encode(params: Params, coords: torch.Tensor) -> torch.Tensor:
    """Random-Fourier positional encoding of [..., 2] coords in [0, 1]."""
    c = coords.float() * 2.0 - 1.0
    proj = 2.0 * math.pi * (c @ params["pe_gaussian"].float())
    return torch.cat([proj.sin(), proj.cos()], dim=-1)


def dense_positional_embedding(params: Params, cfg: SamPromptConfig) -> torch.Tensor:
    """get_dense_pe(): [grid, grid, D] PE of the image embedding grid."""
    g = cfg.image_embedding_size
    dev = params["pe_gaussian"].device
    c = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    grid = torch.stack([xs, ys], dim=-1)  # [g, g, 2] (x, y)
    return _pe_encode(params, grid).to(cfg.dtype)


def encode_prompts(
    params: Params,
    cfg: SamPromptConfig,
    *,
    batch: int,
    text_embeds: torch.Tensor,  # [B, N, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sparse [B, N, D], dense [B, g, g, D]) for text prompts."""
    g, D = cfg.image_embedding_size, cfg.embed_dim
    sparse = text_embeds.to(cfg.dtype)
    dense = params["no_mask"].expand(batch, g, g, D)
    return sparse, dense
