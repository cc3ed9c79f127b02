"""SAM prompt encoder: point, box and mask prompts, and the projected
[SEG] hidden states that u-LLaVA feeds as sparse text prompts
(counterpart of `ullava_tpu/models/sam/prompt_encoder.py`).

Prompts arrive as dense padded tensors: a point labelled -1 is padding and
takes the not-a-point embedding, as the reference's label -1 path does.
A mask prompt [B, 4g, 4g, 1] is downscaled by two stride-2 2 x 2 convs,
each followed by LayerNorm and the exact GELU, then a 1 x 1 conv to the
embedding width; without one every position gets the no-mask embedding.
The convs are written as reshapes and einsums over NHWC (stride equals
kernel, so nothing overlaps), the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal
from ullava_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamPromptConfig:
    embed_dim: int = 256
    image_embedding_size: int = 64  # 1024 / 16
    input_image_size: int = 1024
    mask_in_chans: int = 16
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw) -> "SamPromptConfig":
        defaults = dict(embed_dim=16, image_embedding_size=4, input_image_size=64,
                        mask_in_chans=4)
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: SamPromptConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    """Random prompt-encoder leaves. The random-Fourier matrix and the
    no-mask embedding draw from `generator`; the point, box and mask
    leaves from a second generator seeded with `generator`'s seed + 1, so
    that the draws `generator` gives every other module of a model do not
    depend on which prompt types the encoder holds."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    D, M, dt = cfg.embed_dim, cfg.mask_in_chans, cfg.dtype
    params = {
        # PositionEmbeddingRandom gaussian matrix, scale 1.0
        "pe_gaussian": normal(gen, (2, D // 2), dt, device, std=1.0),
        "no_mask": normal(gen, (D,), dt, device),
    }
    sub = torch.Generator(device=device).manual_seed(gen.initial_seed() + 1)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    return {
        **params,
        # 4 point embeddings: negative point, positive point, box corners 1 and 2
        "point_embeddings": normal(sub, (4, D), dt, device),
        "not_a_point": normal(sub, (D,), dt, device),
        "mask_conv1": normal(sub, (2, 2, 1, M // 4), dt, device),  # HWIO
        "mask_conv1_bias": zeros(M // 4),
        "mask_ln1_scale": ones(M // 4),
        "mask_ln1_bias": zeros(M // 4),
        "mask_conv2": normal(sub, (2, 2, M // 4, M), dt, device),
        "mask_conv2_bias": zeros(M),
        "mask_ln2_scale": ones(M),
        "mask_ln2_bias": zeros(M),
        "mask_conv3": normal(sub, (1, 1, M, D), dt, device),
        "mask_conv3_bias": zeros(D),
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


def _embed_points(
    params: Params, cfg: SamPromptConfig, points: torch.Tensor, labels: torch.Tensor, pad: bool
) -> torch.Tensor:
    """points [B, N, 2] pixel coords, labels [B, N] in {-1, 0, 1}."""
    pts = points + 0.5  # the pixel centre
    if pad:
        # No box prompt: one padding point with label -1 is appended.
        B = pts.shape[0]
        pts = torch.cat([pts, pts.new_zeros((B, 1, 2))], dim=1)
        labels = torch.cat([labels, labels.new_full((B, 1), -1)], dim=1)
    pe = _pe_encode(params, pts / cfg.input_image_size).to(cfg.dtype)  # [B, N, D]
    point = pe + params["point_embeddings"][labels.clamp(0, 1).long()]
    return torch.where((labels == -1)[..., None], params["not_a_point"].expand_as(pe), point)


def _embed_boxes(params: Params, cfg: SamPromptConfig, boxes: torch.Tensor) -> torch.Tensor:
    """boxes [B, N, 4] xyxy pixels -> [B, 2N, D] corner embeddings."""
    B, N = boxes.shape[:2]
    corners = (boxes.reshape(B, N, 2, 2) + 0.5) / cfg.input_image_size
    pe = _pe_encode(params, corners).to(cfg.dtype)  # [B, N, 2, D]
    pe = pe + params["point_embeddings"][2:4][None, None]
    return pe.reshape(B, 2 * N, -1)


def _conv2x2_stride2(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Conv2d(kernel 2, stride 2, VALID) over NHWC, kernel HWIO [2, 2, I, O]."""
    B, h, w, C = x.shape
    x6 = x.reshape(B, h // 2, 2, w // 2, 2, C)
    return torch.einsum("bhiwjc,ijco->bhwo", x6, kernel) + bias


def _embed_masks(params: Params, cfg: SamPromptConfig, masks: torch.Tensor) -> torch.Tensor:
    """mask_downscaling: [B, 4g, 4g, 1] -> [B, g, g, D]."""
    eps = cfg.layer_norm_eps
    x = _conv2x2_stride2(masks.to(cfg.dtype), params["mask_conv1"], params["mask_conv1_bias"])
    x = F.gelu(layer_norm(x, params["mask_ln1_scale"], params["mask_ln1_bias"], eps))
    x = _conv2x2_stride2(x, params["mask_conv2"], params["mask_conv2_bias"])
    x = F.gelu(layer_norm(x, params["mask_ln2_scale"], params["mask_ln2_bias"], eps))
    return x @ params["mask_conv3"][0, 0] + params["mask_conv3_bias"]


def encode_prompts(
    params: Params,
    cfg: SamPromptConfig,
    *,
    batch: int,
    points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (coords, labels)
    boxes: Optional[torch.Tensor] = None,  # [B, N, 4]
    masks: Optional[torch.Tensor] = None,  # [B, 4g, 4g, 1]
    text_embeds: Optional[torch.Tensor] = None,  # [B, N, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sparse [B, Ns, D], dense [B, g, g, D]): the points (with a
    padding point when no box is given), the box corners and the text
    embeddings as sparse tokens in that order; the downscaled mask, or the
    no-mask embedding, as the dense prompt."""
    g, D = cfg.image_embedding_size, cfg.embed_dim
    parts = []
    if points is not None:
        parts.append(_embed_points(params, cfg, points[0], points[1], boxes is None))
    if boxes is not None:
        parts.append(_embed_boxes(params, cfg, boxes))
    if text_embeds is not None:
        # u-LLaVA: projected [SEG] hidden states ride along as sparse tokens.
        parts.append(text_embeds.to(cfg.dtype))
    if len(parts) == 1:
        sparse = parts[0]
    else:
        sparse = torch.cat([torch.zeros((batch, 0, D), dtype=cfg.dtype,
                                        device=params["pe_gaussian"].device), *parts], dim=1)
    if masks is not None:
        dense = _embed_masks(params, cfg, masks)
    else:
        dense = params["no_mask"].expand(batch, g, g, D)
    return sparse, dense
