"""RMSNorm and LayerNorm with fp32 statistics (counterpart of
`ullava_tpu/ops/norms.py:217-263`).

Plain PyTorch only: the TPU's `_rms_norm_pallas` runs at 4096 rows and
more, which the ported serving slice (B*S < 4096) never reaches."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LLaMA RMSNorm: x / rms(x) * w, statistics in fp32."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis (CLIP/SAM towers), statistics in fp32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)
