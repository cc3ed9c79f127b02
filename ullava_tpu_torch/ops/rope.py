"""Rotary position embeddings, rotate-half (GPT-NeoX / HF-LLaMA) layout
(counterpart of `ullava_tpu/ops/rope.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch import kernels


def rope_cos_sin(
    positions: torch.Tensor,  # [B, S] or [S] integer
    head_dim: int,
    theta: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables for the given positions: [..., S, head_dim]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=positions.device) / head_dim)
    )
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos(), angles.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    cos: torch.Tensor,  # [B, S, D] or [S, D]
    sin: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,  # None: fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding on q and k, broadcast over the head axis, computed
    in `compute_dtype` (fp32 by default; the weights' dtype where the
    config sets `rope_f32=False`, with the tables and every product and
    sum rounded to it, as the JAX `apply_rotary` does)."""
    cd = compute_dtype or torch.float32
    c = cos.unsqueeze(-2).to(cd)
    s = sin.unsqueeze(-2).to(cd)
    qf, kf = q.to(cd), k.to(cd)
    q_out = qf * c + _rotate_half(qf) * s
    k_out = kf * c + _rotate_half(kf) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)


def fused_rotary_plain(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, head_dim: int
) -> torch.Tensor:
    """Plain version of `fused_rotary`: fp32 math, output in x.dtype."""
    R, width = x.shape
    xf = x.float().reshape(R, width // head_dim, head_dim)
    c = cos.float()[:, None, :]
    s = sin.float()[:, None, :]
    return (xf * c + _rotate_half(xf) * s).reshape(R, width).to(x.dtype)


def fused_rotary(
    x: torch.Tensor,  # [R, H*hd] flat rows (R = B*S)
    cos: torch.Tensor,  # [R, hd]
    sin: torch.Tensor,  # [R, hd]
    head_dim: int,
) -> torch.Tensor:
    """One-pass rotary rotation of flat rows: the CUDA kernel
    (`kernels/csrc/rope.cu`) for CUDA tensors, the plain version for CPU
    tensors. fp32 arithmetic, output in x.dtype."""
    R, width = x.shape
    if cos.shape != (R, head_dim) or sin.shape != (R, head_dim):
        raise ValueError(f"cos/sin must be [{R}, {head_dim}], got {tuple(cos.shape)}")
    if width % head_dim or head_dim % 4:
        raise ValueError(f"width {width} / head_dim {head_dim} not supported")
    if x.device.type == "cpu":
        return fused_rotary_plain(x, cos, sin, head_dim)
    kernels.check_cuda_tensor("fused_rotary x", x, torch.bfloat16)
    kernels.check_cuda_tensor("fused_rotary cos", cos, torch.float32)
    kernels.check_cuda_tensor("fused_rotary sin", sin, torch.float32)
    out = torch.empty_like(x)
    kernels.launch(
        "fused_rotary", kernels.ptr(x), kernels.ptr(cos), kernels.ptr(sin),
        kernels.ptr(out), R, width, head_dim,
    )
    return out
