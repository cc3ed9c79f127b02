"""RMSNorm and LayerNorm with fp32 statistics, and the fused
RMSNorm + per-row int8 quantize of the W8A8 prefill (counterpart of
`ullava_tpu/ops/norms.py:60-78,116-263`).

Two CUDA kernels live in `kernels/csrc/rms_quant.cu`, both one block per
row: `rms_norm_residual_quant` (also the no-residual `rms_norm_quant`)
and the RMSNorm forward, which `rms_norm` launches for every input on
the card: a prefill's thousands of rows and a decode step's handful
alike (the JAX package gates its kernel at 4096 rows for the sake of its
compiler's fusion in training; nothing of that holds here). Each wrapper
runs its plain version only for CPU tensors."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch import kernels

# The row kernels stage one fp32 row in the 48 KB of shared memory a block
# gets without asking for more (less 128 bytes of reduction scratch).
MAX_ROW_WIDTH = (48 * 1024 - 128) // 4


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of `rms_norm`: x / rms(x) * w, statistics in fp32."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _check_row_kernel(name: str, x: torch.Tensor, weight: torch.Tensor) -> Tuple[int, int]:
    D = x.shape[-1]
    if D % 8 or D > MAX_ROW_WIDTH:
        raise ValueError(f"{name}: row width {D} must be a multiple of 8, at most {MAX_ROW_WIDTH}")
    kernels.check_cuda_tensor(f"{name} x", x, torch.bfloat16)
    kernels.check_cuda_tensor(f"{name} weight", weight, torch.bfloat16, (D,))
    return x.numel() // D, D


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LLaMA RMSNorm. CUDA inputs go through the row kernel (bf16 only),
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    rows, D = _check_row_kernel("rms_norm", x, weight)
    out = torch.empty_like(x)
    kernels.launch(
        "rms_norm_fwd", x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, D, float(eps)
    )
    return out


def rms_norm_residual_quant_plain(
    x: torch.Tensor, res: Optional[torch.Tensor], weight: torch.Tensor, eps: float = 1e-6
):
    """Plain version of the fused kernel. `h = x + res` is summed in fp32
    and stored in x's dtype; the norm and the quantization start from the
    UNROUNDED fp32 sum. Returns (h or None, int8 rows, [rows, 1] raw
    abs-max of the normed row, floored at 1e-12)."""
    xf = x.float()
    h = None
    if res is not None:
        xf = xf + res.float()
        h = xf.to(x.dtype)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    n = xf * r * weight.float()
    amax = n.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    q = torch.round(n * (127.0 / amax)).to(torch.int8)
    return h, q, amax.reshape(-1, 1)


def _rms_quant(x, res, weight, eps):
    if x.device.type == "cpu":
        return rms_norm_residual_quant_plain(x, res, weight, eps)
    rows, D = _check_row_kernel("rms_norm_residual_quant", x, weight)
    h = None
    if res is not None:
        kernels.check_cuda_tensor("rms_norm_residual_quant res", res, torch.bfloat16, x.shape)
        h = torch.empty_like(x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    amax = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    kernels.launch(
        "rms_norm_residual_quant", x.data_ptr(), None if res is None else res.data_ptr(),
        weight.data_ptr(), None if h is None else h.data_ptr(), q.data_ptr(),
        amax.data_ptr(), rows, D, float(eps),
    )
    return h, q, amax


def rms_norm_quant(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 rows of RMSNorm(x), [rows, 1] f32 raw abs-max) in one pass
    over x. Pair with `quant.apply_linear_a8_prequant`."""
    _, q, amax = _rms_quant(x, None, weight, eps)
    return q, amax


def rms_norm_residual_quant(
    x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h = x + res, int8 rows of RMSNorm(h), [rows, 1] abs-max): the
    pre-norm residual add, the norm and the W8A8 activation quantize in
    one pass over the [rows, D] stream."""
    if res.shape != x.shape:
        raise ValueError(f"res {tuple(res.shape)} must match x {tuple(x.shape)}")
    return _rms_quant(x, res, weight, eps)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis (CLIP/SAM towers), statistics in fp32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)
