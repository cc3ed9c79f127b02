"""RMSNorm and LayerNorm with fp32 statistics, the RMSNorm backward, and
the fused RMSNorm + per-row int8 quantize of the W8A8 prefill
(counterpart of `ullava_tpu/ops/norms.py:21-263`).

Two CUDA kernels live in `kernels/csrc/rms_quant.cu`:
`rms_norm_residual_quant` (also the no-residual `rms_norm_quant`), one
block per row, and the RMSNorm forward, which `rms_norm` launches for
every input on the card: a prefill's thousands of rows and a decode
step's handful alike (the JAX package gates its kernel at 4096 rows for
the sake of its compiler's fusion in training; nothing of that holds
here). The forward has two forms, both one block a row: up to
`RMS_FEW_ROWS` rows (a decode step's) every thread holds its vectors of
x and w in registers, loaded together at entry (one memory round trip,
one barrier); above it the row is staged in shared memory. Under
autograd `rms_norm` is the Function `_RMSNorm` (the JAX package's
custom VJP `_rms_norm_pallas`): its forward is the same kernel, its
backward `rms_norm_bwd` (`kernels/csrc/rms_norm_bwd.cu`), with the
weight's gradient only where the weight needs one. Each wrapper runs its
plain version only for CPU tensors."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch import kernels

# The row kernels stage one fp32 row in the 48 KB of shared memory a block
# gets without asking for more (less 128 bytes of reduction scratch).
MAX_ROW_WIDTH = (48 * 1024 - 128) // 4
# The most rows for which the RMSNorm forward takes its few-row form: the
# crossover with the staged form at D 4096 on an H100 (PERF.md, K9;
# `chip_smoke.py`'s `rms_norm_fwd` line times both forms by row count).
RMS_FEW_ROWS = 1024


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


def _rms_norm_fwd_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                       few_rows: bool) -> torch.Tensor:
    """The CUDA RMSNorm forward in the form `few_rows` names (x and w in
    registers, or the row staged in shared memory)."""
    rows, D = _check_row_kernel("rms_norm", x, weight)
    out = torch.empty_like(x)
    kernels.launch(
        "rms_norm_fwd", kernels.ptr(x), kernels.ptr(weight), kernels.ptr(out), rows, D, float(eps),
        int(few_rows),
    )
    return out


def _rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    return _rms_norm_fwd_cuda(x, weight, eps, x.numel() // x.shape[-1] <= RMS_FEW_ROWS)


def rms_norm_bwd_plain(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
    need_dw: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of `rms_norm_bwd`, in the arithmetic of the TPU kernel
    (`ullava_tpu/ops/norms.py:28-44`): r recomputed from x in fp32,
    c = sum(dy*w*x)/D, dx = (dy*w - x*r^2*c)*r in x's dtype, dw the fp32
    sum over rows of dy*x*r in w's dtype (None unless `need_dw`)."""
    D = x.shape[-1]
    xf, dyf = x.float().reshape(-1, D), dy.float().reshape(-1, D)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    dyw = dyf * weight.float()
    c = (dyw * xf).sum(-1, keepdim=True) * (1.0 / D)
    dx = ((dyw - xf * (r * r) * c) * r).to(x.dtype).reshape(x.shape)
    dw = (dyf * xf * r).sum(0).to(weight.dtype) if need_dw else None
    return dx, dw


# The backward kernel holds a row's x and dy in the registers of 128
# threads, at most 8 vectors of 8 each (`kernels/csrc/rms_norm_bwd.cu`).
MAX_BWD_ROW_WIDTH = 8 * 8 * 128
# Partial dw rows of the backward kernel a streaming multiprocessor: one a
# block, summed by a second pass in a fixed order.
BWD_DW_BLOCKS_PER_SM = 1


def _rms_norm_bwd_cuda(x, weight, dy, eps, need_dw):
    rows, D = _check_row_kernel("rms_norm_bwd", x, weight)
    if D > MAX_BWD_ROW_WIDTH:
        raise ValueError(f"rms_norm_bwd: row width {D} exceeds {MAX_BWD_ROW_WIDTH}")
    kernels.check_cuda_tensor("rms_norm_bwd dy", dy, torch.bfloat16, x.shape)
    dx = torch.empty_like(x)
    dw = partial = None
    max_blocks = 0
    if need_dw:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        max_blocks = max(1, min(rows, BWD_DW_BLOCKS_PER_SM * sms))
        dw = torch.empty_like(weight)
        partial = torch.empty((max_blocks, D), dtype=torch.float32, device=x.device)
    kernels.launch(
        "rms_norm_bwd", kernels.ptr(x), kernels.ptr(weight), kernels.ptr(dy), kernels.ptr(dx),
        None if partial is None else kernels.ptr(partial), None if dw is None else kernels.ptr(dw),
        rows, D, max_blocks, float(eps),
    )
    return dx, dw


def rms_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
    need_dw: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dw) of `rms_norm(x, weight)` for the output gradient `dy`; dw
    is None unless `need_dw`. CUDA kernel `kernels/csrc/rms_norm_bwd.cu`
    (bf16, rows up to `MAX_BWD_ROW_WIDTH` wide) for CUDA tensors, the plain
    version for CPU tensors."""
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, dy, eps, need_dw)
    return _rms_norm_bwd_cuda(x, weight, dy, eps, need_dw)


class _RMSNorm(torch.autograd.Function):
    """`rms_norm` under autograd (the JAX custom VJP `_rms_norm_pallas`):
    saves x and w, and its backward is `rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, dy.contiguous(), ctx.eps, ctx.needs_input_grad[1])
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LLaMA RMSNorm. CUDA inputs go through the row kernel (bf16 only),
    CPU tensors take the plain version; where autograd records the call,
    through `_RMSNorm`, whose backward is the backward kernel or its
    plain version."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_norm_fwd(x, weight, eps)


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
    # A true division: `127.0 / amax` on a tensor is reciprocal-then-multiply.
    q = torch.round(n * (torch.full_like(amax, 127.0) / amax)).to(torch.int8)
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
        "rms_norm_residual_quant", kernels.ptr(x), None if res is None else kernels.ptr(res),
        kernels.ptr(weight), None if h is None else kernels.ptr(h), kernels.ptr(q),
        kernels.ptr(amax), rows, D, float(eps),
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
