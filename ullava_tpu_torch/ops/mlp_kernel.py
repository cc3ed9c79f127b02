"""Fused int8 kernels of the MLP and projection sites (counterpart of
`ullava_tpu/ops/mlp_kernel.py:37-720`).

- `silu_mul_quant`: SwiGLU gate + per-row int8 quantize of the W8A8 LLM
  prefill MLP.
- `fused_ln_linear` / `fused_linear`: optional LayerNorm, per-row int8
  activations, int8 x int8 product with an int8 weight, rescale, bias and
  optional residual (the SAM global blocks' LN1+qkv and proj+residual).
- `fused_mlp_block`: `x + fc2(gelu(fc1(LN(x))))` of a SAM block with both
  products in int8, the polynomial-erf GELU and the GELU output
  re-quantized per row and per `f_chunk` columns.
- `fused_mlp_block_v2`: the same function (W8A8 only) as one kernel that
  issues fc1 of chunk k before the re-quantization and fc2 of chunk k - 1
  and keeps each chunk's int8 GELU output on chip; its one caller is the
  MLP microbenchmark (`microbench/mlp_variants.py`).

Each has its plain PyTorch version beside it, taken for CPU tensors. With
`w8a8=False` (weight-only) the three SAM functions keep the LN'd row in
bf16 and widen the int8 weight to bf16 inside the kernel
(`kernels/csrc/ln_linear_wq.cu`, `mlp_block_wq.cu` on
`bf16_wq_gemm_core.cuh`). A weight `q` is `[in, out]` stored column-major
(`quant.column_major`), as every int8 leaf of the port is; the CUDA
wrappers check that and raise, they do not copy. The 3-D (whole windows
per program) form of `fused_mlp_block` has no caller and is not carried
over; `block_t` moves no value and is dropped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.ops.norms import MAX_ROW_WIDTH
from ullava_tpu_torch.ops.quant import int8_matmul

# Degree-7 fit of erf(t)/t in t^2 on |t| <= 3, saturated to +-1 beyond
# (max |gelu error| against the exact erf 8.2e-4): the fused MLP's GELU.
_ERF_CLAMP = 3.0
_ERF_COEF = (
    1.128298328383344, -0.37489969643977966, 0.10971839155099318,
    -0.023743737062092228, 0.0036059320467746367, -0.0003563589626086337,
    2.0252568341883032e-05, -4.971512367804531e-07,
)
_PLAIN_ROWS = 8192  # rows per pass of the plain versions (bounds their fp32 temporaries)
_MAX_LN_WIDTH = 2048  # the CUDA row pass keeps a row in one warp's registers


def silu_mul_quant_plain(gate: torch.Tensor, up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `silu_mul_quant`: `g * sigmoid(g) * u` in fp32,
    raw per-row abs-max floored at 1e-12, rows rounded half to even."""
    gf, uf = gate.float(), up.float()
    h = gf * torch.sigmoid(gf) * uf
    amax = h.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    return torch.round(h * (127.0 / amax)).to(torch.int8), amax


def silu_mul_quant(
    gate: torch.Tensor,  # [rows, F] compute dtype
    up: torch.Tensor,  # [rows, F]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 rows, [rows, 1] f32 abs-max) of silu(gate) * up in one pass:
    the gated [rows, F] intermediate never reaches device memory in fp32
    or bf16, only its int8 rows do. Pair with
    `quant.apply_linear_a8_prequant` for the down projection. CUDA kernel
    `kernels/csrc/silu_mul_quant.cu` (bf16) for CUDA tensors, the plain
    version for CPU tensors."""
    if gate.ndim != 2 or up.shape != gate.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and up {tuple(up.shape)} must be equal 2-D")
    if gate.device.type == "cpu":
        return silu_mul_quant_plain(gate, up)
    rows, F = gate.shape
    if F % 8 or F > MAX_ROW_WIDTH:
        raise ValueError(f"silu_mul_quant: width {F} must be a multiple of 8, at most {MAX_ROW_WIDTH}")
    kernels.check_cuda_tensor("silu_mul_quant gate", gate, torch.bfloat16)
    kernels.check_cuda_tensor("silu_mul_quant up", up, torch.bfloat16)
    q = torch.empty((rows, F), dtype=torch.int8, device=gate.device)
    amax = torch.empty((rows, 1), dtype=torch.float32, device=gate.device)
    kernels.launch(
        "silu_mul_quant", gate.data_ptr(), up.data_ptr(), q.data_ptr(), amax.data_ptr(), rows, F
    )
    return q, amax


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Polynomial erf: t * P(t^2) by Horner, saturated past the clamp."""
    a = x.abs()
    t = a.clamp_max(_ERF_CLAMP)
    u = t * t
    p = torch.full_like(u, _ERF_COEF[-1])
    for c in _ERF_COEF[-2::-1]:
        p = p * u + c
    e = torch.where(a > _ERF_CLAMP, torch.ones_like(t), t * p)
    return torch.sign(x) * e


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf(x * (2.0**-0.5)))


def _row_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 dynamic quantization in fp32: (int8 rows,
    [rows, 1] scale `max(amax, 1e-12) / 127`); rounds half to even."""
    x = x.float()
    amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    # A true division: `127.0 / amax` on a tensor is reciprocal-then-multiply.
    qs = torch.full_like(amax, 127.0) / amax
    return torch.round(x * qs).to(torch.int8), amax * (1.0 / 127.0)


def _ln_f32(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _check_weight(name: str, w_q: torch.Tensor, K: int) -> int:
    """An int8 `[K, N]` weight stored column-major; returns N."""
    if w_q.dtype != torch.int8 or w_q.ndim != 2 or w_q.shape[0] != K:
        raise ValueError(f"{name}: expected an int8 [{K}, N] weight, got {w_q.dtype} {tuple(w_q.shape)}")
    if w_q.device.type == "cuda":
        if w_q.stride() != (1, K) or w_q.data_ptr() % 16:
            raise ValueError(
                f"{name}: the int8 weight must be stored column-major "
                f"(quant.column_major), got strides {w_q.stride()}"
            )
    return w_q.shape[1]


# ---------------------------------------------------------------------------
# fused_ln_linear / fused_linear
# ---------------------------------------------------------------------------


def _ln_linear_parts_plain(x2, ln_scale, ln_bias, w_q, w_scale, bias, eps, w8a8, res2):
    """Plain `fused_ln_linear` on [rows, C]: (y, int8 rows or None, row
    scales or None)."""
    ys, xqs, xss = [], [], []
    ws = w_scale.reshape(1, -1).float()
    for r0 in range(0, x2.shape[0], _PLAIN_ROWS):
        xf = x2[r0:r0 + _PLAIN_ROWS].float()
        if ln_scale is not None:
            xf = _ln_f32(xf, ln_scale, ln_bias, eps)
        if w8a8:
            xq, xs = _row_quant(xf)
            y = int8_matmul(xq, w_q).float() * (xs * ws) + bias.float()
            xqs.append(xq)
            xss.append(xs)
        else:
            # bf16 operands, fp32 accumulation, the scale after the product.
            y = (xf.to(x2.dtype).float() @ w_q.float()) * ws + bias.float()
        if res2 is not None:
            y = y + res2[r0:r0 + _PLAIN_ROWS].float()
        ys.append(y.to(x2.dtype))
    if not w8a8:
        return torch.cat(ys), None, None
    return torch.cat(ys), torch.cat(xqs), torch.cat(xss)


def fused_ln_linear_plain(
    x, ln_scale, ln_bias, w_q, w_scale, bias, eps: float, w8a8: bool = True, residual=None
) -> torch.Tensor:
    C, N = x.shape[-1], w_q.shape[1]
    res2 = None if residual is None else residual.reshape(-1, N)
    y, _, _ = _ln_linear_parts_plain(
        x.reshape(-1, C), ln_scale, ln_bias, w_q, w_scale, bias, eps, w8a8, res2
    )
    return y.reshape(*x.shape[:-1], N)


def _check_ln_linear(x2, ln_scale, ln_bias, w_q, w_scale, bias, res2, row_pass: bool) -> int:
    """Validate the operands of a CUDA `fused_ln_linear` on [rows, C];
    returns N. A row pass (the int8 form's quantization, or a LayerNorm)
    holds a row in one warp's registers, so C is at most 2048 there."""
    rows, C = x2.shape
    N = _check_weight("fused_ln_linear", w_q, C)
    if C % 16 or N % 8 or (row_pass and C > _MAX_LN_WIDTH):
        raise ValueError(
            f"fused_ln_linear: C {C} must be a multiple of 16"
            f"{f' up to {_MAX_LN_WIDTH}' if row_pass else ''}, N {N} of 8"
        )
    bf = torch.bfloat16
    kernels.check_cuda_tensor("fused_ln_linear x", x2, bf)
    kernels.check_cuda_tensor("fused_ln_linear w_scale", w_scale, torch.float32)
    kernels.check_cuda_tensor("fused_ln_linear bias", bias, bf, (N,))
    if w_scale.numel() != N:
        raise ValueError(f"fused_ln_linear: w_scale must hold {N} values")
    if ln_scale is not None:
        kernels.check_cuda_tensor("fused_ln_linear ln_scale", ln_scale, bf, (C,))
        kernels.check_cuda_tensor("fused_ln_linear ln_bias", ln_bias, bf, (C,))
    if res2 is not None:
        kernels.check_cuda_tensor("fused_ln_linear residual", res2, bf, (rows, N))
    return N


def _ln_linear_cuda(x2, ln_scale, ln_bias, w_q, w_scale, bias, eps, res2, stages=3, scratch=None):
    """The CUDA `fused_ln_linear` on [rows, C]: (y, int8 rows, row scales).
    `stages` selects the row pass (1) and the product (2) so that each
    can be timed alone on the `scratch` of an earlier full call."""
    rows, C = x2.shape
    N = _check_ln_linear(x2, ln_scale, ln_bias, w_q, w_scale, bias, res2, row_pass=True)
    dev, bf = x2.device, torch.bfloat16
    out = torch.empty((rows, N), dtype=bf, device=dev)
    xq, xs = scratch or (
        torch.empty((rows, C), dtype=torch.int8, device=dev),
        torch.empty((rows, 1), dtype=torch.float32, device=dev),
    )
    kernels.launch(
        "fused_ln_linear", x2.data_ptr(),
        None if ln_scale is None else ln_scale.data_ptr(),
        None if ln_scale is None else ln_bias.data_ptr(),
        w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        None if res2 is None else res2.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), rows, C, N, float(eps), stages,
    )
    return out, xq, xs


def _ln_linear_wq_cuda(x2, ln_scale, ln_bias, w_q, w_scale, bias, eps, res2, stages=3,
                       scratch=None):
    """The weight-only CUDA `fused_ln_linear` on [rows, C]: (y, the LN'd
    bf16 rows or None without a LayerNorm). `stages` selects the row pass
    (1) and the product (2) so that each can be timed alone on the
    `scratch` of an earlier full call."""
    rows, C = x2.shape
    ln = ln_scale is not None
    N = _check_ln_linear(x2, ln_scale, ln_bias, w_q, w_scale, bias, res2, row_pass=ln)
    out = torch.empty((rows, N), dtype=torch.bfloat16, device=x2.device)
    xn = None  # without a LayerNorm the product reads x itself
    if ln:
        xn = scratch if scratch is not None else torch.empty_like(x2)
    kernels.launch(
        "fused_ln_linear_wq", x2.data_ptr(),
        ln_scale.data_ptr() if ln else None, ln_bias.data_ptr() if ln else None,
        w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        None if res2 is None else res2.data_ptr(), out.data_ptr(),
        None if xn is None else xn.data_ptr(), rows, C, N, float(eps), stages,
    )
    return out, xn


def fused_ln_linear(
    x: torch.Tensor,  # [N, T, C] or [T, C]
    ln_scale: Optional[torch.Tensor],  # [C]; None skips the LN (plain linear)
    ln_bias: Optional[torch.Tensor],  # [C]
    w_q: torch.Tensor,  # [C, F] int8, column-major
    w_scale: torch.Tensor,  # [1, F] f32
    bias: torch.Tensor,  # [F]
    eps: float,
    w8a8: bool = True,
    residual: Optional[torch.Tensor] = None,  # x's leading shape + [F], added to the output
) -> torch.Tensor:
    """LN(x) @ W + b (+ residual) in one fused function: LN statistics in
    fp32, the LN'd row quantized to int8 per row, an int8 x int8 product,
    `acc * (row_scale * w_scale) + bias` and one rounding to x's dtype.
    With `w8a8=False` the LN'd row goes to x's dtype instead and meets the
    int8 weight converted to that dtype, the scale after the product. CUDA
    kernels `kernels/csrc/ln_linear_int8.cu` (w8a8) and `ln_linear_wq.cu`
    (weight-only), bf16, for CUDA tensors; the plain version for CPU
    tensors."""
    C, N = x.shape[-1], w_q.shape[1]
    if residual is not None and residual.shape != (*x.shape[:-1], N):
        raise ValueError(f"residual {tuple(residual.shape)} does not match the output")
    if x.device.type == "cpu":
        return fused_ln_linear_plain(x, ln_scale, ln_bias, w_q, w_scale, bias, eps, w8a8, residual)
    res2 = None if residual is None else residual.reshape(-1, N)
    args = (x.reshape(-1, C), ln_scale, ln_bias, w_q, w_scale, bias, eps, res2)
    y = (_ln_linear_cuda if w8a8 else _ln_linear_wq_cuda)(*args)[0]
    return y.reshape(*x.shape[:-1], N)


def fused_linear(
    x: torch.Tensor,  # [N, T, C] or [T, C]
    w_q: torch.Tensor,  # [C, F] int8, column-major
    w_scale: torch.Tensor,  # [1, F] f32
    bias: torch.Tensor,  # [F]
    residual: Optional[torch.Tensor] = None,
    w8a8: bool = True,
) -> torch.Tensor:
    """x @ W + b (+ residual): `fused_ln_linear` without the LayerNorm
    (the post-attention projection)."""
    return fused_ln_linear(x, None, None, w_q, w_scale, bias, 0.0, w8a8=w8a8, residual=residual)


# ---------------------------------------------------------------------------
# fused_ln_linear_dual
# ---------------------------------------------------------------------------


def _ln_linear_dual_parts_plain(x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2,
                                eps, w8a8, rows2):
    """Plain `fused_ln_linear_dual` on [N, T, C]: (y [N, T, F], P [N, rows2,
    F2], int8 rows or None, row scales or None)."""
    N, T, C = x3.shape
    x2 = x3.reshape(N * T, C)
    s1, s2 = w_scale.reshape(1, -1).float(), w2_scale.reshape(1, -1).float()
    ys, ps, xqs, xss = [], [], [], []
    for r0 in range(0, N * T, _PLAIN_ROWS):
        xf = _ln_f32(x2[r0:r0 + _PLAIN_ROWS].float(), ln_scale, ln_bias, eps)
        if w8a8:
            xq, xs = _row_quant(xf)
            y = int8_matmul(xq, w_q).float() * (xs * s1) + bias.float()
            p = int8_matmul(xq, w2_q).float() * (xs * s2) + bias2.float()
            xqs.append(xq)
            xss.append(xs)
        else:
            xh = xf.to(x3.dtype).float()
            y = (xh @ w_q.float()) * s1 + bias.float()
            p = (xh @ w2_q.float()) * s2 + bias2.float()
        ys.append(y.to(x3.dtype))
        ps.append(p.to(x3.dtype))
    y3 = torch.cat(ys).reshape(N, T, -1)
    p3 = torch.cat(ps).reshape(N, T, -1)[:, :rows2]  # the leading rows2 rows of every T
    if not w8a8:
        return y3, p3, None, None
    return y3, p3, torch.cat(xqs), torch.cat(xss)


def fused_ln_linear_dual_plain(
    x, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2, eps: float,
    w8a8: bool = True, rows2: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    x3 = x[None] if x.ndim == 2 else x
    y, p, _, _ = _ln_linear_dual_parts_plain(
        x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2, eps, w8a8,
        rows2 or x3.shape[1],
    )
    return (y[0], p[0]) if x.ndim == 2 else (y, p)


def _check_ln_linear_dual(x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2,
                         rows2) -> Tuple[int, int]:
    """Validate the operands of a CUDA `fused_ln_linear_dual` on [N, T, C];
    returns (F, F2)."""
    N, T, C = x3.shape
    F = _check_weight("fused_ln_linear_dual w", w_q, C)
    F2 = _check_weight("fused_ln_linear_dual w2", w2_q, C)
    if C % 16 or F % 8 or F2 % 8 or C > _MAX_LN_WIDTH:
        raise ValueError(
            f"fused_ln_linear_dual: C {C} must be a multiple of 16 up to {_MAX_LN_WIDTH}, "
            f"F {F} and F2 {F2} of 8"
        )
    if not 0 < rows2 <= T:
        raise ValueError(f"fused_ln_linear_dual: rows2 {rows2} must lie in 1..{T}")
    bf = torch.bfloat16
    kernels.check_cuda_tensor("fused_ln_linear_dual x", x3, bf)
    kernels.check_cuda_tensor("fused_ln_linear_dual ln_scale", ln_scale, bf, (C,))
    kernels.check_cuda_tensor("fused_ln_linear_dual ln_bias", ln_bias, bf, (C,))
    kernels.check_cuda_tensor("fused_ln_linear_dual bias", bias, bf, (F,))
    kernels.check_cuda_tensor("fused_ln_linear_dual bias2", bias2, torch.float32, (F2,))
    for name, t, n in (("w_scale", w_scale, F), ("w2_scale", w2_scale, F2)):
        kernels.check_cuda_tensor(f"fused_ln_linear_dual {name}", t, torch.float32)
        if t.numel() != n:
            raise ValueError(f"fused_ln_linear_dual: {name} must hold {n} values")
    return F, F2


def _ln_linear_dual_cuda(x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2, eps,
                         rows2, stages=7, scratch=None):
    """The CUDA `fused_ln_linear_dual` on [N, T, C]: (y, P, int8 rows, row
    scales). `stages` selects the row pass (1), the first product (2) and
    the second (4) so that each can be timed alone on the `scratch` of an
    earlier full call."""
    N, T, C = x3.shape
    rows = N * T
    F, F2 = _check_ln_linear_dual(x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale,
                                  bias2, rows2)
    dev, bf = x3.device, torch.bfloat16
    y = torch.empty((N, T, F), dtype=bf, device=dev)
    p = torch.empty((N, rows2, F2), dtype=bf, device=dev)
    xq, xs = scratch or (
        torch.empty((rows, C), dtype=torch.int8, device=dev),
        torch.empty((rows, 1), dtype=torch.float32, device=dev),
    )
    kernels.launch(
        "fused_ln_linear_dual", x3.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        w2_q.data_ptr(), w2_scale.data_ptr(), bias2.data_ptr(),
        y.data_ptr(), p.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        rows, C, F, F2, T, rows2, float(eps), stages,
    )
    return y, p, xq, xs


def _ln_linear_dual_wq_cuda(x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2,
                            eps, rows2, stages=7, scratch=None):
    """The weight-only CUDA `fused_ln_linear_dual` on [N, T, C]: (y, P,
    the LN'd bf16 rows). `stages` selects the row pass (1), the first
    product (2) and the second (4) so that each can be timed alone on the
    `scratch` of an earlier full call."""
    N, T, C = x3.shape
    F, F2 = _check_ln_linear_dual(x3, ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale,
                                  bias2, rows2)
    dev, bf = x3.device, torch.bfloat16
    y = torch.empty((N, T, F), dtype=bf, device=dev)
    p = torch.empty((N, rows2, F2), dtype=bf, device=dev)
    xn = scratch if scratch is not None else torch.empty_like(x3)
    kernels.launch(
        "fused_ln_linear_dual_wq", x3.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        w2_q.data_ptr(), w2_scale.data_ptr(), bias2.data_ptr(),
        y.data_ptr(), p.data_ptr(), xn.data_ptr(), N * T, C, F, F2, T, rows2, float(eps), stages,
    )
    return y, p, xn


def fused_ln_linear_dual(
    x: torch.Tensor,  # [N, T, C] (window-major classes) or [T, C]
    ln_scale: torch.Tensor,  # [C]
    ln_bias: torch.Tensor,  # [C]
    w_q: torch.Tensor,  # [C, F] int8, column-major
    w_scale: torch.Tensor,  # [1, F] f32
    bias: torch.Tensor,  # [F]
    w2_q: torch.Tensor,  # [C, F2] int8, column-major (the composite rel-pos bias weights)
    w2_scale: torch.Tensor,  # [1, F2] f32
    bias2: torch.Tensor,  # [F2] f32
    eps: float,
    w8a8: bool = True,
    rows2: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fused_ln_linear` with a second weight on the same LN'd (and
    quantized) rows: (LN(x) @ W + b, LN(x) @ W2 + b2), each rounded once
    to x's dtype. `rows2` (0: T) keeps only the leading `rows2` rows of
    every T in the second output: the padded window layout carries pad
    rows in y but not in the bias-term matrix. CUDA kernels
    `kernels/csrc/ln_linear_int8.cu` (w8a8) and `ln_linear_wq.cu`
    (weight-only), bf16, for CUDA tensors; the plain version for CPU
    tensors."""
    args = (ln_scale, ln_bias, w_q, w_scale, bias, w2_q, w2_scale, bias2, eps)
    if x.device.type == "cpu":
        return fused_ln_linear_dual_plain(x, *args, w8a8, rows2)
    x3 = x[None] if x.ndim == 2 else x
    y, p = (_ln_linear_dual_cuda if w8a8 else _ln_linear_dual_wq_cuda)(
        x3, *args, rows2 or x3.shape[1])[:2]
    return (y[0], p[0]) if x.ndim == 2 else (y, p)


# ---------------------------------------------------------------------------
# fused_mlp_block
# ---------------------------------------------------------------------------


def default_f_chunk(F: int) -> int:
    return 1024 if F % 1024 == 0 else 512


def _mlp_block_parts_plain(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps,
                           f_chunk, w8a8):
    """Plain `fused_mlp_block` on [T, C]: (out, xq, xs, hq [T, F],
    hs [T, F / f_chunk]); the int8 parts are None without w8a8."""
    F = w1_q.shape[1]
    n_chunks = F // f_chunk
    s1, s2 = w1_scale.reshape(1, F).float(), w2_scale.reshape(1, -1).float()
    outs, parts = [], [[], [], [], []]
    for r0 in range(0, x.shape[0], _PLAIN_ROWS):
        xr = x[r0:r0 + _PLAIN_ROWS]
        normed = _ln_f32(xr.float(), ln_scale, ln_bias, eps)
        if w8a8:
            xq, xs = _row_quant(normed)
            h = int8_matmul(xq, w1_q).float() * (xs * s1) + b1.float()
        else:
            h = (normed.to(x.dtype).float() @ w1_q.float()) * s1 + b1.float()
        h = _gelu_exact(h)
        acc = torch.zeros((xr.shape[0], w2_q.shape[1]), dtype=torch.float32, device=x.device)
        if w8a8:
            # One abs-max and scale per row and per chunk of f_chunk columns.
            hq, hs = _row_quant(h.reshape(-1, n_chunks, f_chunk))
            hq, hs = hq.reshape(-1, F), hs.reshape(-1, n_chunks)
            for k in range(n_chunks):
                sl = slice(k * f_chunk, (k + 1) * f_chunk)
                acc += int8_matmul(hq[:, sl].contiguous(), w2_q[sl]).float() * (hs[:, k:k + 1] * s2)
            for lst, part in zip(parts, (xq, xs, hq, hs)):
                lst.append(part)
        else:
            for k in range(n_chunks):
                sl = slice(k * f_chunk, (k + 1) * f_chunk)
                acc += (h[:, sl].to(x.dtype).float() @ w2_q[sl].float()) * s2
        outs.append((acc + b2.float() + xr.float()).to(x.dtype))
    if not w8a8:
        return (torch.cat(outs), None, None, None, None)
    return (torch.cat(outs), *(torch.cat(lst) for lst in parts))


def fused_mlp_block_plain(
    x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps: float,
    f_chunk: int = 0, w8a8: bool = False,
) -> torch.Tensor:
    f_chunk = f_chunk or default_f_chunk(w1_q.shape[1])
    return _mlp_block_parts_plain(
        x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk, w8a8
    )[0]


def _check_mlp_block(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2) -> int:
    """Validate the operands of a CUDA `fused_mlp_block` on [T, C];
    returns F."""
    T, C = x.shape
    F = _check_weight("fused_mlp_block fc1", w1_q, C)
    if _check_weight("fused_mlp_block fc2", w2_q, F) != C:
        raise ValueError(f"fused_mlp_block: fc2 must be [{F}, {C}]")
    if C % 16 or C > _MAX_LN_WIDTH or F % 16:
        raise ValueError(
            f"fused_mlp_block: C {C} must be a multiple of 16 up to {_MAX_LN_WIDTH}, F {F} of 16"
        )
    bf = torch.bfloat16
    kernels.check_cuda_tensor("fused_mlp_block x", x, bf)
    for name, t, n in (("ln_scale", ln_scale, C), ("ln_bias", ln_bias, C), ("b1", b1, F),
                       ("b2", b2, C)):
        kernels.check_cuda_tensor(f"fused_mlp_block {name}", t, bf, (n,))
    for name, t, n in (("w1_scale", w1_scale, F), ("w2_scale", w2_scale, C)):
        kernels.check_cuda_tensor(f"fused_mlp_block {name}", t, torch.float32)
        if t.numel() != n:
            raise ValueError(f"fused_mlp_block: {name} must hold {n} values")
    return F


def _mlp_block_cuda(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk,
                    stages=7, scratch=None):
    """The CUDA `fused_mlp_block`: (out, xq, xs, hq, hs). `stages` selects
    the row pass (1), fc1 (2) and fc2 (4) so that each can be timed alone
    on the `scratch` of an earlier full call."""
    T, C = x.shape
    F = _check_mlp_block(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2)
    if f_chunk % 128 or not 128 <= f_chunk <= 1024:
        raise ValueError(f"fused_mlp_block: f_chunk {f_chunk} must be a multiple of 128 up to 1024")
    dev = x.device
    out = torch.empty_like(x)
    xq, xs, hq, hs = scratch or (
        torch.empty((T, C), dtype=torch.int8, device=dev),
        torch.empty((T, 1), dtype=torch.float32, device=dev),
        torch.empty((T, F), dtype=torch.int8, device=dev),
        torch.empty((T, F // f_chunk), dtype=torch.float32, device=dev),
    )
    kernels.launch(
        "fused_mlp_block", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1_q.data_ptr(), w1_scale.data_ptr(), b1.data_ptr(),
        w2_q.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), hq.data_ptr(), hs.data_ptr(),
        T, C, F, f_chunk, float(eps), stages,
    )
    return out, xq, xs, hq, hs


def _mlp_block_wq_cuda(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps,
                       stages=7, scratch=None):
    """The weight-only CUDA `fused_mlp_block`: (out, the LN'd bf16 rows,
    the bf16 GELU output [T, F]). The kernel's fc2 runs over all of F at
    once (the per-column scale comes after the sum, so `f_chunk` changes
    only fp32 rounding). `stages` selects the row pass (1), fc1 (2) and
    fc2 (4) so that each can be timed alone on the `scratch` of an earlier
    full call."""
    T, C = x.shape
    F = _check_mlp_block(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2)
    out = torch.empty_like(x)
    xn, h = scratch or (torch.empty_like(x),
                        torch.empty((T, F), dtype=torch.bfloat16, device=x.device))
    kernels.launch(
        "fused_mlp_block_wq", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1_q.data_ptr(), w1_scale.data_ptr(), b1.data_ptr(),
        w2_q.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(), out.data_ptr(),
        xn.data_ptr(), h.data_ptr(), T, C, F, float(eps), stages,
    )
    return out, xn, h


def fused_mlp_block(
    x: torch.Tensor,  # [T, C] residual-stream input
    ln_scale: torch.Tensor,  # [C]
    ln_bias: torch.Tensor,  # [C]
    w1_q: torch.Tensor,  # [C, F] int8, column-major
    w1_scale: torch.Tensor,  # [1, F] f32
    b1: torch.Tensor,  # [F]
    w2_q: torch.Tensor,  # [F, C] int8, column-major
    w2_scale: torch.Tensor,  # [1, C] f32
    b2: torch.Tensor,  # [C]
    eps: float,
    f_chunk: int = 0,
    w8a8: bool = False,
) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) as one function. With `w8a8` both
    products are int8 x int8: the LN'd row is quantized once, and the GELU
    output (polynomial erf, fp32) is re-quantized per row and per chunk of
    `f_chunk` columns (0: 1024 when it divides F, else 512), each chunk's
    int32 partial sums rescaled by its own scale into an fp32 sum; then
    `+ b2 + x` and one rounding. Without it the products take the int8
    weights converted to x's dtype and the GELU output rounded to it. CUDA
    kernels `kernels/csrc/mlp_block_int8.cu` (w8a8) and `mlp_block_wq.cu`
    (weight-only), bf16, for CUDA tensors; the plain version for CPU
    tensors."""
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_block takes [T, C] tokens, got {tuple(x.shape)}")
    F = w1_q.shape[1]
    f_chunk = f_chunk or default_f_chunk(F)
    if F % f_chunk:
        raise ValueError(f"fused_mlp_block: F {F} is not a multiple of f_chunk {f_chunk}")
    args = (x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk)
    if x.device.type == "cpu":
        return fused_mlp_block_plain(*args, w8a8)
    if not w8a8:
        return _mlp_block_wq_cuda(*args[:-1])[0]
    return _mlp_block_cuda(*args)[0]


# ---------------------------------------------------------------------------
# fused_mlp_block_v2
# ---------------------------------------------------------------------------

V2_F_CHUNKS = (512, 1024)  # f_chunk / 8 fc1 columns a block of the kernel's 8-block cluster
V2_WIDTH = 1280  # C: SAM ViT-H, the encoder the port builds; C / 8 fc2 columns a block


def fused_mlp_block_v2_plain(
    x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps: float, f_chunk: int = 0,
) -> torch.Tensor:
    """Plain `fused_mlp_block_v2`: the function of `fused_mlp_block(w8a8=True)`,
    whose plain version it is."""
    return fused_mlp_block_plain(
        x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk, w8a8=True)


def _mlp_block_v2_cuda(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk,
                       stages=7, scratch=None):
    """The CUDA `fused_mlp_block_v2`: (out, xq, xs). `stages` selects the
    row pass (1), fc1 with the GELU and its re-quantization (2) and fc2
    with the output (4) so that each can be timed alone on the `scratch`
    of an earlier full call; the GELU output is never stored."""
    T, C = x.shape
    F = _check_mlp_block(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2)
    if f_chunk not in V2_F_CHUNKS or C != V2_WIDTH:
        raise ValueError(
            f"fused_mlp_block_v2: f_chunk {f_chunk} must be one of {V2_F_CHUNKS} and C {C} must "
            f"be {V2_WIDTH}: a cluster of 8 blocks (the portable limit) splits both 8 ways"
        )
    out = torch.empty_like(x)
    xq, xs = scratch or (
        torch.empty((T, C), dtype=torch.int8, device=x.device),
        torch.empty((T, 1), dtype=torch.float32, device=x.device),
    )
    kernels.launch(
        "fused_mlp_block_v2", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1_q.data_ptr(), w1_scale.data_ptr(), b1.data_ptr(),
        w2_q.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), T, C, F, f_chunk, float(eps), stages,
    )
    return out, xq, xs


def fused_mlp_block_v2(
    x: torch.Tensor,  # [T, C] residual-stream input
    ln_scale: torch.Tensor,  # [C]
    ln_bias: torch.Tensor,  # [C]
    w1_q: torch.Tensor,  # [C, F] int8, column-major
    w1_scale: torch.Tensor,  # [1, F] f32
    b1: torch.Tensor,  # [F]
    w2_q: torch.Tensor,  # [F, C] int8, column-major
    w2_scale: torch.Tensor,  # [1, C] f32
    b2: torch.Tensor,  # [C]
    eps: float,
    f_chunk: int = 0,
) -> torch.Tensor:
    """`fused_mlp_block(w8a8=True)` with fc1 of chunk k issued before the
    re-quantization and fc2 of chunk k - 1, the int8 GELU output of a
    chunk kept on chip: the same function and, at the same `f_chunk` (0:
    1024 when it divides F, else 512), the same bf16 output. CUDA kernel
    `kernels/csrc/mlp_block_v2_int8.cu` (bf16; f_chunk 512 or 1024, C 1280)
    for CUDA tensors; the plain version for CPU tensors."""
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_block_v2 takes [T, C] tokens, got {tuple(x.shape)}")
    F = w1_q.shape[1]
    f_chunk = f_chunk or default_f_chunk(F)
    if F % f_chunk:
        raise ValueError(f"fused_mlp_block_v2: F {F} is not a multiple of f_chunk {f_chunk}")
    args = (x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk)
    if x.device.type == "cpu":
        return fused_mlp_block_v2_plain(*args)
    return _mlp_block_v2_cuda(*args)[0]
