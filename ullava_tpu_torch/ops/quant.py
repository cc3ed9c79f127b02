"""Int8 weights and W8A8 linears (counterpart of
`ullava_tpu/ops/quant.py:27-150`).

A quantized weight is a `{"q": int8 [in, out], "scale": f32 [1, out]}`
leaf; `apply_linear(x, w)` takes either that or a plain tensor, so model
code does not care which it holds. `q` is stored column-major (its `in`
axis has stride 1; the logical shape stays `[in, out]`): the layout the
card's int8 product is fast on, laid out once when the leaf is made.

The int8 x int8 -> int32 product lies outside every kernel of the JAX
package (a plain `dot_general`), so here it is the library's
`torch._int_mm`. The TPU's sublane flattening rule is a layout matter of
its compiler and is not carried over: leading dims are always merged.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch

QuantLeaf = Dict[str, torch.Tensor]
MaybeQuant = Union[torch.Tensor, QuantLeaf]

LLAMA_QUANT_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
)
SAM_ENCODER_QUANT_KEYS = ("qkv", "proj", "fc1", "fc2", "patch_proj")
CLIP_QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2", "patch_proj")


def column_major(q: torch.Tensor) -> torch.Tensor:
    """`q` [..., in, out] with the same shape and values, stored with
    stride 1 along `in` (a copy unless it is stored so already)."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_int8(w: torch.Tensor) -> QuantLeaf:
    """Symmetric per-output-channel int8: the abs-max is taken over the
    contraction axis (-2) only; `torch.round` rounds half to even."""
    wf = w.float()
    scale = (wf.abs().amax(-2, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": column_major(q), "scale": scale}


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def dequantize(leaf: MaybeQuant, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if is_quantized(leaf):
        return (leaf["q"].float() * leaf["scale"]).to(dtype)
    return leaf


def apply_linear(x: torch.Tensor, w: MaybeQuant) -> torch.Tensor:
    """x @ w; an int8 weight is converted to x's dtype for the product and
    its scale is folded in after it (weight-only int8)."""
    if not is_quantized(w):
        return x @ w
    y = x @ w["q"].to(x.dtype)
    return (y.float() * w["scale"].reshape(-1)).to(x.dtype)


# Rows the card's library int8 product is handed at least: it refuses 16
# rows or fewer, so fewer rows are padded with zero rows to this count.
INT8_MM_MIN_ROWS = 32


def int8_matmul_padded(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm(xq, wq)` of `xq` padded with zero rows to
    `INT8_MM_MIN_ROWS` (when it has fewer), sliced back to xq's rows: the
    same int32 sums, since every output row depends on its own input row
    only."""
    M = xq.shape[0]
    if M >= INT8_MM_MIN_ROWS:
        return torch._int_mm(xq, wq)
    pad = xq.new_zeros((INT8_MM_MIN_ROWS - M, xq.shape[1]))
    return torch._int_mm(torch.cat([xq, pad]), wq)[:M]


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, any M. On the card the
    library product takes K, N multiples of 8 (other shapes raise) and M >
    16, so 16 rows or fewer (a one-sample prompt of a few tokens under W8A8
    prefill) go through `int8_matmul_padded`. It is several times faster
    there on a column-major second operand, which is how `quantize_int8`
    and the bridge store `q`."""
    if xq.device.type == "cuda":
        M, K = xq.shape
        N = wq.shape[1]
        if K % 8 or N % 8:
            raise ValueError(f"int8 product on CUDA needs K, N multiples of 8, got {M}x{K}x{N}")
        if M <= 16:
            return int8_matmul_padded(xq, wq)
    return torch._int_mm(xq, wq)


def apply_linear_a8_prequant(
    xq: torch.Tensor,  # [rows, K] int8 activations quantized elsewhere
    amax: torch.Tensor,  # [rows, 1] f32 raw per-row abs-max
    w: QuantLeaf,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The product and rescale of `apply_linear_a8` for activations that
    are already int8 (from `rms_norm_residual_quant` or `silu_mul_quant`)."""
    y = int8_matmul(xq, w["q"])
    y = y.float() * (amax * (1.0 / 127.0)) * w["scale"].reshape(1, -1)
    return y.to(out_dtype)


def apply_linear_a8(x: torch.Tensor, w: QuantLeaf) -> torch.Tensor:
    """W8A8 linear: per-row dynamic int8 activations (abs-max floored at
    1e-12, round half to even), an int8 product, then the rescale by the
    row's `amax / 127` and the weight's per-channel scale."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    # A true division: `127.0 / amax` on a tensor is reciprocal-then-multiply.
    xq = torch.round(xf * (torch.full_like(amax, 127.0) / amax)).to(torch.int8)
    y = apply_linear_a8_prequant(xq, amax, w, x.dtype)
    return y.reshape(*lead, y.shape[-1])


def quantize_tree(params: Any, key_names: Sequence[str]) -> Any:
    """A copy of `params` with every >= 2-D tensor under a dict key in
    `key_names` replaced by its int8 leaf; other leaves are shared."""
    names = set(key_names)

    def rec(node):
        if isinstance(node, dict):
            return {
                k: quantize_int8(v)
                if k in names and isinstance(v, torch.Tensor) and v.ndim >= 2
                else rec(v)
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [rec(v) for v in node]
        return node

    return rec(params)
