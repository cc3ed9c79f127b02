"""Attention: the plain reference path, the flash kernels and the
dispatcher (counterpart of `ullava_tpu/ops/attention.py`).

Serving runs the flash forward K2 (`flash_attention_fwd_bsh`). Under
autograd `attention(impl="flash")` is the Function `_FlashAttention`, the
counterpart of the JAX custom VJP `_flash_attention`: its forward is K15
(`flash_attention_fwd`, which also returns each row's logsumexp) and its
backward (`flash_attention_bwd`): a pre-pass (delta, the fp32 dq
accumulator zeroed), K16 (one fused pass: dk, dv, dq's parts into the
accumulator) and K17 (dq from it). All of them read q, k, v in
the port's [B, S, H, hd] layout; the JAX training rules transpose to
[B, H, S, hd] first, a TPU layout matter that changes no value.
"""

from __future__ import annotations

from typing import Optional

import torch

from ullava_tpu_torch import kernels

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _scores(q, k, *, causal, kv_lens, bias, q_offset, scale):
    """fp32 scores [B, H, Sq, Sk] (GQA heads repeated) and the boolean
    mask of live keys (None when nothing is masked)."""
    sq, h = q.shape[1], q.shape[2]
    sk = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        mask = (torch.arange(sk, device=q.device)[None, :] <= q_pos)[None, None]
    if kv_lens is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_lens[:, None]
        valid = valid[:, None, None, :]
        mask = valid if mask is None else mask & valid
    return scores, mask


def attention_xla(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,  # [B] valid KV length per row
    bias: Optional[torch.Tensor] = None,  # [B, 1|H, Sq, Sk] additive
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention: fp32 scores and softmax, probabilities cast to
    q.dtype for the value product (the decode-step attention too)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores, mask = _scores(q, k, causal=causal, kv_lens=kv_lens, bias=bias,
                           q_offset=q_offset, scale=scale)
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, _repeat_kv(v, q.shape[2] // v.shape[2]))


def flash_attention_fwd_plain(
    q, k, v, kv_lens, *, causal: bool, scale: float, q_offset: int = 0
):
    """Plain version of the flash kernels' forward: (o [B, Sq, H, hd],
    lse [B, H, Sq] fp32). It differs from `attention_xla` where the
    kernels do, to match them to a few ulps: the unnormalised
    probabilities are rounded to v.dtype for the value product and
    normalised after it, and a row with no live key gives zeros (not the
    mean of v) and lse = 1e30 (`ullava_tpu/ops/attention.py:162-170`)."""
    s, mask = _scores(q, k, causal=causal, kv_lens=kv_lens, bias=None,
                      q_offset=q_offset, scale=scale)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    v = _repeat_kv(v, q.shape[2] // v.shape[2])
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, 1e30), m + torch.log(safe_l))
    return (o / safe_l).transpose(1, 2).to(q.dtype), lse[..., 0]


def flash_attention_fwd_bsh_plain(
    q, k, v, kv_lens, *, causal: bool, scale: float, q_offset: int = 0
) -> torch.Tensor:
    """Plain version of K2: the output of `flash_attention_fwd_plain`."""
    return flash_attention_fwd_plain(
        q, k, v, kv_lens, causal=causal, scale=scale, q_offset=q_offset)[0]


def _check_flash_shapes(q, k, v) -> None:
    B, Sq, H, hd = q.shape
    if k.shape[2] == 0 or H % k.shape[2] or v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")


def flash_attention_fwd_bsh(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, Hkv, hd]
    v: torch.Tensor,
    kv_lens: torch.Tensor,  # [B] int32
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention forward over row-major [B, S, H, hd] layouts with
    causal, `q_offset` and per-batch `kv_lens` masking and GQA; returns
    [B, Sq, H, hd]. CUDA kernel `kernels/csrc/flash_attention.cu` (hd 128,
    and hd 64 through its own entry; bf16) for CUDA tensors, the plain
    version for CPU tensors."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_flash_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_bsh_plain(
            q, k, v, kv_lens, causal=causal, scale=scale, q_offset=q_offset
        )
    _check_cuda_operands("flash_attention_fwd_bsh", B, hd, (64, 128), q=q, k=k, v=v,
                         kv_lens=kv_lens)
    out = torch.empty_like(q)
    kernels.launch(
        "flash_attention_fwd_bsh_hd64" if hd == 64 else "flash_attention_fwd_bsh",
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, int(causal),
        int(q_offset), float(scale),
    )
    return out


def _check_cuda_operands(name: str, B: int, hd: int, head_dims=(128,), **tensors) -> None:
    if hd not in head_dims:
        raise ValueError(f"{name}: the CUDA kernel is built for head_dim {head_dims}, got {hd}")
    for key, t in tensors.items():
        if key == "kv_lens":
            kernels.check_cuda_tensor(f"{name} kv_lens", t, torch.int32, (B,))
        elif key == "lse":
            kernels.check_cuda_tensor(f"{name} {key}", t, torch.float32)
        else:
            kernels.check_cuda_tensor(f"{name} {key}", t, torch.bfloat16)


def flash_attention_fwd(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, Hkv, hd]
    v: torch.Tensor,
    kv_lens: torch.Tensor,  # [B] int32
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
):
    """The training forward: (o [B, Sq, H, hd], lse [B, H, Sq] fp32), lse
    the logsumexp of each row's scaled, masked scores (1e30 where no key
    is live). CUDA kernel K15 (`kernels/csrc/flash_fwd_sm90.cu`: wgmma and
    TMA, hd 128, bf16) for CUDA tensors, the plain version for CPU
    tensors."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_flash_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, kv_lens, causal=causal, scale=scale, q_offset=q_offset)
    _check_cuda_operands("flash_attention_fwd", B, hd, q=q, k=k, v=v, kv_lens=kv_lens)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kernels.launch(
        "flash_attention_fwd_lse", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, Hkv,
        int(causal), int(q_offset), float(scale),
    )
    return out, lse


def flash_bwd_delta_plain(out, do):
    """Plain version of the backward's pre-pass: delta = rowsum(do * out)
    in fp32, [B, H, Sq] (the kernel also zeroes the dq accumulator)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), out.float())


def flash_attention_bwd_plain(
    q, k, v, out, lse, do, kv_lens, *, causal: bool, scale: float, q_offset: int = 0
):
    """Plain version of `flash_attention_bwd`, in the arithmetic of the TPU
    kernels (`ullava_tpu/ops/attention.py:457-573`): p = exp(s*scale - lse)
    recomputed under the forward's exact mask; dv = p^T dO with p rounded
    to dO's dtype; ds = p * (dO v^T - delta) * scale rounded to the input
    dtype before its products; dk = ds^T q, dq = ds k."""
    dt = q.dtype
    s, mask = _scores(q, k, causal=causal, kv_lens=kv_lens, bias=None,
                      q_offset=q_offset, scale=scale)
    delta = flash_bwd_delta_plain(out, do)
    p = torch.exp(s.masked_fill(~mask, _NEG_INF) - lse[..., None]).masked_fill(~mask, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd(
    q, k, v, out, lse, do, kv_lens, *, causal: bool, scale: float, q_offset: int = 0
):
    """(dq, dk, dv) of the flash forward for the output gradient `do`, all
    [B, S, H, hd]; `out` and `lse` are what `flash_attention_fwd` returned.
    For CUDA tensors the three launches of
    `kernels/csrc/flash_attention_bwd.cu` (hd 128, bf16, H == Hkv): a
    pre-pass, delta = rowsum(do * out) in fp32 from the rounded output (the
    JAX package leaves it to XLA) with an fp32 dq accumulator zeroed; K16,
    one `wgmma` + TMA pass over 128-key tiles that writes dk and dv and
    adds each tile's dS K into the accumulator by TMA reduce-adds; K17,
    dq = bf16(accumulator). dk and dv are bit-identical between calls on
    the same inputs; dq's fp32 sums arrive in an order that changes from
    call to call, so dq may move by about one bf16 ulp. The plain version
    for CPU tensors."""
    B, Sq, H, hd = q.shape
    _check_flash_shapes(q, k, v)
    if k.shape[2] != H:
        raise ValueError("the flash backward takes no GQA repeat (H == Hkv)")
    if out.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"bad shapes out {tuple(out.shape)} do {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, out, lse, do, kv_lens, causal=causal, scale=scale, q_offset=q_offset)
    return _flash_bwd_cuda(q, k, v, out, do, lse, kv_lens, causal, scale, q_offset)


def _flash_bwd_cuda(q, k, v, out, do, lse, kv_lens, causal, scale, q_offset):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    _check_cuda_operands("flash_attention_bwd", B, hd, q=q, k=k, v=v, out=out, do=do, lse=lse,
                         kv_lens=kv_lens)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kernels.launch("flash_attention_bwd_delta", do.data_ptr(), out.data_ptr(), delta.data_ptr(),
                   dq_acc.data_ptr(), Sq, H, B * Sq * H)
    kernels.launch("flash_attention_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(), kv_lens.data_ptr(),
                   dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H,
                   int(causal), int(q_offset), float(scale))
    kernels.launch("flash_attention_bwd_dq", dq_acc.data_ptr(), dq.data_ptr(), dq.numel() // 8)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd (the JAX custom VJP
    `_flash_attention`, `ullava_tpu/ops/attention.py:658-694`): K15
    forward; the backward `flash_attention_bwd`: its pre-pass (delta),
    K16 (the fused pass over key tiles), then K17 (dq from its fp32
    accumulator). Saves q, k, v, the output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, scale, q_offset):
        out, lse = flash_attention_fwd(q, k, v, kv_lens, causal=causal, scale=scale,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        causal, scale, q_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), kv_lens,
                                         causal=causal, scale=scale, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    impl: str = "flash",
) -> torch.Tensor:
    """Dispatching entry: 'xla' is the plain reference path, 'flash' the
    flash kernels (no additive bias, static q_offset): K2 where autograd
    does not record the call, else `_FlashAttention` (K15 forward, K16 and
    K17 backward; no GQA repeat). 'auto' (the JAX default) is 'flash' on
    CUDA tensors, where the flash entry raises what it cannot take, and the
    plain path on CPU tensors, as the JAX package off the TPU. The JAX
    package's further flash conditions (Sq >= 128, head_dim % 128 == 0, no
    GQA repeat, and Sq >= 512 as a TPU v5e crossover) are its kernel's and
    its chip's; on the H100 flash is the faster route at every
    length measured (`microbench/attention_crossover.py`)."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "xla"
    if impl == "xla":
        return attention_xla(
            q, k, v, causal=causal, kv_lens=kv_lens, bias=bias,
            q_offset=q_offset, scale=scale,
        )
    if impl == "flash":
        if bias is not None or not isinstance(q_offset, int):
            raise ValueError("flash attention takes no bias and a static q_offset")
        if kv_lens is None:
            kv_lens = torch.full((b,), k.shape[1], dtype=torch.int32, device=q.device)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            if k.shape[2] != h:
                raise ValueError("flash attention under autograd takes no GQA repeat")
            return _FlashAttention.apply(q, k, v, kv_lens.to(torch.int32), causal, scale,
                                         q_offset)
        return flash_attention_fwd_bsh(
            q, k, v, kv_lens.to(torch.int32), causal=causal, scale=scale,
            q_offset=q_offset,
        )
    raise ValueError(f"unknown attention impl: {impl}")
