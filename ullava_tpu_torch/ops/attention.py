"""Attention: the plain reference path, the flash forward kernel, and the
dispatcher (counterpart of `ullava_tpu/ops/attention.py:38-76,354-449,
704-757`)."""

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


def flash_attention_fwd_bsh_plain(
    q, k, v, kv_lens, *, causal: bool, scale: float, q_offset: int = 0
) -> torch.Tensor:
    """Plain version of the flash kernel. It differs from `attention_xla`
    where the kernel does, to match it to a few ulps: the unnormalised
    probabilities are rounded to v.dtype for the value product and
    normalised after it, and a row with no live key gives zeros (not the
    mean of v)."""
    s, mask = _scores(q, k, causal=causal, kv_lens=kv_lens, bias=None,
                      q_offset=q_offset, scale=scale)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    v = _repeat_kv(v, q.shape[2] // v.shape[2])
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.transpose(1, 2).to(q.dtype)


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
    bf16) for CUDA tensors, the plain version for CPU tensors."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv or v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_fwd_bsh_plain(
            q, k, v, kv_lens, causal=causal, scale=scale, q_offset=q_offset
        )
    if hd != 128:
        raise ValueError(f"the CUDA flash kernel is built for head_dim 128, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda_tensor(f"flash_attention_fwd_bsh {name}", t, torch.bfloat16)
    kernels.check_cuda_tensor("flash_attention_fwd_bsh kv_lens", kv_lens, torch.int32, (B,))
    out = torch.empty_like(q)
    kernels.launch(
        "flash_attention_fwd_bsh", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, int(causal),
        int(q_offset), float(scale),
    )
    return out


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
    flash kernel (no additive bias, static q_offset)."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
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
        return flash_attention_fwd_bsh(
            q, k, v, kv_lens.to(torch.int32), causal=causal, scale=scale,
            q_offset=q_offset,
        )
    raise ValueError(f"unknown attention impl: {impl}")
