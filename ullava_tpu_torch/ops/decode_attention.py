"""The int8 KV cache: row quantization, the prefill's quantize-and-write,
the decode step's write-and-attend, and decode attention over the cache
that writes nothing (counterpart of `ullava_tpu/ops/decode_attention.py`).

The cache is a stacked `[L, B, maxS, Hkv*hd]` int8 pair (heads merged on
the minor dim) with `[L, B, maxS, Hkv]` f32 scales, one per (position,
kv head). Both kernels take the whole stacked cache and a layer index
and update it IN PLACE (the JAX versions alias their outputs onto the
donated cache); the wrappers return the same tensors. `decode_attention_int8`
only reads it.

Exactness: a key row's scale is constant over the contraction, so it
folds into the score after the dot, and a value row's scale folds into
its probability; attention over the int8 cache equals attention over the
dequantized cache up to fp32 summation order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.ops.attention import attention_xla


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 [..., hd], f32 scale [...]), per-row symmetric:
    scale = max(amax, 1e-12) / 127, rows divided, rounded half to even and
    clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _check_cache(name, cache_k, cache_v, k_scale, v_scale, B, Hkv, hd):
    L, Bc, maxS, Ckv = cache_k.shape
    if Bc != B or Ckv != Hkv * hd:
        raise ValueError(f"{name}: cache {tuple(cache_k.shape)} does not fit B={B}, Hkv*hd={Hkv * hd}")
    for label, t, dtype, shape in (
        ("cache_k", cache_k, torch.int8, (L, B, maxS, Ckv)),
        ("cache_v", cache_v, torch.int8, (L, B, maxS, Ckv)),
        ("k_scale", k_scale, torch.float32, (L, B, maxS, Hkv)),
        ("v_scale", v_scale, torch.float32, (L, B, maxS, Hkv)),
    ):
        kernels.check_cuda_tensor(f"{name} {label}", t, dtype, shape)
    return L, maxS


def prefill_quantize_write_plain(k, v, cache_k, cache_v, k_scale, v_scale, layer_idx: int):
    """Plain version of `prefill_quantize_write`: `quantize_kv_rows`, then
    a slice assignment into positions [0, S) of layer `layer_idx`."""
    B, S, Hkv, hd = k.shape
    for x, cache, scales in ((k, cache_k, k_scale), (v, cache_v, v_scale)):
        q, s = quantize_kv_rows(x)
        cache[layer_idx, :, :S] = q.reshape(B, S, Hkv * hd)
        scales[layer_idx, :, :S] = s
    return cache_k, cache_v, k_scale, v_scale


def prefill_quantize_write(
    k: torch.Tensor,  # [B, S, Hkv, hd] post-rope keys (compute dtype)
    v: torch.Tensor,  # [B, S, Hkv, hd]
    cache_k: torch.Tensor,  # [L, B, maxS, Hkv*hd] int8, updated in place
    cache_v: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, maxS, Hkv] f32, updated in place
    v_scale: torch.Tensor,
    layer_idx: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize a prefill's K/V rows (the `quantize_kv_rows` recipe) and
    write positions [0, S) of one layer of the stacked cache in one pass;
    rows [S, maxS) and the other layers are not touched. CUDA kernel
    `kernels/csrc/kv_quant_write.cu` (bf16 rows) for CUDA tensors, the
    plain version for CPU tensors."""
    B, S, Hkv, hd = k.shape
    if v.shape != k.shape or S > cache_k.shape[2] or not 0 <= layer_idx < cache_k.shape[0]:
        raise ValueError(
            f"bad shapes k {tuple(k.shape)} v {tuple(v.shape)} cache {tuple(cache_k.shape)} "
            f"layer {layer_idx}"
        )
    if k.device.type == "cpu":
        return prefill_quantize_write_plain(k, v, cache_k, cache_v, k_scale, v_scale, layer_idx)
    if hd % 4 or hd > 256:
        raise ValueError(f"prefill_quantize_write: head_dim {hd} must be a multiple of 4, at most 256")
    kernels.check_cuda_tensor("prefill_quantize_write k", k, torch.bfloat16)
    kernels.check_cuda_tensor("prefill_quantize_write v", v, torch.bfloat16)
    _, maxS = _check_cache("prefill_quantize_write", cache_k, cache_v, k_scale, v_scale, B, Hkv, hd)
    kernels.launch(
        "prefill_quantize_write", kernels.ptr(k), kernels.ptr(v), kernels.ptr(cache_k),
        kernels.ptr(cache_v), kernels.ptr(k_scale), kernels.ptr(v_scale), B, S, Hkv, hd, maxS,
        int(layer_idx),
    )
    return cache_k, cache_v, k_scale, v_scale


def kv_quant_division_check() -> Tuple[int, int, int]:
    """On the card: the division of `kernels/csrc/kv_quant_write.cu` (from
    one reciprocal a head) against IEEE division over every bf16 x and
    bf16 abs-max with |x| <= amax, both signs. Returns (pairs whose int8
    codes differ, pairs whose quotients' bits differ, pairs seen)."""
    counts = torch.zeros(3, dtype=torch.int64, device="cuda")
    kernels.run_check("kv_quant_write.cu", "ullava_kv_quant_division_check", kernels.ptr(counts))
    codes, quotients, seen = counts.tolist()
    return codes, quotients, seen


def decode_attention_int8_xla(
    q: torch.Tensor,  # [B, 1, H, hd]
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    kv_lens: torch.Tensor,  # [B]
    layer_idx: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Dequantize one layer of the cache into q's dtype and run the plain
    attention over it: the yardstick of the fused kernel."""
    B, _, _, hd = q.shape
    maxS, Hkv = cache_k.shape[2], k_scale.shape[-1]
    k = (cache_k[layer_idx].reshape(B, maxS, Hkv, hd).float() * k_scale[layer_idx][..., None]).to(q.dtype)
    v = (cache_v[layer_idx].reshape(B, maxS, Hkv, hd).float() * v_scale[layer_idx][..., None]).to(q.dtype)
    return attention_xla(q, k, v, causal=False, kv_lens=kv_lens, scale=scale)


# The masked score of the TPU kernel (-0.7 * the largest fp32).
_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def decode_attention_int8_plain(
    q, cache_k, cache_v, k_scale, v_scale, kv_lens, layer_idx: int, *, scale: float
) -> torch.Tensor:
    """Plain version of `decode_attention_int8`, in the TPU kernel's
    arithmetic (`ullava_tpu/ops/decode_attention.py:46-140`): fp32 dots of
    q with the int8 key rows, times `k_scale * scale`; positions at or past
    `kv_lens[b]` score -0.7 * the fp32 maximum; an exact softmax over all
    maxS positions, normalized before the product with the value scale is
    rounded to q's dtype; the fp32 sum over the int8 value rows, rounded
    to q's dtype. GQA: kv head g serves q heads [g*rep, (g+1)*rep)."""
    B, _, H, hd = q.shape
    maxS, Hkv = cache_k.shape[2], k_scale.shape[-1]
    rep = H // Hkv
    k = cache_k[layer_idx].reshape(B, maxS, Hkv, hd).float()
    v = cache_v[layer_idx].reshape(B, maxS, Hkv, hd).float()
    ks, vs = k_scale[layer_idx].float(), v_scale[layer_idx].float()  # [B, maxS, Hkv]
    qf = q[:, 0].float().reshape(B, Hkv, rep, hd)
    sc = torch.einsum("bgrd,bsgd->bsgr", qf, k) * (ks * scale)[..., None]
    live = torch.arange(maxS, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
    sc = torch.where(live[:, :, None, None], sc, torch.full_like(sc, _NEG_INF))
    p = torch.exp(sc - sc.amax(1, keepdim=True))
    p = p / p.sum(1, keepdim=True)
    pv = (p * vs[..., None]).to(q.dtype).float()
    o = torch.einsum("bsgr,bsgd->bgrd", pv, v)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_int8(
    q: torch.Tensor,  # [B, 1, H, hd]
    cache_k: torch.Tensor,  # [L, B, maxS, Hkv*hd] int8
    cache_v: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, maxS, Hkv] f32
    v_scale: torch.Tensor,
    kv_lens: torch.Tensor,  # [B] int32
    layer_idx: int,
    *,
    scale: float,
    block_b: int = 2,
) -> torch.Tensor:
    """Single-token decode attention over rows [0, kv_lens[b]) of one layer
    of the stacked int8 cache, which it only reads; returns [B, 1, H, hd]
    in q's dtype. `block_b` is TPU tiling: accepted and ignored. `kv_lens`
    is read on the device. CUDA kernel `kernels/csrc/decode_attention_int8.cu`
    (its read-only entry; bf16 q) for CUDA tensors, the plain version for
    CPU ones."""
    B, S1, H, hd = q.shape
    Hkv = k_scale.shape[-1]
    if S1 != 1 or H % Hkv or cache_k.shape[-1] != Hkv * hd or kv_lens.shape != (B,):
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache {tuple(cache_k.shape)} "
                         f"scales {tuple(k_scale.shape)} kv_lens {tuple(kv_lens.shape)}")
    if not 0 <= layer_idx < cache_k.shape[0]:
        raise ValueError(f"layer {layer_idx} outside the cache's {cache_k.shape[0]} layers")
    if q.device.type == "cpu":
        return decode_attention_int8_plain(
            q, cache_k, cache_v, k_scale, v_scale, kv_lens, layer_idx, scale=scale)
    return _decode_read_cuda(q, cache_k, cache_v, k_scale, v_scale, kv_lens, layer_idx, scale)


# The read kernel's blocks a (sample, head) form one thread block cluster:
# at most the portable 8. Each parks 8 bytes a row of its share of the
# cache in shared memory, at most 200 KB.
_READ_MAX_SPLITS, _READ_ROW_BYTES, _READ_SMEM_MAX = 8, 8, 200 * 1024
_READ_LOADS = 4  # row loads a lane issues at once (`dec::kLoads`)


def read_rows(maxS: int, hd: int, splits: int) -> int:
    """The rows a block of the read kernel parks for a cache of maxS rows
    split `splits` ways: whole warp tiles of (32 / (hd / 16)) * 4 rows."""
    tile = 32 // (hd // 16) * _READ_LOADS
    per = -(-maxS // splits)
    return -(-per // tile) * tile


def decode_read_splits(B: int, H: int, maxS: int, hd: int, sms: int) -> int:
    """How many blocks (one cluster) share a (sample, head)'s rows in the
    read kernel: as `fused_write_splits` chooses, at most 8, and at least
    what the rows a block can park need."""
    splits = min(fused_write_splits(B, H, maxS, sms), _READ_MAX_SPLITS)
    while splits < _READ_MAX_SPLITS and read_rows(maxS, hd, splits) * _READ_ROW_BYTES > _READ_SMEM_MAX:
        splits += 1
    return splits


def _decode_read_cuda(q, cache_k, cache_v, k_scale, v_scale, kv_lens, layer_idx: int,
                      scale: float, splits: Optional[int] = None) -> torch.Tensor:
    """The CUDA `decode_attention_int8`. `splits` sets how many blocks share
    a (sample, head)'s rows (None: `decode_read_splits`; the function does
    not depend on it), so that a test or a measurement can run each form."""
    B, _, H, hd = q.shape
    Hkv = k_scale.shape[-1]
    name = "decode_attention_int8"
    lanes = hd // 16  # lanes of a warp that share one cache row
    if hd % 16 or lanes & (lanes - 1) or lanes > 32:
        raise ValueError(f"{name}: head_dim {hd} must be 16 * 2^n, at most 512")
    _, maxS = _check_cache(name, cache_k, cache_v, k_scale, v_scale, B, Hkv, hd)
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = decode_read_splits(B, H, maxS, hd, sms)
    if not 1 <= splits <= _READ_MAX_SPLITS:
        raise ValueError(f"{name}: splits {splits} must lie in 1..{_READ_MAX_SPLITS}")
    if read_rows(maxS, hd, splits) * _READ_ROW_BYTES > _READ_SMEM_MAX:
        raise ValueError(f"{name}: cache length {maxS} exceeds the shared memory of "
                         f"{splits} blocks a (sample, head)")
    kernels.check_cuda_tensor(f"{name} q", q, torch.bfloat16)
    lens = kv_lens.to(torch.int32).contiguous()
    kernels.check_cuda_tensor(f"{name} kv_lens", lens, torch.int32, (B,))
    out = torch.empty_like(q)
    kernels.launch(
        name, kernels.ptr(q), kernels.ptr(cache_k), kernels.ptr(cache_v), kernels.ptr(k_scale),
        kernels.ptr(v_scale), kernels.ptr(lens), kernels.ptr(out), B, H, Hkv, hd, maxS,
        int(layer_idx), float(scale), int(splits),
    )
    return out


def decode_attention_int8_fused_write_plain(
    q, kq_new, ks_new, vq_new, vs_new, cache_k, cache_v, k_scale, v_scale, write_pos,
    layer_idx: int, *, scale: float,
):
    """Plain version of the write-and-attend kernel: scatter the new rows
    at `write_pos`, then `decode_attention_int8_xla` over `write_pos + 1`
    rows."""
    b_idx = torch.arange(q.shape[0], device=q.device)
    wp = write_pos.long()
    cache_k[layer_idx, b_idx, wp] = kq_new
    cache_v[layer_idx, b_idx, wp] = vq_new
    k_scale[layer_idx, b_idx, wp] = ks_new
    v_scale[layer_idx, b_idx, wp] = vs_new
    attn = decode_attention_int8_xla(
        q, cache_k, cache_v, k_scale, v_scale, wp + 1, layer_idx, scale=scale
    )
    return attn, cache_k, cache_v, k_scale, v_scale


# The write-and-attend kernel's split of a sample's rows over blocks: at
# most four blocks an SM in all (its launch bound), at least 256 rows of a
# full cache a split, at most 32 splits.
_BLOCKS_PER_SM, _MIN_SPLIT_ROWS, _MAX_SPLITS = 4, 256, 32


def fused_write_splits(B: int, H: int, maxS: int, sms: int) -> int:
    """How many blocks share one (sample, head)'s cache rows: 1 where the
    B * H blocks fill the card's `sms` SMs four times over, more for small
    batches over long caches."""
    return max(1, min((_BLOCKS_PER_SM * sms) // max(B * H, 1), maxS // _MIN_SPLIT_ROWS,
                      _MAX_SPLITS))


def _fused_write_cuda(q, kq_new, ks_new, vq_new, vs_new, cache_k, cache_v, k_scale, v_scale,
                      write_pos, layer_idx: int, scale: float, splits: Optional[int] = None):
    """The CUDA `decode_attention_int8_fused_write`: its attention output.
    `splits` sets how many blocks share a (sample, head)'s rows (None:
    `fused_write_splits`; the function does not depend on it), so that a
    test or a measurement can run each form."""
    B, _, H, hd = q.shape
    Hkv = ks_new.shape[-1]
    name = "decode_attention_int8_fused_write"
    lanes = hd // 16  # lanes of a warp that share one cache row
    if hd % 16 or lanes & (lanes - 1) or lanes > 32:
        raise ValueError(f"{name}: head_dim {hd} must be 16 * 2^n, at most 512")
    _, maxS = _check_cache(name, cache_k, cache_v, k_scale, v_scale, B, Hkv, hd)
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = fused_write_splits(B, H, maxS, sms)
    if not 1 <= splits <= 65535:
        raise ValueError(f"{name}: splits {splits} must lie in 1..65535")
    kernels.check_cuda_tensor(f"{name} q", q, torch.bfloat16)
    kernels.check_cuda_tensor(f"{name} kq_new", kq_new, torch.int8)
    kernels.check_cuda_tensor(f"{name} vq_new", vq_new, torch.int8)
    kernels.check_cuda_tensor(f"{name} ks_new", ks_new, torch.float32, (B, Hkv))
    kernels.check_cuda_tensor(f"{name} vs_new", vs_new, torch.float32, (B, Hkv))
    wp = write_pos.to(torch.int32).contiguous()
    kernels.check_cuda_tensor(f"{name} write_pos", wp, torch.int32, (B,))
    out = torch.empty_like(q)
    part = counter = None
    if splits > 1:
        # Scratch of this call's own, on its stream: the partials, and the
        # counters by which the last block of a (sample, head) finds it is last.
        part = torch.empty((B, H, splits, 2 + hd), dtype=torch.float32, device=q.device)
        counter = torch.zeros((B, H), dtype=torch.int32, device=q.device)
    kernels.launch(
        name, kernels.ptr(q), kernels.ptr(kq_new), kernels.ptr(ks_new), kernels.ptr(vq_new),
        kernels.ptr(vs_new), kernels.ptr(cache_k), kernels.ptr(cache_v), kernels.ptr(k_scale),
        kernels.ptr(v_scale), kernels.ptr(wp), kernels.ptr(out),
        None if part is None else kernels.ptr(part), None if counter is None else kernels.ptr(counter),
        B, H, Hkv, hd, maxS, int(layer_idx), float(scale), int(splits),
    )
    return out


def decode_attention_int8_fused_write(
    q: torch.Tensor,  # [B, 1, H, hd]
    kq_new: torch.Tensor,  # [B, Hkv*hd] int8 quantized new key rows
    ks_new: torch.Tensor,  # [B, Hkv] f32
    vq_new: torch.Tensor,  # [B, Hkv*hd] int8
    vs_new: torch.Tensor,  # [B, Hkv] f32
    cache_k: torch.Tensor,  # [L, B, maxS, Hkv*hd] int8, updated in place
    cache_v: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, maxS, Hkv] f32, updated in place
    v_scale: torch.Tensor,
    write_pos: torch.Tensor,  # [B] the current token's cache position
    layer_idx: int,
    *,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention over rows [0, write_pos[b]) of the int8 cache
    plus the current token (scored from its quantized new row), with the
    new row and its scales written at `write_pos[b]` in the same pass.
    Rows at and after `write_pos[b]` are stale and masked. GQA: kv head g
    serves q heads [g*rep, (g+1)*rep). `write_pos` is read on the device.
    Returns (attn [B, 1, H, hd], cache_k, cache_v, k_scale, v_scale).
    CUDA kernel `kernels/csrc/decode_attention_int8.cu` (bf16 q; any cache
    length) for CUDA tensors, the plain version for CPU tensors."""
    B, S1, H, hd = q.shape
    Hkv = ks_new.shape[-1]
    if S1 != 1 or H % Hkv or kq_new.shape != (B, Hkv * hd) or vq_new.shape != kq_new.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} new rows {tuple(kq_new.shape)}")
    if not 0 <= layer_idx < cache_k.shape[0]:
        raise ValueError(f"layer {layer_idx} outside the cache's {cache_k.shape[0]} layers")
    if q.device.type == "cpu":
        return decode_attention_int8_fused_write_plain(
            q, kq_new, ks_new, vq_new, vs_new, cache_k, cache_v, k_scale, v_scale,
            write_pos, layer_idx, scale=scale,
        )
    out = _fused_write_cuda(q, kq_new, ks_new, vq_new, vs_new, cache_k, cache_v, k_scale, v_scale,
                            write_pos, layer_idx, scale)
    return out, cache_k, cache_v, k_scale, v_scale
