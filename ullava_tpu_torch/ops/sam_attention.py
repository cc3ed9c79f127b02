"""SAM windowed and global attention with the decomposed relative
position bias (counterpart of `ullava_tpu/ops/sam_attention.py`).

bias[(i,j),(a,b)] = q[(i,j)].Rh[i-a+W-1] + q[(i,j)].Rw[j-b+W-1] is never
materialised by the kernels: they take the compact terms A[(i,j), a] and
Bb[(i,j), b] and add A[s][t // W] + Bb[s][t % W] to q.k before the scale.
The kernels keep the TPU functions' bias conventions, which differ:
the window kernels (whole windows, and the boundary windows' real
rectangles) take A/Bb pre-scaled by 1/scale with reversed columns (as
`_bias_terms_rect` emits them), the global kernel takes them raw in
natural column order and pre-scales them itself, and the lane-sliced
global kernel (`fused_global_attention_y`) takes them pre-scaled in
natural column order, laid out [B, S, H, W]. The per-(window, head)
window kernel (`fused_window_attention`) takes them raw like the global
kernel. The packed kernels (`fused_window_attention_packed`,
`fused_global_attention_packed`) read q/k/v as the 128-lane blocks of a
head-major padded projection output and take the terms raw, [N, H, S, W],
added after the scale: s = q.k * scale + A + Bb. Both packed kernels
contract the `head_dim` real lanes of each block and write zeros to the
rest (the packed layout's pad lanes are zero, so the result is that of
all the lanes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.ops.mlp_kernel import _row_quant


def fused_window_attention_grid_plain(
    y, bias_a, bias_b, num_heads: int, head_dim: int, window: int, scale: float,
    dots_i8: bool = False,
) -> torch.Tensor:
    """Rows of y past window^2 (the padded layout) attend as queries and
    are left out as keys. With `dots_i8` the scores are those of the TPU
    kernel's int8 form (`ullava_tpu/ops/sam_attention.py:146-161`): q, k
    and each row's bias terms [A | B] quantized per row (`_row_quant`),
    s = (float(qk codes) * (qs * ks) + float(ca + cb) * abss) * scale,
    where the one-hot product of the TPU kernel is the sum of two codes."""
    N, S, _ = y.shape
    H, hd, W = num_heads, head_dim, window
    y5 = y.reshape(N, S, 3, H, hd)
    q, k, v = y5[:, :, 0], y5[:, : W * W, 1], y5[:, : W * W, 2]
    # Reversed columns: column a' holds the bias for key row W-1-a'.
    A = bias_a.reshape(N, S, H, W).flip(-1).float().permute(0, 2, 1, 3)
    Bb = bias_b.reshape(N, S, H, W).flip(-1).float().permute(0, 2, 1, 3)
    if dots_i8:
        qq, qs = _row_quant(q)  # [N, S, H, hd], [N, S, H, 1]
        kq, ks = _row_quant(k)
        abq, abss = _row_quant(torch.cat([A, Bb], dim=-1))  # [N, H, S, 2W], [N, H, S, 1]
        # Integer sums of at most 127 * 127 * hd: exact in fp32.
        s_qk = torch.einsum("nshd,nthd->nhst", qq.float(), kq.float()) * (
            qs.permute(0, 2, 1, 3) * ks.permute(0, 2, 3, 1))
        codes = abq.float()
        s_b = (codes[..., :W, None] + codes[..., None, W:]).reshape(N, H, S, W * W) * abss
        s = (s_qk + s_b) * scale
    else:
        bias = (A[..., :, None] + Bb[..., None, :]).reshape(N, H, S, W * W)
        s = (torch.einsum("nshd,nthd->nhst", q.float(), k.float()) + bias) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("nhst,nthd->nshd", p.float(), v.float())
    return o.to(y.dtype).reshape(N, S, H * hd)


def _check_window_kernel_shape(hd: int, W: int) -> None:
    if (hd, W) != (80, 14):
        raise ValueError(f"the CUDA window kernels are built for hd 80, W 14; got {hd}, {W}")


def _window_kernel(base: str, hd: int, W: int, dots_i8: bool) -> str:
    """The CUDA entry of window kernel `base` (K3 or K14) for a head dim,
    in both score forms: ViT-H's 80 (`<base>`, `<base>_i8`), ViT-L's and
    ViT-B's 64 (`<base>_hd64`, `<base>_i8_hd64`). Any other form raises
    ValueError: no SAM configuration reaches it."""
    if W != 14 or hd not in (64, 80):
        raise ValueError(f"the CUDA {base} kernel is built for W 14 and hd 80 or 64; "
                         f"got hd {hd}, W {W}")
    return base + ("_i8" if dots_i8 else "") + ("_hd64" if hd == 64 else "")


# The most rows a window can have in the CUDA window kernel (13 tiles of 16).
_WINDOW_MAX_ROWS = 208
# The (rows, cols) rectangles the CUDA boundary-window kernel is built for
# (ViT-H's right, bottom and corner classes), and the pairs it takes in one
# dual-geometry launch.
_RECT_GEOMETRIES = ((14, 8), (8, 14), (8, 8))
_RECT_DUAL_GEOMETRIES = (((14, 8), (8, 14)), ((8, 14), (14, 8)))


def fused_window_attention_grid(
    y: torch.Tensor,  # [N, S, 3*H*hd] qkv projection output (bias included)
    bias_a: torch.Tensor,  # [N, S, H*W] col a' = bias for key row W-1-a'
    bias_b: torch.Tensor,  # [N, S, H*W] col b' = bias for key col W-1-b'
    num_heads: int,
    head_dim: int,
    window: int,
    scale: float,
    total_rows: int = 0,
    dots_i8: bool = False,
) -> torch.Tensor:
    """Window attention straight from the raw qkv output; returns the
    head-merged [N, S, H*hd] pre-projection activations. Bias terms are
    pre-scaled by 1/scale. With `total_rows` > window^2 (the padded
    layout) every window is stored as S = `total_rows` rows: the tail rows
    are left out as keys, and as queries they give finite rows that the
    caller drops. `dots_i8` takes the int8 score form. CUDA kernel
    `kernels/csrc/sam_window_attention.cu` (W 14, hd 80 or 64, at most 208
    rows a window, bf16; its `_i8` entries for `dots_i8`, its `_hd64`
    entries for hd 64) for CUDA tensors, the plain version for CPU ones."""
    N, S, width = y.shape
    H, hd, W = num_heads, head_dim, window
    if S != (total_rows or W * W) or S < W * W or width != 3 * H * hd:
        raise ValueError(
            f"y {tuple(y.shape)} does not match H={H} hd={hd} W={W} total_rows={total_rows}"
        )
    if bias_a.shape != (N, S, H * W) or bias_b.shape != (N, S, H * W):
        raise ValueError(f"bias terms must be [{N}, {S}, {H * W}]")
    if y.device.type == "cpu":
        return fused_window_attention_grid_plain(y, bias_a, bias_b, H, hd, W, scale, dots_i8)
    entry = _window_kernel("fused_window_attention_grid", hd, W, dots_i8)
    if S > _WINDOW_MAX_ROWS:
        raise ValueError(f"the CUDA window kernel holds at most {_WINDOW_MAX_ROWS} rows, got {S}")
    kernels.check_cuda_tensor("window y", y, torch.bfloat16)
    kernels.check_cuda_tensor("window bias_a", bias_a, torch.bfloat16)
    kernels.check_cuda_tensor("window bias_b", bias_b, torch.bfloat16)
    out = torch.empty((N, S, H * hd), dtype=y.dtype, device=y.device)
    kernels.launch(
        entry, kernels.ptr(y), kernels.ptr(bias_a),
        kernels.ptr(bias_b), kernels.ptr(out), N, H, S, float(scale),
    )
    return out


def _rect_plain_one(y, bias_a, bias_b, oh, pad_k, pad_v, H, hd, W, scale, dots_i8):
    """One geometry of `fused_window_attention_rect_plain`, in the TPU
    kernel's own arithmetic: the T real keys, then the P pad keys from the
    table, one softmax over both, the real keys' weights rounded to v's
    dtype for the value product and the pad keys' summed unrounded into a
    rank-1 `pad_mass * pad_v` term."""
    N, T, _ = y.shape
    y5 = y.reshape(N, T, 3, H, hd)
    q, k, v = y5[:, :, 0], y5[:, :, 1], y5[:, :, 2]
    A, Bb = bias_a.reshape(N, T, H, W), bias_b.reshape(N, T, H, W)
    ab = torch.cat([A, Bb], dim=-1)  # [N, T, H, 2W]
    qa = torch.cat([q, ab], dim=-1).float()
    s_pad = torch.einsum("nshd,hpd->nhsp", qa, pad_k.float())
    if dots_i8:
        # int8 scores over the real keys only; the pad table stays as it is.
        qq, qs = _row_quant(q)
        kq, ks = _row_quant(k)
        abq, abss = _row_quant(ab)
        s_real = torch.einsum("nshd,nthd->nhst", qq.float(), kq.float()) * (
            qs.permute(0, 2, 1, 3) * ks.permute(0, 2, 3, 1))
        s_real = s_real + torch.einsum("nshw,tw->nhst", abq.float(), oh.float()) * abss.permute(
            0, 2, 1, 3)
    else:
        ka = torch.cat([k, oh[None, :, None, :].expand(N, T, H, 2 * W)], dim=-1).float()
        s_real = torch.einsum("nshd,nthd->nhst", qa, ka)
    p = torch.softmax(torch.cat([s_real, s_pad], dim=-1) * scale, dim=-1)
    o = torch.einsum("nhst,nthd->nshd", p[..., :T].to(v.dtype).float(), v.float())
    pad_mass = p[..., T:].sum(-1).permute(0, 2, 1)  # [N, T, H]
    o = o + pad_mass[..., None] * pad_v.float()[None, None]
    return o.to(y.dtype).reshape(N, T, H * hd)


def fused_window_attention_rect_plain(
    y, bias_a, bias_b, oh, pad_k, pad_v, num_heads: int, head_dim: int, window: int,
    scale: float, dots_i8: bool = False,
) -> torch.Tensor:
    args = (num_heads, head_dim, window, scale, dots_i8)
    if oh.ndim == 2:
        return _rect_plain_one(y, bias_a, bias_b, oh, pad_k, pad_v, *args)
    per = y.shape[0] // oh.shape[0]
    return torch.cat([
        _rect_plain_one(y[i * per:(i + 1) * per], bias_a[i * per:(i + 1) * per],
                        bias_b[i * per:(i + 1) * per], oh[i], pad_k[i], pad_v[i], *args)
        for i in range(oh.shape[0])
    ])


def _geometry_of_onehot(oh: torch.Tensor, W: int) -> Tuple[int, int]:
    """(rows, cols) of the real rectangle a [T, 2W] reversed-column one-hot
    table describes (row-major tokens)."""
    T = oh.shape[0]
    cols = int(W - 1 - oh[T - 1, W:].argmax()) + 1
    return T // cols, cols


def fused_window_attention_rect(
    y: torch.Tensor,  # [N, T, 3*H*hd] qkv output of the T = rows*cols real tokens
    bias_a: torch.Tensor,  # [N, T, H*W] pre-scaled by 1/scale, reversed columns
    bias_b: torch.Tensor,
    oh: torch.Tensor,  # [T, 2W] the real tokens' one-hots (reversed columns)
    pad_k: torch.Tensor,  # [H, P, hd+2W] pad keys: [qkv_bias k-section | one-hots]
    pad_v: torch.Tensor,  # [H, hd] the pad value (qkv_bias v-section)
    num_heads: int,
    head_dim: int,
    window: int,
    scale: float,
    dots_i8: bool = False,
    geometry: Optional[Tuple] = None,
) -> torch.Tensor:
    """Attention of boundary windows stored as their real rows x cols
    rectangle (row-major tokens), over all W x W key positions of the
    logical window: a pad position's key and value are the constants of
    the tables (the reference pads with zeros after LN1, so they are the
    qkv bias). Returns the head-merged [N, T, H*hd]. In dual-geometry mode
    `oh`, `pad_k` and `pad_v` carry a leading halves axis and window n
    takes the tables of half `n // (N / halves)`.

    `geometry` is (rows, cols), or one such pair per half: what the
    tables say, handed over so that the card's wrapper need not read it
    back from device memory. CUDA kernel `kernels/csrc/sam_rect_attention.cu`
    (W 14, hd 80 or 64, bf16; its `_i8` entries for `dots_i8`, its `_hd64`
    entries for hd 64) for CUDA tensors, which needs `geometry`,
    one of the boundary classes of a 64-token grid (14 x 8, 8 x 14, 8 x 8)
    or the two edges as a pair; the plain version for CPU ones, which checks
    it against `oh`."""
    N, T, width = y.shape
    H, hd, W = num_heads, head_dim, window
    halves = oh.shape[0] if oh.ndim == 3 else 0
    if width != 3 * H * hd or bias_a.shape != (N, T, H * W) or bias_b.shape != (N, T, H * W):
        raise ValueError(
            f"y {tuple(y.shape)} / bias {tuple(bias_a.shape)} do not match H={H} hd={hd} W={W}"
        )
    lead = (halves,) if halves else ()
    P = pad_k.shape[-2]
    if (oh.shape != (*lead, T, 2 * W) or pad_k.shape != (*lead, H, P, hd + 2 * W)
            or pad_v.shape != (*lead, H, hd) or T + P != W * W or (halves and N % halves)):
        raise ValueError(
            f"tables oh {tuple(oh.shape)}, pad_k {tuple(pad_k.shape)}, pad_v {tuple(pad_v.shape)} "
            f"do not match N={N} T={T} W={W}"
        )
    if geometry is not None:
        geoms = tuple(tuple(g) for g in geometry) if halves else (tuple(geometry),)
        if len(geoms) != max(halves, 1) or any(
            len(g) != 2 or g[0] * g[1] != T or not (0 < g[0] <= W and 0 < g[1] <= W) for g in geoms
        ):
            raise ValueError(f"geometry {geometry} does not match T={T}, W={W}, halves={halves}")
    if y.device.type == "cpu":
        if geometry is not None:
            seen = tuple(_geometry_of_onehot(t, W) for t in (oh if halves else oh[None]))
            if seen != geoms:
                raise ValueError(f"geometry {geoms} differs from the one-hot tables' {seen}")
        return fused_window_attention_rect_plain(
            y, bias_a, bias_b, oh, pad_k, pad_v, H, hd, W, scale, dots_i8
        )
    if geometry is None:
        raise ValueError("fused_window_attention_rect on the card needs `geometry`")
    entry = _window_kernel("fused_window_attention_rect", hd, W, dots_i8)
    if halves not in (0, 2):
        raise ValueError(f"the CUDA boundary-window kernel takes one or two geometries, got {halves}")
    built = _RECT_DUAL_GEOMETRIES if halves else tuple((g,) for g in _RECT_GEOMETRIES)
    if geoms not in built:
        raise ValueError(f"the CUDA boundary-window kernel is not built for geometry {geoms}")
    if (P * (hd + 2 * W)) % 8:
        raise ValueError(f"pad_k: a head's {P} x {hd + 2 * W} table must be a multiple of 16 bytes")
    for name, t in (("y", y), ("bias_a", bias_a), ("bias_b", bias_b), ("pad_k", pad_k),
                    ("pad_v", pad_v)):
        kernels.check_cuda_tensor(f"rect {name}", t, torch.bfloat16)
    first, second = geoms[0], geoms[-1]
    out = torch.empty((N, T, H * hd), dtype=y.dtype, device=y.device)
    kernels.launch(
        entry, kernels.ptr(y), kernels.ptr(bias_a), kernels.ptr(bias_b),
        kernels.ptr(pad_k), kernels.ptr(pad_v), kernels.ptr(out), N, H, T, P,
        N // halves if halves else N, first[0], first[1], second[0], second[1], float(scale),
    )
    return out


def _softmax_weights(s: torch.Tensor, exp_bf16: bool, dtype: torch.dtype):
    """(p, l) of one softmax over the last axis against the row's global
    maximum: the weights as they enter the product with v (rounded to
    `dtype`) and the fp32 denominator. With `exp_bf16` the exponent
    argument `s - m` and the weights are rounded to bf16 and the rounded
    weights are summed; the kernels round against a running maximum, so
    they agree with this to bf16 probability precision, not bit for bit."""
    d = s - s.amax(-1, keepdim=True)
    if exp_bf16:
        p = torch.exp(d.to(torch.bfloat16)).float()
        return p.to(dtype).float(), p.sum(-1, keepdim=True)
    p = torch.exp(d)
    return p.to(dtype).float(), p.sum(-1, keepdim=True)


def fused_global_attention_plain(
    q, k, v, bias_a, bias_b, window: int, scale: float, exp_bf16: bool = False
):
    N, S, hd = q.shape
    inv = 1.0 / scale
    a_s = (bias_a.float() * inv).to(q.dtype).float()
    b_s = (bias_b.float() * inv).to(q.dtype).float()
    out = torch.empty_like(q)
    chunk = max(1, (1 << 28) // (S * S))  # bound the [n, S, S] fp32 scores
    for n0 in range(0, N, chunk):
        sl = slice(n0, n0 + chunk)
        bias = (a_s[sl, :, :, None] + b_s[sl, :, None, :]).reshape(-1, S, S)
        s = (torch.einsum("nsd,ntd->nst", q[sl].float(), k[sl].float()) + bias) * scale
        p, l = _softmax_weights(s, exp_bf16, v.dtype)
        out[sl] = (torch.einsum("nst,ntd->nsd", p, v[sl].float()) / l).to(q.dtype)
    return out


def fused_global_attention(
    q: torch.Tensor,  # [N, S, hd], S = window^2
    k: torch.Tensor,
    v: torch.Tensor,
    bias_a: torch.Tensor,  # [N, S, W] raw, natural column order
    bias_b: torch.Tensor,
    window: int,
    scale: float,
    exp_bf16: bool = False,
) -> torch.Tensor:
    """Online-softmax global attention with the decomposed bias;
    `exp_bf16` takes the exponentials in bf16 (the serving form). CUDA
    kernel `kernels/csrc/sam_global_attention.cu` on the wgmma + TMA global
    core (W 64, hd 80 or, its `_hd64` entry, 64; bf16) for CUDA tensors,
    the plain version for CPU ones."""
    N, S, hd = q.shape
    W = window
    if S != W * W or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v {tuple(q.shape)} do not match window {W}")
    if bias_a.shape != (N, S, W) or bias_b.shape != (N, S, W):
        raise ValueError(f"bias terms must be [{N}, {S}, {W}]")
    if q.device.type == "cpu":
        return fused_global_attention_plain(q, k, v, bias_a, bias_b, W, scale, exp_bf16)
    if W != 64 or hd not in (64, 80):
        raise ValueError(f"the CUDA global kernel is built for hd 80 or 64, W 64; got {hd}, {W}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias_a", bias_a), ("bias_b", bias_b)):
        kernels.check_cuda_tensor(f"global {name}", t, torch.bfloat16)
    out = torch.empty_like(q)
    kernels.launch(
        "fused_global_attention_hd64" if hd == 64 else "fused_global_attention", kernels.ptr(q),
        kernels.ptr(k), kernels.ptr(v), kernels.ptr(bias_a), kernels.ptr(bias_b), kernels.ptr(out), N,
        float(scale), int(exp_bf16),
    )
    return out


def fused_global_attention_y_plain(
    y, bias_a, bias_b, num_heads: int, head_dim: int, window: int, scale: float,
    exp_bf16: bool = False, dots_i8: bool = False,
) -> torch.Tensor:
    """Plain version of `fused_global_attention_y`, one softmax over all
    S keys (`_softmax_weights`). With `dots_i8` q and k rows and the
    concatenated bias-term rows are quantized to int8 per row before the
    score."""
    B, S, _ = y.shape
    H, hd, W = num_heads, head_dim, window
    C = H * hd
    out = torch.empty((B, S, C), dtype=y.dtype, device=y.device)
    a_col = torch.arange(S, device=y.device) // W  # key t -> its grid row
    b_col = torch.arange(S, device=y.device) % W
    for b in range(B):
        for h in range(H):
            q, k, v = (y[b, :, sec * C + h * hd:sec * C + (h + 1) * hd] for sec in range(3))
            A, Bb = bias_a[b, :, h].float(), bias_b[b, :, h].float()
            if dots_i8:
                qq, qs = _row_quant(q)
                kq, ks = _row_quant(k)
                abq, abss = _row_quant(torch.cat([A, Bb], dim=-1))
                # Integer sums of at most 127 * 127 * hd: exact in fp32.
                s_qk = (qq.float() @ kq.float().T) * (qs * ks.T)
                ab = abq.float()
                s_b = (ab[:, :W][:, a_col] + ab[:, W:][:, b_col]) * abss
                s = (s_qk + s_b) * scale
            else:
                s = (q.float() @ k.float().T + A[:, a_col] + Bb[:, b_col]) * scale
            p, l = _softmax_weights(s, exp_bf16, v.dtype)
            out[b, :, h * hd:(h + 1) * hd] = ((p @ v.float()) / l).to(y.dtype)
    return out


def _code_rows(head_dim: int):
    """(width, dtype) of a q or k code row of the `dots_i8` pre-pass: 128
    int8 bytes, zero past head_dim; at head_dim 64, 64 codes in bf16 (small
    integers, exact), which the CUDA kernel multiplies on the bf16 tensor
    cores."""
    return (64, torch.bfloat16) if head_dim == 64 else (128, torch.int8)


def global_y_quant_i8_plain(y, bias_a, bias_b, num_heads: int, head_dim: int):
    """Plain version of the `dots_i8` pre-pass of `fused_global_attention_y`:
    every q row, k row and row of bias terms [A | B] quantized to int8 once
    (`_row_quant`, the TPU kernel's `_rq_rows`). Returns the q and k codes
    in `_code_rows(head_dim)`'s rows, zero past head_dim, [2, B, H, S, 128]
    int8 or [2, B, H, S, 64] bf16 (q's then k's); their scales [2, B, H, S]
    fp32; the [A | B] codes as y.dtype (small integers, exact), A's and B's
    each [B, S, H, W] like the terms; and the [A | B] rows' scales [B, H, S]
    fp32."""
    B, S, _ = y.shape
    H, hd = num_heads, head_dim
    W = bias_a.shape[-1]
    y5 = y.reshape(B, S, 3, H, hd)
    width, dtype = _code_rows(hd)
    codes = torch.zeros((2, B, H, S, width), dtype=dtype, device=y.device)
    scales = torch.empty((2, B, H, S), dtype=torch.float32, device=y.device)
    for sec in range(2):
        c, sc = _row_quant(y5[:, :, sec].transpose(1, 2))  # [B, H, S, hd], [B, H, S, 1]
        codes[sec, ..., :hd] = c
        scales[sec] = sc[..., 0]
    abq, abss = _row_quant(torch.cat([bias_a, bias_b], dim=-1))  # [B, S, H, 2W], [B, S, H, 1]
    ab = abq.to(y.dtype)
    return (codes, scales, ab[..., :W].contiguous(), ab[..., W:].contiguous(),
            abss[..., 0].transpose(1, 2).contiguous())


def global_y_quant_i8(y, bias_a, bias_b, num_heads: int, head_dim: int):
    """The `dots_i8` pre-pass of `fused_global_attention_y` (arguments as
    there; outputs as `global_y_quant_i8_plain`'s): every row quantized
    once per layer. CUDA kernel `kernels/csrc/sam_global_attention_y.cu`
    (its pre-pass entries: W 64, hd 80 or, `_hd64`, 64; bf16) for CUDA
    tensors, the plain version for CPU ones."""
    B, S, width = y.shape
    H, hd = num_heads, head_dim
    if width != 3 * H * hd or bias_a.shape != (B, S, H, bias_a.shape[-1]) or (
            bias_b.shape != bias_a.shape):
        raise ValueError(f"y {tuple(y.shape)} / bias {tuple(bias_a.shape)} do not match H={H}")
    if y.device.type == "cpu":
        return global_y_quant_i8_plain(y, bias_a, bias_b, H, hd)
    if hd not in (64, 80) or (S, bias_a.shape[-1]) != (4096, 64):
        raise ValueError(
            f"the CUDA dots_i8 pre-pass is built for hd 80 or 64, W 64; got hd {hd}, S {S}")
    for name, t in (("y", y), ("bias_a", bias_a), ("bias_b", bias_b)):
        kernels.check_cuda_tensor(f"global_y {name}", t, torch.bfloat16)
    width, dtype = _code_rows(hd)
    codes = torch.empty((2, B, H, S, width), dtype=dtype, device=y.device)
    scales = torch.empty((2, B, H, S), dtype=torch.float32, device=y.device)
    ac, bc = torch.empty_like(bias_a), torch.empty_like(bias_b)
    abss = torch.empty((B, H, S), dtype=torch.float32, device=y.device)
    kernels.launch(
        "global_attention_y_quant_i8" + ("_hd64" if hd == 64 else ""), kernels.ptr(y),
        kernels.ptr(bias_a), kernels.ptr(bias_b),
        kernels.ptr(codes), kernels.ptr(scales), kernels.ptr(ac), kernels.ptr(bc), kernels.ptr(abss), B, H,
    )
    return codes, scales, ac, bc, abss


def fused_global_attention_y(
    y: torch.Tensor,  # [B, S, 3C] raw qkv projection output (bias included)
    bias_a: torch.Tensor,  # [B, S, H, W] pre-scaled by 1/scale, y.dtype
    bias_b: torch.Tensor,  # [B, S, H, W]
    num_heads: int,
    head_dim: int,
    window: int,
    scale: float,
    head_group: int = 0,
    exp_bf16: bool = False,
    dots_i8: bool = False,
) -> torch.Tensor:
    """Global-block attention that reads q, k and v in place from the
    fused LN+qkv output (head h of a section at columns `h * head_dim`)
    and returns the head-merged [B, S, C] pre-projection activations.
    `head_group` is a lane-alignment matter of the TPU kernel: accepted
    and ignored (a block reads one head's lanes, so any head count runs).
    CUDA kernel `kernels/csrc/sam_global_attention_y.cu` (W 64, hd 80 or,
    its `_hd64` entries, 64, bf16, on the wgmma + TMA core
    `global_sm90.cuh`; for `dots_i8` its pre-pass, which quantizes every
    row once, then its `_i8` entry) for CUDA tensors, the plain version for
    CPU ones."""
    B, S, width = y.shape
    H, hd, W = num_heads, head_dim, window
    if S != W * W or width != 3 * H * hd:
        raise ValueError(f"y {tuple(y.shape)} does not match H={H} hd={hd} W={W}")
    if bias_a.shape != (B, S, H, W) or bias_b.shape != (B, S, H, W):
        raise ValueError(f"bias terms must be [{B}, {S}, {H}, {W}]")
    if y.device.type == "cpu":
        return fused_global_attention_y_plain(
            y, bias_a, bias_b, H, hd, W, scale, exp_bf16=exp_bf16, dots_i8=dots_i8
        )
    if W != 64 or hd not in (64, 80):
        raise ValueError(f"the CUDA global kernel is built for hd 80 or 64, W 64; got {hd}, {W}")
    for name, t in (("y", y), ("bias_a", bias_a), ("bias_b", bias_b)):
        kernels.check_cuda_tensor(f"global_y {name}", t, torch.bfloat16)
    out = torch.empty((B, S, H * hd), dtype=y.dtype, device=y.device)
    hd64 = "_hd64" if hd == 64 else ""
    if not dots_i8:
        kernels.launch(
            "fused_global_attention_y" + hd64, kernels.ptr(y), kernels.ptr(bias_a),
            kernels.ptr(bias_b), kernels.ptr(out), B, H, float(scale), int(exp_bf16),
        )
        return out
    codes, scales, ac, bc, abss = global_y_quant_i8(y, bias_a, bias_b, H, hd)
    kernels.launch(
        "fused_global_attention_y_i8" + hd64, kernels.ptr(y), kernels.ptr(codes), kernels.ptr(scales),
        kernels.ptr(ac), kernels.ptr(bc), kernels.ptr(abss), kernels.ptr(out), B, H, float(scale),
        int(exp_bf16),
    )
    return out


def decomposed_bias_terms(
    q_grid: torch.Tensor,  # [B, H, W, W, hd] query positions on the grid
    rel_pos_h: torch.Tensor,  # [2W-1, hd]
    rel_pos_w: torch.Tensor,
    window: int,
):
    """Compact bias terms A[b,h,(i,j),a] and Bb[b,h,(i,j),b], fp32."""
    coords = torch.arange(window, device=q_grid.device)
    rel = coords[:, None] - coords[None, :] + (window - 1)
    RhG = rel_pos_h[rel].float()  # [i, a, hd]
    RwG = rel_pos_w[rel].float()  # [j, b, hd]
    qf = q_grid.float()
    A = torch.einsum("nhijc,iac->nhija", qf, RhG)
    Bb = torch.einsum("nhijc,jbc->nhijb", qf, RwG)
    B, H = q_grid.shape[:2]
    S = window * window
    return A.reshape(B, H, S, window), Bb.reshape(B, H, S, window)


def fused_window_attention_plain(q, k, v, bias_a, bias_b, window: int, scale: float):
    """Plain version of `fused_window_attention`, in the TPU kernel's
    arithmetic: the bias terms pre-scaled by 1/scale and rounded to q's
    dtype, s = (q.k + A + Bb) * scale, an exact softmax whose weights are
    normalized before they are rounded to v's dtype for the value product."""
    N, S, _ = q.shape
    inv = 1.0 / scale
    a_s = (bias_a.float() * inv).to(q.dtype).float()
    b_s = (bias_b.float() * inv).to(q.dtype).float()
    bias = (a_s[:, :, :, None] + b_s[:, :, None, :]).reshape(N, S, S)
    s = (torch.einsum("nsd,ntd->nst", q.float(), k.float()) + bias) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("nst,ntd->nsd", p, v.float()).to(q.dtype)


def fused_window_attention(
    q: torch.Tensor,  # [N, S, hd] (N = windows x heads), S = window^2
    k: torch.Tensor,
    v: torch.Tensor,
    bias_a: torch.Tensor,  # [N, S, W] raw, natural column order
    bias_b: torch.Tensor,
    window: int,
    scale: float,
    n_block: int = 8,
) -> torch.Tensor:
    """Window attention per (window, head) pair in the head-major layout,
    with the decomposed bias. `n_block` is the TPU kernel's pairs a
    program: accepted and ignored. CUDA kernel
    `kernels/csrc/sam_window_attention.cu` (its head-major entry on the
    whole-window core: W 14, hd 80, bf16) for CUDA tensors, the plain
    version for CPU ones."""
    N, S, hd = q.shape
    W = window
    if S != W * W or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v {tuple(q.shape)} do not match window {W}")
    if bias_a.shape != (N, S, W) or bias_b.shape != (N, S, W):
        raise ValueError(f"bias terms must be [{N}, {S}, {W}]")
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias_a, bias_b, W, scale)
    _check_window_kernel_shape(hd, W)
    for name, t in (("q", q), ("k", k), ("v", v), ("bias_a", bias_a), ("bias_b", bias_b)):
        kernels.check_cuda_tensor(f"window {name}", t, torch.bfloat16)
    out = torch.empty_like(q)
    kernels.launch(
        "fused_window_attention", kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(bias_a), kernels.ptr(bias_b), kernels.ptr(out), N, float(scale),
    )
    return out


def _packed_qkv(y, num_heads: int, head_pad: int, c0: int, c1: int):
    """q, k, v of instances y[c0:c1] of a packed projection output, each
    [n, H, S, hp] in fp32."""
    S = y.shape[1]
    y5 = y[c0:c1].reshape(c1 - c0, S, 3, num_heads, head_pad).float()
    return tuple(y5[:, :, i].transpose(1, 2) for i in range(3))


def fused_window_attention_packed_plain(
    y, bias_a, bias_b, num_heads: int, head_pad: int, window: int, scale: float,
    head_dim: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of `fused_window_attention_packed`, in the TPU
    kernel's arithmetic: s = q.k * scale + A[t // W] + Bb[t % W] in fp32,
    an exact softmax whose weights are normalized before they are rounded
    to y's dtype for the value product. Only the first `head_dim` lanes of
    each block (all `head_pad` by default) are contracted and written; the
    rest of the output is zero."""
    N, S, _ = y.shape
    H, hp, W = num_heads, head_pad, window
    hd = hp if head_dim is None else head_dim
    t = torch.arange(S, device=y.device)
    out = torch.zeros((N, S, H, hp), dtype=y.dtype, device=y.device)
    chunk = max(1, (1 << 26) // (H * S * S))  # bound the [n, H, S, S] fp32 scores
    for c0 in range(0, N, chunk):
        c1 = min(N, c0 + chunk)
        q, k, v = (x[..., :hd] for x in _packed_qkv(y, H, hp, c0, c1))
        A, Bb = bias_a[c0:c1].float(), bias_b[c0:c1].float()
        s = torch.einsum("nhsd,nhtd->nhst", q, k) * scale + A[..., t // W] + Bb[..., t % W]
        p = torch.softmax(s, dim=-1).to(y.dtype).float()
        out[c0:c1, ..., :hd] = torch.einsum("nhst,nhtd->nshd", p, v).to(y.dtype)
    return out.reshape(N, S, H * hp)


def fused_global_attention_packed_plain(
    y, bias_a, bias_b, num_heads: int, head_pad: int, window: int, scale: float,
    head_dim: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of `fused_global_attention_packed`: the scores of the
    window form, one softmax over all S keys with fp32 exponentials, the
    unnormalized weights rounded to y's dtype for the value product and
    the fp32 sum dividing after it (`_softmax_weights`), as the TPU
    kernel's online softmax ends. Only the first `head_dim` lanes of each
    block (all `head_pad` by default) are contracted and written; the rest
    of the output is zero."""
    B, S, _ = y.shape
    H, hp, W = num_heads, head_pad, window
    hd = hp if head_dim is None else head_dim
    t = torch.arange(S, device=y.device)
    out = torch.zeros((B, S, H, hp), dtype=y.dtype, device=y.device)
    for b in range(B):
        q, k, v = (x[0, ..., :hd] for x in _packed_qkv(y, H, hp, b, b + 1))
        for h in range(H):
            A, Bb = bias_a[b, h].float(), bias_b[b, h].float()
            s = (q[h] @ k[h].T) * scale + A[:, t // W] + Bb[:, t % W]
            p, l = _softmax_weights(s, False, y.dtype)
            out[b, :, h, :hd] = ((p @ v[h]) / l).to(y.dtype)
    return out.reshape(B, S, H * hp)


# The real head widths the CUDA packed kernels have instances for (ViT-L's
# and ViT-B's 64, ViT-H's 80).
_PACKED_HEAD_DIMS = (64, 80)


def _packed_attention(name, y, bias_a, bias_b, num_heads, head_pad, window, scale, plain,
                      cuda_window, head_dim=None):
    """Checks, then the plain version on the CPU or kernel `name` on the
    card over the `head_dim` real lanes of each block (all `head_pad` by
    default: on the card a ValueError, as is any width without an
    instance)."""
    N, S, width = y.shape
    H, hp, W = num_heads, head_pad, window
    hd = hp if head_dim is None else head_dim
    if not 0 < hd <= hp:
        raise ValueError(f"head_dim {hd} must be in [1, head_pad {hp}]")
    if S != W * W or width != 3 * H * hp:
        raise ValueError(f"y {tuple(y.shape)} does not match H={H} hp={hp} W={W}")
    if bias_a.shape != (N, H, S, W) or bias_b.shape != (N, H, S, W):
        raise ValueError(f"bias terms must be [{N}, {H}, {S}, {W}]")
    if y.device.type == "cpu":
        return plain(y, bias_a, bias_b, H, hp, W, scale, hd)
    if hd not in _PACKED_HEAD_DIMS:
        raise ValueError(f"the CUDA {name} kernel is built for head_dim {_PACKED_HEAD_DIMS}; "
                         f"got {hd}")
    if (hp, W) != (128, cuda_window):
        raise ValueError(f"the CUDA {name} kernel is built for hp 128, W {cuda_window}; "
                         f"got {hp}, {W}")
    for label, t in (("y", y), ("bias_a", bias_a), ("bias_b", bias_b)):
        kernels.check_cuda_tensor(f"{name} {label}", t, torch.bfloat16)
    out = torch.empty((N, S, H * hp), dtype=y.dtype, device=y.device)
    kernels.launch(name, kernels.ptr(y), kernels.ptr(bias_a), kernels.ptr(bias_b), kernels.ptr(out),
                   N, H, hd, float(scale))
    return out


def fused_window_attention_packed(
    y: torch.Tensor,  # [N, S, 3*H*hp] packed qkv projection output
    bias_a: torch.Tensor,  # [N, H, S, W] raw
    bias_b: torch.Tensor,  # [N, H, S, W]
    num_heads: int,
    head_pad: int,
    window: int,
    scale: float,
    n_block: int = 8,
    head_dim: Optional[int] = None,
) -> torch.Tensor:
    """Window attention on the packed head-major layout; returns the
    [N, S, H*hp] head-major output, pad lanes included. `head_dim` is the
    real lanes of each block, which alone are contracted; the output's
    other lanes are written as zeros. It defaults to `head_pad` (every
    lane, the JAX function as it is); on the packed layout's zero pad lanes
    both give the same result. `n_block` is TPU tiling: accepted and
    ignored. CUDA kernel `kernels/csrc/sam_packed_attention.cu` (hp 128,
    head_dim 64 or 80: ViT-L's and ViT-B's, ViT-H's; W 14, bf16) for CUDA
    tensors, which raises ValueError for any other head_dim; the plain
    version for CPU ones."""
    return _packed_attention("fused_window_attention_packed", y, bias_a, bias_b, num_heads,
                             head_pad, window, scale, fused_window_attention_packed_plain, 14,
                             head_dim=head_dim)


def fused_global_attention_packed(
    y: torch.Tensor,  # [B, S, 3*H*hp]
    bias_a: torch.Tensor,  # [B, H, S, W] raw
    bias_b: torch.Tensor,  # [B, H, S, W]
    num_heads: int,
    head_pad: int,
    window: int,
    scale: float,
    block_q: int = 1024,
    block_k: int = 1024,
    head_dim: Optional[int] = None,
) -> torch.Tensor:
    """Global attention on the packed head-major layout, online softmax
    with fp32 exponentials; returns [B, S, H*hp], pad lanes included.
    `head_dim` is the real lanes of each block, which alone are
    contracted; the output's other lanes are written as zeros. It defaults
    to `head_pad` (every lane, the JAX function as it is); on the packed
    layout's zero pad lanes both give the same result. `block_q` and
    `block_k` are TPU tiling: accepted and ignored. CUDA kernel
    `kernels/csrc/sam_packed_attention.cu` (hp 128, head_dim 64 or 80, W
    64, bf16, on the wgmma + TMA core `global_sm90.cuh`) for CUDA tensors,
    which raises ValueError for any other head_dim; the plain version for
    CPU ones."""
    return _packed_attention("fused_global_attention_packed", y, bias_a, bias_b, num_heads,
                             head_pad, window, scale, fused_global_attention_packed_plain, 64,
                             head_dim=head_dim)
