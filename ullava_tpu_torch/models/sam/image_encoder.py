"""SAM ViTDet image encoder, block and resident window layouts and the
packed attention layout (counterpart of
`ullava_tpu/models/sam/image_encoder.py`).

ViT backbone with 14x14 window attention and global blocks closing each
group, decomposed relative position bias, conv neck to 256 channels; NHWC
throughout. Attention goes through the ported kernels' wrappers:
`fused_window_attention_grid` for sizes up to 16 and
`fused_global_attention` above (the JAX dispatch at `_attn`).

In the block layout each window block pads the grid after LN1 (64 -> 70
for ViT-H: pad tokens carry qkv = qkv_bias and take part as keys, exactly
as the reference's zero pad), partitions into windows, attends, merges
and crops. In the resident layout (the default wherever the grid holds a
whole window) the grid is partitioned once per group into compact
window-major class tensors: full windows, and the right, bottom and
corner boundary windows as their real rectangles with no pad token
anywhere. The group's window blocks run on those; `fused_window_attention_rect`
rebuilds the boundary windows' pad keys from the qkv bias; grid order
returns for the group's closing global block.

Weights may be int8 leaves (`quant.SAM_ENCODER_QUANT_KEYS`). Then the
JAX package's shape gates choose the function, as they choose it there
(the two sides of a gate differ in value: polynomial erf and int8
activations against exact erf and weight-only int8): every block's MLP
goes to `fused_mlp_block` when fc1 and fc2 are int8, F % 512 == 0 and
the token count % 512 == 0, and a global block goes to `fused_ln_linear`
(LN1+qkv) -> `fused_global_attention_y` -> `fused_linear` (proj +
residual) when qkv and proj are int8, the grid is above 16 and
S % 1024 == 0 (with head-major copies and `fused_global_attention` in the
middle when no head slab of the qkv output is 128-aligned, as the JAX
package chooses). The block layout's window blocks keep plain LN and
weight-only `apply_linear` around the window kernel. The resident
layout's take `fused_ln_linear` (LN1+qkv) and `fused_linear` (proj +
residual) when qkv and proj are int8, the right and bottom classes as one
token stream; with the composite bias weights of
`precompute_window_bias_weights`, `fused_ln_linear_dual` emits the bias
terms beside qkv and the full windows are stored as 200 rows. There is no
device gate: on CUDA tensors the wrappers launch their kernels, on CPU
tensors they take their plain versions. `attn_kernel` is the JAX knob:
"auto" takes every route above; "xla" takes the routes the JAX package
takes off the TPU (`_use_pallas` false) on any device: plain attention
(`attention_xla`) with the materialised rel-pos bias in every block, packed
weights sliced back to their heads, no fused int8 global route and no
fused MLP, whose arithmetic differs, and the block window layout. It
launches no SAM attention kernel.
`use_rel_pos=False` takes the JAX package's XLA routes on every device:
plain attention with no bias (`attention_xla`) in every block, the
block layout, and no fused int8 global route or fused MLP.

`pack_sam_attention` repacks qkv/proj head-major with each head padded to
`head_pad` lanes (128 on the card); such weights are detected by shape
(`_is_packed`) and take `_attn_packed` in every block, through
`fused_window_attention_packed` (windows) and
`fused_global_attention_packed` (the global grid), always in the block
layout. Packed int8 qkv/proj at a global block that the fused int8 route
would take are refused (ValueError): the JAX package fails there too.

Parameters: `window_blocks` (list of G*(P-1) per-block dicts, group-major)
and `global_blocks` (list of G), where the depth factors into G groups of
P layers with a global block closing each group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal
from ullava_tpu_torch.ops.attention import attention_xla
from ullava_tpu_torch.ops.mlp_kernel import (
    fused_linear,
    fused_ln_linear,
    fused_ln_linear_dual,
    fused_mlp_block,
)
from ullava_tpu_torch.ops.norms import layer_norm
from ullava_tpu_torch.ops.quant import (
    apply_linear,
    apply_linear_a8,
    column_major,
    dequantize,
    is_quantized,
    quantize_int8,
)
from ullava_tpu_torch.ops.sam_attention import (
    decomposed_bias_terms,
    fused_global_attention,
    fused_global_attention_packed,
    fused_global_attention_y,
    fused_window_attention_grid,
    fused_window_attention_packed,
    fused_window_attention_rect,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamVisionConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    # The decomposed relative position bias. Off: every block takes plain
    # attention with no bias (the JAX package's XLA attention), the block
    # layout and the plain MLP, on CPU and CUDA tensors alike.
    use_rel_pos: bool = True
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # Run the fused kernels' products int8 x int8 with per-row dynamic
    # activation quantization (the MLP's, and the global blocks' LN1+qkv
    # and proj). Off: weight-only int8 (plain versions only on the card).
    mlp_w8a8: bool = False
    # The same int8 activations for the unfused qkv/proj projections of
    # `_attn` (`apply_linear_a8` in place of `apply_linear`).
    attn_w8a8: bool = False
    # int8 x int8 attention score products inside the window, boundary and
    # lane-sliced global kernels (q, k and the bias terms quantized per row;
    # P V stays bf16). The transpose-staged global kernel has no such form.
    attn_dots_i8: bool = False
    # Window-block token layout: "block" (pad, partition, attend, merge,
    # crop in every window block), "resident" (one partition per group
    # into compact window-major class tensors), or "auto": resident
    # wherever the grid holds a whole window and the fused routes run.
    window_layout: str = "auto"
    # JAX `attn_kernel`: "auto" (the fused routes) or "xla" (the JAX
    # package's routes off the TPU on any device, see the module doc).
    attn_kernel: str = "auto"

    def __post_init__(self) -> None:
        if self.window_layout not in ("auto", "block", "resident"):
            raise ValueError(f"unknown window_layout {self.window_layout!r}")
        if self.attn_kernel not in ("auto", "xla"):
            raise ValueError(f"unknown attn_kernel {self.attn_kernel!r}")
        if self.attn_kernel == "xla" and self.window_layout == "resident":
            raise ValueError('attn_kernel="xla" takes the block layout')
        if not self.use_rel_pos and self.window_layout == "resident":
            raise ValueError("use_rel_pos=False takes the block layout")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_groups(self) -> int:
        return len(self.global_attn_indexes)

    @property
    def group_period(self) -> int:
        return self.depth // self.num_groups

    def validate_grouping(self) -> None:
        p = self.group_period
        expected = tuple((i + 1) * p - 1 for i in range(self.num_groups))
        if expected != tuple(self.global_attn_indexes) or p * self.num_groups != self.depth:
            raise NotImplementedError(
                f"global_attn_indexes {self.global_attn_indexes} do not close "
                f"uniform groups of {p}; expected {expected}"
            )

    @classmethod
    def tiny(cls, **kw) -> "SamVisionConfig":
        defaults = dict(
            img_size=64, patch_size=16, embed_dim=32, depth=4, num_heads=2,
            out_chans=16, window_size=2, global_attn_indexes=(1, 3),
            dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


def _block_init(gen, cfg: SamVisionConfig, window: bool, device) -> Params:
    C, hd = cfg.embed_dim, cfg.head_dim
    F_ = int(cfg.embed_dim * cfg.mlp_ratio)
    rel = 2 * (cfg.window_size if window else cfg.grid) - 1

    def z(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    def w(*shape):
        return normal(gen, shape, cfg.dtype, device)

    return {
        "ln1_scale": torch.ones(C, dtype=cfg.dtype, device=device), "ln1_bias": z(C),
        "qkv": w(C, 3 * C), "qkv_bias": z(3 * C),
        "proj": w(C, C), "proj_bias": z(C),
        "rel_pos_h": z(rel, hd), "rel_pos_w": z(rel, hd),
        "ln2_scale": torch.ones(C, dtype=cfg.dtype, device=device), "ln2_bias": z(C),
        "fc1": w(C, F_), "fc1_bias": z(F_),
        "fc2": w(F_, C), "fc2_bias": z(C),
    }


def init_params(
    cfg: SamVisionConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    cfg.validate_grouping()
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    C, g, O = cfg.embed_dim, cfg.grid, cfg.out_chans
    patch_dim = 3 * cfg.patch_size * cfg.patch_size

    def w(*shape):
        return normal(gen, shape, cfg.dtype, device)

    def const(shape, val):
        return torch.full(shape, val, dtype=cfg.dtype, device=device)

    n_window = cfg.num_groups * (cfg.group_period - 1)
    return {
        "patch_proj": w(patch_dim, C),
        "patch_bias": const((C,), 0.0),
        "pos_embed": const((g, g, C), 0.0),
        "window_blocks": [_block_init(gen, cfg, True, device) for _ in range(n_window)],
        "global_blocks": [_block_init(gen, cfg, False, device) for _ in range(cfg.num_groups)],
        "neck_conv1": w(C, O),
        "neck_ln1_scale": const((O,), 1.0),
        "neck_ln1_bias": const((O,), 0.0),
        "neck_conv2": w(3, 3, O, O),  # HWIO
        "neck_ln2_scale": const((O,), 1.0),
        "neck_ln2_bias": const((O,), 0.0),
    }


def pack_sam_attention(enc: Params, cfg: SamVisionConfig, head_pad: int = 128) -> Params:
    """Serving-time weight repack: qkv/proj reordered so that each head's
    slice is a zero-padded `head_pad`-lane block ([C, 3, H, hp] column
    order, [H, hp, C] row order). The packed kernels then read a head's q,
    k and v as one lane block of the projection output, with no head split
    or transpose copy. Zero pads are exact: pad lanes of q and k add
    nothing to q.k, and pad lanes of the attention output meet zero rows
    of proj. On int8 leaves `q` pads with 0 and its `scale` with 1.0, and
    `q` stays column-major. rel_pos lanes pad with zeros. Returns `enc`
    itself when head_dim >= head_pad; otherwise a copy (other leaves
    shared)."""
    H, hd, hp = cfg.num_heads, cfg.head_dim, head_pad
    if hd >= hp:
        return enc

    def pad_cols(w, fill=0.0):  # [..., 3*H*hd] -> [..., 3*H*hp]
        lead = w.shape[:-1]
        w = F.pad(w.reshape(*lead, 3, H, hd), (0, hp - hd), value=fill)
        return w.reshape(*lead, 3 * H * hp)

    def pad_rows(w):  # [H*hd, C] -> [H*hp, C]
        C = w.shape[-1]
        return F.pad(w.reshape(H, hd, C), (0, 0, 0, hp - hd)).reshape(H * hp, C)

    def pack_block(blk):
        blk = dict(blk)
        if is_quantized(blk["qkv"]):
            blk["qkv"] = {"q": column_major(pad_cols(blk["qkv"]["q"])),
                          "scale": pad_cols(blk["qkv"]["scale"], fill=1.0)}
        else:
            blk["qkv"] = pad_cols(blk["qkv"])
        blk["qkv_bias"] = pad_cols(blk["qkv_bias"])
        if is_quantized(blk["proj"]):
            blk["proj"] = {"q": column_major(pad_rows(blk["proj"]["q"])),
                           "scale": blk["proj"]["scale"]}
        else:
            blk["proj"] = pad_rows(blk["proj"])
        for k in ("rel_pos_h", "rel_pos_w"):
            blk[k] = F.pad(blk[k], (0, hp - hd))
        return blk

    return {**enc, "window_blocks": [pack_block(b) for b in enc["window_blocks"]],
            "global_blocks": [pack_block(b) for b in enc["global_blocks"]]}


def _fused_routes(cfg: SamVisionConfig) -> bool:
    """The JAX `_use_pallas`: the fused int8 global route, the fused MLP
    and the resident layout, unless `attn_kernel="xla"` or
    `use_rel_pos=False`."""
    return cfg.attn_kernel != "xla" and cfg.use_rel_pos


def _is_packed(p: Params, cfg: SamVisionConfig) -> bool:
    """Packed weights (`pack_sam_attention`): the qkv output is not 3*C wide."""
    w = p["qkv"]["q"] if is_quantized(p["qkv"]) else p["qkv"]
    return w.shape[-1] != 3 * cfg.embed_dim


def _bias_terms_packed(q_grid, rel_pos_h, rel_pos_w, size: int):
    """[B, i, j, H, hp] queries (unscaled) -> (A, Bb), each [B, H, S, W]
    in fp32, head-second: the order the packed kernels read."""
    coords = torch.arange(size, device=q_grid.device)
    rel = coords[:, None] - coords[None, :] + (size - 1)
    RhG, RwG = rel_pos_h[rel].float(), rel_pos_w[rel].float()  # [i, a, hp]
    qf = q_grid.float()
    A = torch.einsum("nijhc,iac->nhija", qf, RhG)
    Bb = torch.einsum("nijhc,jbc->nhijb", qf, RwG)
    B, H = A.shape[:2]
    return A.reshape(B, H, size * size, size), Bb.reshape(B, H, size * size, size)


def _attn_packed(x: torch.Tensor, p: Params, cfg: SamVisionConfig, size: int) -> torch.Tensor:
    """Attention with packed qkv/proj weights over [B, size, size, C]: the
    projection output y [B, S, 3*H*hp] goes to the packed window kernel
    (sizes up to 16) or the packed global kernel whole."""
    B = x.shape[0]
    C, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    S = size * size
    w = p["qkv"]["q"] if is_quantized(p["qkv"]) else p["qkv"]
    hp = w.shape[-1] // (3 * H)
    y = _lin(cfg, x.reshape(B, S, C), p["qkv"]) + p["qkv_bias"]  # [B, S, 3*H*hp]
    q_grid = y.reshape(B, size, size, 3, H, hp)[:, :, :, 0]
    A, Bb = _bias_terms_packed(q_grid, p["rel_pos_h"], p["rel_pos_w"], size)
    A, Bb = A.to(y.dtype), Bb.to(y.dtype)
    if cfg.attn_kernel == "xla":
        # The JAX package's unpacked route: heads sliced back out, the bias
        # expanded to [B, H, S, S] (t = a * W + b), the output re-padded.
        qkv = y.reshape(B, S, 3, H, hp)[..., :hd]
        bias = (A.float()[..., :, None] + Bb.float()[..., None, :]).reshape(B, H, S, S)
        out = attention_xla(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias=bias, scale=hd**-0.5)
        out = F.pad(out.reshape(B, S, H, hd), (0, hp - hd)).reshape(B, S, H * hp)
    else:
        fused = fused_window_attention_packed if size <= 16 else fused_global_attention_packed
        out = fused(y, A.contiguous(), Bb.contiguous(), num_heads=H,
                    head_pad=hp, window=size, scale=hd**-0.5)  # [B, S, H*hp]
    out = _lin(cfg, out, p["proj"]) + p["proj_bias"]
    return out.reshape(B, size, size, C)


def rel_pos_bias(
    q: torch.Tensor,  # [B, H, qh, qw, hd]
    rel_pos_h: torch.Tensor,  # [2*size-1, hd]
    rel_pos_w: torch.Tensor,
    size: int,
) -> torch.Tensor:
    """Materialised decomposed bias [B, H, size^2, size^2] (reference
    path: bias[qh,qw,kh,kw] = q.Rh[qh,kh] + q.Rw[qw,kw])."""
    coords = torch.arange(size, device=q.device)
    rel = coords[:, None] - coords[None, :] + (size - 1)
    Rh, Rw = rel_pos_h[rel].float(), rel_pos_w[rel].float()
    qf = q.float()
    bias_h = torch.einsum("bhqwc,qkc->bhqwk", qf, Rh)
    bias_w = torch.einsum("bhqwc,wkc->bhqwk", qf, Rw)
    B, H = q.shape[:2]
    return (bias_h[..., :, None] + bias_w[..., None, :]).reshape(B, H, size * size, size * size)


def _bias_terms_grid(y, rel_pos_h, rel_pos_w, cfg: SamVisionConfig, size: int):
    """Bias terms for `fused_window_attention_grid` from the qkv output
    y [N, S, 3C]: (A, Bb), each [N, S, H*W] in y.dtype."""
    return _bias_terms_rect(y, rel_pos_h, rel_pos_w, cfg, size, size, size)


def _bias_terms_rect(y, rel_pos_h, rel_pos_w, cfg: SamVisionConfig, rows: int, cols: int, W: int):
    """Bias terms of the rows x cols real rectangle of a logical W x W
    window (the whole window when rows = cols = W) from the qkv output
    y [N, rows*cols, 3C]: P = q @ blockdiag(rel_pos * sqrt(hd)) over
    r = 0..2W-2, then A[s, h, a'] = P[s, h, i(s) + a'] (the reversed-column
    order the kernels take). Queries exist at real positions only, but
    each is biased against all W key rows and columns of the logical
    window. Returns (A, Bb), each [N, rows*cols, H*W] in y.dtype."""
    H, hd, C = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    R = 2 * W - 1
    N, T, _ = y.shape
    inv = float(hd**0.5)  # 1/scale, folded into the weights

    def block_diag(rel):  # [R, hd] -> [C, H*R]
        blk = (rel.float() * inv).to(y.dtype).T
        return torch.block_diag(*([blk] * H))

    q = y[:, :, :C]
    Ph = (q @ block_diag(rel_pos_h)).reshape(N, rows, cols, H, R)
    Pw = (q @ block_diag(rel_pos_w)).reshape(N, rows, cols, H, R)
    A = torch.cat([Ph[:, i:i + 1, :, :, i:i + W] for i in range(rows)], dim=1)
    Bb = torch.cat([Pw[:, :, j:j + 1, :, j:j + W] for j in range(cols)], dim=2)
    return A.reshape(N, T, H * W), Bb.reshape(N, T, H * W)


def precompute_window_bias_weights(enc: Params, cfg: SamVisionConfig) -> Params:
    """Serving-time weight preparation: fold the window blocks' rel-pos
    bias products into the LN1+qkv projection. The bias terms are linear
    in the q columns of the qkv output, A = (LN(x) @ Wq + bq) @
    BD(rel_pos_h * sqrt(hd)), so the composite weight Wq @ BD and the
    constant bq @ BD depend on frozen parameters only, and
    `fused_ln_linear_dual` emits the bias-term matrix beside y.

    Returns a copy of `enc` whose window blocks each gain `biasw` (an int8
    leaf [C, 2*H*R], R = 2W-1, columns ordered [2, H, R]: h-terms, then
    w-terms) and `biasw_bias` ([2*H*R], f32). The composite is computed in
    f32 from the dequantized qkv weight."""
    C, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    R = 2 * cfg.window_size - 1
    inv = float(hd**0.5)  # the 1/scale prefold of `_bias_terms_rect`
    blocks = []
    for p in enc["window_blocks"]:
        wq = dequantize(p["qkv"], torch.float32)[:, :C].float().reshape(C, H, hd)
        bq = p["qkv_bias"][:C].float().reshape(H, hd)
        rels = [p[k].float() * inv for k in ("rel_pos_h", "rel_pos_w")]  # [R, hd] each
        comp = torch.stack([torch.einsum("chd,rd->chr", wq, rel) for rel in rels], dim=1)
        bconst = torch.stack([torch.einsum("hd,rd->hr", bq, rel) for rel in rels], dim=0)
        blocks.append({**p, "biasw": quantize_int8(comp.reshape(C, 2 * H * R)),
                       "biasw_bias": bconst.reshape(2 * H * R)})
    return {**enc, "window_blocks": blocks}


def _assemble_bias_terms(P: torch.Tensor, rows: int, cols: int, W: int, H: int, pad_rows: int = 0):
    """[N, rows*cols, 2*H*R] bias-term output of `fused_ln_linear_dual`
    -> (A, Bb), each [N, rows*cols + pad_rows, H*W] in the reversed column
    order the window kernels take (the slice assembly of
    `_bias_terms_rect` on a precomputed P). `pad_rows` appends zero rows
    for the padded full-window layout: those rows are left out as keys, so
    only their finiteness matters."""
    N, T, _ = P.shape
    R = 2 * W - 1
    P6 = P.reshape(N, rows, cols, 2, H, R)
    A = torch.cat([P6[:, i:i + 1, :, 0, :, i:i + W] for i in range(rows)], dim=1)
    Bb = torch.cat([P6[:, :, j:j + 1, 1, :, j:j + W] for j in range(cols)], dim=2)
    A, Bb = A.reshape(N, T, H * W), Bb.reshape(N, T, H * W)
    if pad_rows:
        A, Bb = F.pad(A, (0, 0, 0, pad_rows)), F.pad(Bb, (0, 0, 0, pad_rows))
    return A, Bb


def _lin(cfg: SamVisionConfig, x: torch.Tensor, w) -> torch.Tensor:
    if cfg.attn_w8a8 and is_quantized(w):
        return apply_linear_a8(x, w)
    return apply_linear(x, w)


def _attn(x: torch.Tensor, p: Params, cfg: SamVisionConfig, size: int) -> torch.Tensor:
    """Self-attention over an NHWC token grid [B, size, size, C]."""
    if _is_packed(p, cfg):
        return _attn_packed(x, p, cfg, size)
    B = x.shape[0]
    C, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    S = size * size
    y = _lin(cfg, x.reshape(B, S, C), p["qkv"]) + p["qkv_bias"]  # [B, S, 3C]
    if cfg.attn_kernel == "xla" or not cfg.use_rel_pos:
        qkv = y.reshape(B, S, 3, H, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        bias = None
        if cfg.use_rel_pos:
            # Rel-pos from the UNSCALED q; attention_xla scales q.k only.
            q_grid = q.transpose(1, 2).reshape(B, H, size, size, hd)
            bias = rel_pos_bias(q_grid, p["rel_pos_h"], p["rel_pos_w"], size)
        out = attention_xla(q, k, v, bias=bias, scale=hd**-0.5).reshape(B, S, C)
    elif size <= 16:
        A, Bb = _bias_terms_grid(y, p["rel_pos_h"], p["rel_pos_w"], cfg, size)
        out = fused_window_attention_grid(
            y, A, Bb, num_heads=H, head_dim=hd, window=size, scale=hd**-0.5,
            dots_i8=cfg.attn_dots_i8,
        )
    else:
        out = _global_attention_staged(y, p, cfg, size)
    out = _lin(cfg, out, p["proj"]) + p["proj_bias"]
    return out.reshape(B, size, size, C)


def _global_attention_staged(y: torch.Tensor, p: Params, cfg: SamVisionConfig, size: int):
    """Global attention from the qkv output y [B, S, 3C] through head-major
    copies of q, k and v and `fused_global_attention`; [B, S, C]. The bias
    uses the UNSCALED q; only q.k is scaled. The serving mode (`mlp_w8a8`)
    takes the exponentials in bf16."""
    B, S, _ = y.shape
    C, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    qkv = y.reshape(B, S, 3, H, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, hd]
    q, k, v = (t.reshape(B * H, S, hd).contiguous() for t in qkv)
    A, Bb = decomposed_bias_terms(
        qkv[0].reshape(B, H, size, size, hd), p["rel_pos_h"], p["rel_pos_w"], size
    )
    out = fused_global_attention(
        q, k, v, A.reshape(B * H, S, size).to(y.dtype), Bb.reshape(B * H, S, size).to(y.dtype),
        window=size, scale=hd**-0.5, exp_bf16=cfg.mlp_w8a8,
    )
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, C)


def _use_global_fused(p: Params, cfg: SamVisionConfig, size: int) -> bool:
    """The fused int8 route of a global block: LN1+qkv and proj+residual
    through `fused_ln_linear` / `fused_linear`."""
    return (
        _fused_routes(cfg)
        and size > 16  # global grid only; window sizes use the grid kernel
        and is_quantized(p["qkv"])
        and is_quantized(p["proj"])
        and (size * size) % 1024 == 0
    )


def _global_head_group(cfg: SamVisionConfig) -> int:
    """Largest head slab whose lanes form 128-aligned blocks of the raw
    qkv output, 0 when none exists: the TPU kernel's requirement, kept
    because it chooses between `fused_global_attention_y` and the
    transpose-staged `fused_global_attention`."""
    for hg in (16, 8, 4, 2, 1):
        if cfg.num_heads % hg == 0 and (hg * cfg.head_dim) % 128 == 0:
            return hg
    return 0


def _bias_terms_global_natural(y: torch.Tensor, p: Params, cfg: SamVisionConfig, g: int):
    """Bias terms for `fused_global_attention_y` from the raw qkv output's
    q columns in their natural [B, i, j, H, hd] order, with the 1/scale
    prefold riding the rel-pos tables. Returns (A, Bb), each [B, S, H, g]
    in y.dtype."""
    B, S, _ = y.shape
    H, hd, C = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    inv = float(hd**0.5)
    coords = torch.arange(g, device=y.device)
    rel = coords[:, None] - coords[None, :] + (g - 1)  # [g, g]
    RhG = p["rel_pos_h"][rel].float() * inv  # [i, a, hd]
    RwG = p["rel_pos_w"][rel].float() * inv
    q5 = y[:, :, :C].reshape(B, g, g, H, hd).float()
    A = torch.einsum("nijhc,iac->nijha", q5, RhG)
    Bb = torch.einsum("nijhc,jbc->nijhb", q5, RwG)
    return A.reshape(B, S, H, g).to(y.dtype), Bb.reshape(B, S, H, g).to(y.dtype)


def _attn_global_fused(x: torch.Tensor, p: Params, cfg: SamVisionConfig) -> torch.Tensor:
    """Global block body on [B, g, g, C] without the outer LN1 applied:
    x + proj(attn(LN1(x))) with LN1+qkv and proj+residual fused (int8 x
    int8 products when `mlp_w8a8`)."""
    B, g, _, C = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    S = g * g
    xt = x.reshape(B * S, C)
    y = fused_ln_linear(
        xt, p["ln1_scale"], p["ln1_bias"], p["qkv"]["q"], p["qkv"]["scale"], p["qkv_bias"],
        cfg.layer_norm_eps, w8a8=cfg.mlp_w8a8,
    ).reshape(B, S, 3 * C)
    hg = _global_head_group(cfg)
    if hg:
        A, Bb = _bias_terms_global_natural(y, p, cfg, g)
        out = fused_global_attention_y(
            y, A, Bb, num_heads=H, head_dim=hd, window=g, scale=hd**-0.5,
            head_group=hg, exp_bf16=cfg.mlp_w8a8, dots_i8=cfg.attn_dots_i8,
        )  # [B, S, C]
    else:
        out = _global_attention_staged(y, p, cfg, g)
    out = fused_linear(
        out.reshape(B * S, C), p["proj"]["q"], p["proj"]["scale"], p["proj_bias"],
        residual=xt, w8a8=cfg.mlp_w8a8,
    )
    return out.reshape(B, g, g, C)


def _mlp_tail(x: torch.Tensor, p: Params, cfg: SamVisionConfig) -> torch.Tensor:
    """x + MLP(LN2(x)) over [..., C] tokens: `fused_mlp_block` (polynomial
    erf, int8 activations when `mlp_w8a8`) for int8 weights at tile-aligned
    sizes, else the plain chain with the exact-erf GELU."""
    C = x.shape[-1]
    T = x.numel() // C
    if (
        _fused_routes(cfg)
        and is_quantized(p["fc1"])
        and is_quantized(p["fc2"])
        and p["fc1"]["q"].shape[1] % 512 == 0
        and T % 512 == 0
    ):
        out = fused_mlp_block(
            x.reshape(T, C), p["ln2_scale"], p["ln2_bias"],
            p["fc1"]["q"], p["fc1"]["scale"], p["fc1_bias"],
            p["fc2"]["q"], p["fc2"]["scale"], p["fc2_bias"],
            cfg.layer_norm_eps, w8a8=cfg.mlp_w8a8,
        )
        return out.reshape(x.shape)
    y = layer_norm(x, p["ln2_scale"], p["ln2_bias"], cfg.layer_norm_eps)
    y = F.gelu(apply_linear(y, p["fc1"]) + p["fc1_bias"])
    return x + (apply_linear(y, p["fc2"]) + p["fc2_bias"])


def _block(x: torch.Tensor, p: Params, cfg: SamVisionConfig, window: bool) -> torch.Tensor:
    """One transformer block on [B, gh, gw, C]."""
    B, gh, gw, C = x.shape
    if not window and _use_global_fused(p, cfg, gh):
        if _is_packed(p, cfg):
            raise ValueError(
                "packed int8 qkv/proj weights at a global block of the fused int8 route "
                f"(grid {gh}, S % 1024 == 0): the JAX package fails here too, reshaping the "
                "packed qkv output to 3*C (`ullava_tpu/models/sam/image_encoder.py:603`); "
                "pack bf16 weights, or keep int8 weights unpacked")
        return _mlp_tail(_attn_global_fused(x, p, cfg), p, cfg)
    shortcut = x
    x = layer_norm(x, p["ln1_scale"], p["ln1_bias"], cfg.layer_norm_eps)
    if window:
        ws = cfg.window_size
        pad_h, pad_w = (-gh) % ws, (-gw) % ws
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))  # pads AFTER LN1
        Hp, Wp = gh + pad_h, gw + pad_w
        nh, nw = Hp // ws, Wp // ws
        x = x.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = _attn(x.reshape(B * nh * nw, ws, ws, C), p, cfg, ws)
        x = x.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, Hp, Wp, C)[:, :gh, :gw]
    else:
        x = _attn(x, p, cfg, gh)
    return _mlp_tail(shortcut + x, p, cfg)


# ---------------------------------------------------------------------------
# Resident window-major layout: partition once per group into compact
# per-class tensors (full / right / bottom / corner windows, no pad token
# anywhere), run the group's window blocks on them, and restore grid order
# only for the group's closing global block. The block layout's zero-pad
# keys are exact constants (a pad token's qkv input is 0, so its k and v
# are the qkv bias) that `fused_window_attention_rect` takes as per-layer
# tables.
# ---------------------------------------------------------------------------


def _class_geometry(name: str, cfg: SamVisionConfig) -> Tuple[int, int]:
    ws, rem = cfg.window_size, cfg.grid % cfg.window_size
    return {"full": (ws, ws), "right": (ws, rem), "bottom": (rem, ws), "corner": (rem, rem)}[name]


def _partition_resident(x: torch.Tensor, ws: int, pad_full_to: int = 0) -> Dict[str, torch.Tensor]:
    """[B, g, g, C] -> compact window-major class tensors [N, T, C].
    `pad_full_to` zero-pads the full class's token axis to that many rows
    (196 -> 200 for ViT-H): the pad rows are left out as attention keys
    and dropped at `_unpartition_resident`."""
    B, g, _, C = x.shape
    f, rem = divmod(g, ws)
    e = f * ws
    full = x[:, :e, :e].reshape(B, f, ws, f, ws, C).permute(0, 1, 3, 2, 4, 5)
    full = full.reshape(B * f * f, ws * ws, C)
    if pad_full_to > ws * ws:
        full = F.pad(full, (0, 0, 0, pad_full_to - ws * ws))
    out = {"full": full}
    if rem:
        out["right"] = x[:, :e, e:].reshape(B * f, ws * rem, C)
        out["bottom"] = (
            x[:, e:, :e].reshape(B, rem, f, ws, C).permute(0, 2, 1, 3, 4).reshape(B * f, rem * ws, C)
        )
        out["corner"] = x[:, e:, e:].reshape(B, rem * rem, C)
    return out


def _unpartition_resident(cls: Dict[str, torch.Tensor], B: int, g: int, ws: int) -> torch.Tensor:
    """Inverse of `_partition_resident` (drops the full class's pad rows)."""
    C = cls["full"].shape[-1]
    f, rem = divmod(g, ws)
    e = f * ws
    full = cls["full"][:, : ws * ws].reshape(B, f, f, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    full = full.reshape(B, e, e, C)
    if not rem:
        return full
    top = torch.cat([full, cls["right"].reshape(B, e, rem, C)], dim=2)  # [B, e, g, C]
    bottom = cls["bottom"].reshape(B, f, rem, ws, C).permute(0, 2, 1, 3, 4).reshape(B, rem, e, C)
    bot = torch.cat([bottom, cls["corner"].reshape(B, rem, rem, C)], dim=2)  # [B, rem, g, C]
    return torch.cat([top, bot], dim=1)


def _reversed_onehots(idx: torch.Tensor, W: int) -> torch.Tensor:
    """[n, 2] (row, col) positions -> [n, 2W] one-hots in the reversed
    column order of the bias terms: column a' marks row W-1-a'."""
    rev = W - 1 - torch.arange(W)
    return torch.cat([idx[:, 0:1] == rev, idx[:, 1:2] == rev], dim=-1)


@functools.lru_cache(maxsize=None)
def _rect_tables(rows: int, cols: int, W: int, dtype: torch.dtype, device: torch.device):
    """The tables of a rows x cols rectangle that depend on its geometry
    only: the real tokens' one-hots [T, 2W] and the pad positions'
    [P, 2W], in `dtype` on `device`."""
    pos = torch.cartesian_prod(torch.arange(W), torch.arange(W))
    real = (pos[:, 0] < rows) & (pos[:, 1] < cols)
    t = torch.arange(rows * cols)
    oh = _reversed_onehots(torch.stack([t // cols, t % cols], dim=1), W)
    return (oh.to(device=device, dtype=dtype),
            _reversed_onehots(pos[~real], W).to(device=device, dtype=dtype))


def _rect_onehot(rows: int, cols: int, W: int, dtype, device) -> torch.Tensor:
    """[T, 2W] reversed-column one-hots of the real tokens."""
    return _rect_tables(rows, cols, W, dtype, torch.device(device))[0]


def _pad_tables(qkv_bias, rows: int, cols: int, W: int, H: int, hd: int, dtype):
    """The pad keys' tables: the block layout pads with zeros after LN1,
    so a pad token's key and value are the qkv bias slices, and only the
    rel-pos one-hots differ between pad positions. Returns
    ([H, P, hd+2W], [H, hd])."""
    bias = qkv_bias.reshape(3, H, hd).to(dtype)
    oh = _rect_tables(rows, cols, W, dtype, qkv_bias.device)[1]
    P = oh.shape[0]
    pad_k = torch.cat([bias[1][:, None, :].expand(H, P, hd), oh[None].expand(H, P, 2 * W)], dim=-1)
    return pad_k, bias[2].contiguous()


def _ln_qkv_bias_terms(x, p: Params, cfg: SamVisionConfig, geoms):
    """LN1 + qkv of class tensor x [N, T, C] and the bias terms of its
    windows: (y, A, Bb). `geoms` lists the (rows, cols) of equal slices of
    N (one entry, or two for the merged right and bottom classes)."""
    W, H = cfg.window_size, cfg.num_heads
    per = x.shape[0] // len(geoms)
    P = None
    if is_quantized(p["qkv"]):
        ln_qkv = (x, p["ln1_scale"], p["ln1_bias"], p["qkv"]["q"], p["qkv"]["scale"], p["qkv_bias"])
        if "biasw" in p:
            # In the padded layout y keeps the pad rows, the bias terms do not.
            real = geoms[0][0] * geoms[0][1]
            y, P = fused_ln_linear_dual(
                *ln_qkv, p["biasw"]["q"], p["biasw"]["scale"], p["biasw_bias"],
                cfg.layer_norm_eps, w8a8=cfg.mlp_w8a8, rows2=real if x.shape[1] != real else 0,
            )
        else:
            y = fused_ln_linear(*ln_qkv, cfg.layer_norm_eps, w8a8=cfg.mlp_w8a8)
    else:
        h = layer_norm(x, p["ln1_scale"], p["ln1_bias"], cfg.layer_norm_eps)
        y = _lin(cfg, h, p["qkv"]) + p["qkv_bias"]
    terms = []
    for i, (rows, cols) in enumerate(geoms):
        sl = slice(i * per, (i + 1) * per)
        if P is not None:
            terms.append(_assemble_bias_terms(
                P[sl], rows, cols, W, H, pad_rows=x.shape[1] - rows * cols))
        else:
            terms.append(_bias_terms_rect(y[sl], p["rel_pos_h"], p["rel_pos_w"], cfg, rows, cols, W))
    if len(terms) == 1:
        return (y, *terms[0])
    return y, torch.cat([t[0] for t in terms]), torch.cat([t[1] for t in terms])


def _window_attention(y, A, Bb, p: Params, cfg: SamVisionConfig, geoms) -> torch.Tensor:
    """Attention of class windows from their qkv output and bias terms:
    the grid kernel for whole windows, the boundary kernel for real
    rectangles (two geometries in one launch for the merged classes)."""
    W, H, hd = cfg.window_size, cfg.num_heads, cfg.head_dim
    kw = dict(num_heads=H, head_dim=hd, window=W, scale=hd**-0.5)
    if geoms == [(W, W)]:
        return fused_window_attention_grid(
            y, A, Bb, **kw, total_rows=y.shape[1] if y.shape[1] != W * W else 0,
            dots_i8=cfg.attn_dots_i8,
        )
    ohs = [_rect_onehot(rows, cols, W, y.dtype, y.device) for rows, cols in geoms]
    pads = [_pad_tables(p["qkv_bias"], rows, cols, W, H, hd, y.dtype) for rows, cols in geoms]
    if len(geoms) == 1:
        return fused_window_attention_rect(
            y, A, Bb, ohs[0], *pads[0], **kw, dots_i8=cfg.attn_dots_i8, geometry=geoms[0]
        )
    return fused_window_attention_rect(
        y, A, Bb, torch.stack(ohs), torch.stack([k for k, _ in pads]),
        torch.stack([v for _, v in pads]), **kw, dots_i8=cfg.attn_dots_i8, geometry=tuple(geoms),
    )


def _attn_resident(x: torch.Tensor, p: Params, cfg: SamVisionConfig, geoms) -> torch.Tensor:
    """x + proj(attn(LN1(x))) on a compact class tensor [N, T, C] whose
    windows have the geometries `geoms` (see `_ln_qkv_bias_terms`). With
    int8 weights LN1+qkv and proj+residual are the fused int8 functions."""
    y, A, Bb = _ln_qkv_bias_terms(x, p, cfg, geoms)
    out = _window_attention(y, A, Bb, p, cfg, geoms)
    if is_quantized(p["proj"]):
        return fused_linear(
            out, p["proj"]["q"], p["proj"]["scale"], p["proj_bias"], residual=x, w8a8=cfg.mlp_w8a8
        )
    return x + (_lin(cfg, out, p["proj"]) + p["proj_bias"])


def _attn_resident_cls(x, p: Params, cfg: SamVisionConfig, rows: int, cols: int) -> torch.Tensor:
    """Windowed attention and residual on one class tensor [N, T, C]."""
    return _attn_resident(x, p, cfg, [(rows, cols)])


def _merge_edge_classes(xs: Dict[str, torch.Tensor], p: Params) -> bool:
    """Whether the right and bottom classes (both [B*f, ws*rem, C]) go
    through qkv, proj and the MLP as one token stream: with int8 qkv and
    proj, where that halves the launches of the three fused functions."""
    return "right" in xs and is_quantized(p["qkv"]) and is_quantized(p["proj"])


def _attn_resident_edge_pair(xr, xb, p: Params, cfg: SamVisionConfig) -> torch.Tensor:
    """The right and bottom classes merged: one LN1+qkv, one dual-geometry
    attention launch and one proj+residual over [2*N, T, C]; the caller
    splits after the shared MLP."""
    geoms = [_class_geometry("right", cfg), _class_geometry("bottom", cfg)]
    return _attn_resident(torch.cat([xr, xb]), p, cfg, geoms)


def _block_resident(xs: Dict[str, torch.Tensor], p: Params, cfg: SamVisionConfig):
    """One window block on the resident class dict."""
    merged = _merge_edge_classes(xs, p)
    out = {}
    for name, x in xs.items():
        if merged and name in ("right", "bottom"):
            continue
        out[name] = _mlp_tail(_attn_resident_cls(x, p, cfg, *_class_geometry(name, cfg)), p, cfg)
    if merged:
        hm = _mlp_tail(_attn_resident_edge_pair(xs["right"], xs["bottom"], p, cfg), p, cfg)
        Nr = xs["right"].shape[0]
        out["right"], out["bottom"] = hm[:Nr], hm[Nr:]
    return out


def _use_resident(cfg: SamVisionConfig, wparams: Optional[Params] = None) -> bool:
    """"auto" and "resident" both mean resident wherever the grid holds at
    least one whole window; packed weights (`wparams`, a window block's)
    and `attn_kernel="xla"` always take the block layout."""
    if (cfg.window_layout == "block" or not _fused_routes(cfg)
            or (wparams is not None and _is_packed(wparams, cfg))):
        return False
    return cfg.grid // cfg.window_size > 0


@torch.no_grad()
def encode(params: Params, cfg: SamVisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """[B, img, img, 3] (SAM-normalized, padded) -> [B, grid, grid, out_chans]."""
    cfg.validate_grouping()
    B = pixel_values.shape[0]
    g, C, P = cfg.grid, cfg.embed_dim, cfg.patch_size

    x = pixel_values.to(cfg.dtype)
    x = x.reshape(B, g, P, g, P, 3).permute(0, 1, 3, 5, 2, 4).reshape(B, g * g, 3 * P * P)
    x = (apply_linear(x, params["patch_proj"]) + params["patch_bias"]).reshape(B, g, g, C)
    x = x + params["pos_embed"][None]

    per = cfg.group_period - 1
    ws = cfg.window_size
    resident = per > 0 and _use_resident(cfg, params["window_blocks"][0])
    # The padded full-window layout (rows a multiple of 8) goes with the
    # composite bias weights: the dual LN+qkv emits the bias terms at the
    # real row count and the grid kernel leaves the pad rows out as keys.
    pad_full_to = (
        -(-ws * ws // 8) * 8
        if resident and (ws * ws) % 8 and "biasw" in params["window_blocks"][0] else 0
    )
    for gi, gp in enumerate(params["global_blocks"]):
        wps = params["window_blocks"][gi * per:(gi + 1) * per]
        if resident:
            cls = _partition_resident(x, ws, pad_full_to)
            for wp in wps:
                cls = _block_resident(cls, wp, cfg)
            x = _unpartition_resident(cls, B, g, ws)
        else:
            for wp in wps:
                x = _block(x, wp, cfg, window=True)
        x = _block(x, gp, cfg, window=False)

    # Neck: 1x1 conv (matmul) -> LN -> 3x3 conv -> LN, fp32 statistics.
    x = x @ params["neck_conv1"]
    x = layer_norm(x, params["neck_ln1_scale"], params["neck_ln1_bias"], cfg.layer_norm_eps)
    x = F.conv2d(
        x.permute(0, 3, 1, 2), params["neck_conv2"].permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1)
    return layer_norm(x, params["neck_ln2_scale"], params["neck_ln2_bias"], cfg.layer_norm_eps)
