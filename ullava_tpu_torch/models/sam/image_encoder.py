"""SAM ViTDet image encoder, block window layout (counterpart of
`ullava_tpu/models/sam/image_encoder.py:39-254,328-383,454-700,
1054-1113`).

ViT backbone with 14x14 window attention and global blocks closing each
group, decomposed relative position bias, conv neck to 256 channels; NHWC
throughout. Each window block pads the grid after LN1 (64 -> 70 for
ViT-H: pad tokens carry qkv = qkv_bias and take part as keys, exactly as
the reference's zero pad), partitions into windows, attends, merges and
crops. Attention always goes through the ported kernels' wrappers:
`fused_window_attention_grid` for sizes up to 16 and
`fused_global_attention` above (the JAX dispatch at `_attn`).

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
package chooses). The window blocks keep plain LN and weight-only
`apply_linear` around the window kernel. There is no device gate: on
CUDA tensors the wrappers launch their kernels, on CPU tensors they take
their plain versions.

Parameters: `window_blocks` (list of G*(P-1) per-block dicts, group-major)
and `global_blocks` (list of G), where the depth factors into G groups of
P layers with a global block closing each group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal
from ullava_tpu_torch.ops.mlp_kernel import fused_linear, fused_ln_linear, fused_mlp_block
from ullava_tpu_torch.ops.norms import layer_norm
from ullava_tpu_torch.ops.quant import apply_linear, apply_linear_a8, is_quantized
from ullava_tpu_torch.ops.sam_attention import (
    decomposed_bias_terms,
    fused_global_attention,
    fused_global_attention_y,
    fused_window_attention_grid,
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
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # Run the fused kernels' products int8 x int8 with per-row dynamic
    # activation quantization (the MLP's, and the global blocks' LN1+qkv
    # and proj). Off: weight-only int8 (plain versions only on the card).
    mlp_w8a8: bool = False
    # The same int8 activations for the unfused qkv/proj projections of
    # `_attn` (`apply_linear_a8` in place of `apply_linear`).
    attn_w8a8: bool = False
    # int8 x int8 attention score products inside the kernels: not ported.
    attn_dots_i8: bool = False
    # Window-block token layout. Only "block" (pad, partition, attend,
    # merge, crop in every window block) is ported, and it is the default
    # until the resident layout lands; the JAX default "auto" means
    # "resident" on the TPU. "resident" and "auto" raise.
    window_layout: str = "block"

    def __post_init__(self) -> None:
        if self.window_layout in ("resident", "auto"):
            raise NotImplementedError(
                f"window_layout={self.window_layout!r}: the resident window layout is the "
                "next part of the encoder to be ported; use 'block'"
            )
        if self.window_layout != "block":
            raise ValueError(f"unknown window_layout {self.window_layout!r}")
        if self.attn_dots_i8:
            raise NotImplementedError(
                "attn_dots_i8: the int8 score-dot forms of the attention kernels are not "
                "ported yet (queued with the resident layout)"
            )

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
    y [N, S, 3C]: P = q @ blockdiag(rel_pos * sqrt(hd)) over r = 0..2W-2,
    then A[s, h, a'] = P[s, h, i(s) + a'] (the reversed-column order the
    kernel takes). Returns (A, Bb), each [N, S, H*W] in y.dtype."""
    H, hd, C = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    W = size
    R = 2 * W - 1
    N, T, _ = y.shape
    inv = float(hd**0.5)  # 1/scale, folded into the weights

    def block_diag(rel):  # [R, hd] -> [C, H*R]
        blk = (rel.float() * inv).to(y.dtype).T
        return torch.block_diag(*([blk] * H))

    q = y[:, :, :C]
    Ph = (q @ block_diag(rel_pos_h)).reshape(N, W, W, H, R)
    Pw = (q @ block_diag(rel_pos_w)).reshape(N, W, W, H, R)
    A = torch.cat([Ph[:, i:i + 1, :, :, i:i + W] for i in range(W)], dim=1)
    Bb = torch.cat([Pw[:, :, j:j + 1, :, j:j + W] for j in range(W)], dim=2)
    return A.reshape(N, T, H * W), Bb.reshape(N, T, H * W)


def _lin(cfg: SamVisionConfig, x: torch.Tensor, w) -> torch.Tensor:
    if cfg.attn_w8a8 and is_quantized(w):
        return apply_linear_a8(x, w)
    return apply_linear(x, w)


def _attn(x: torch.Tensor, p: Params, cfg: SamVisionConfig, size: int) -> torch.Tensor:
    """Self-attention over an NHWC token grid [B, size, size, C]."""
    B = x.shape[0]
    C, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    S = size * size
    y = _lin(cfg, x.reshape(B, S, C), p["qkv"]) + p["qkv_bias"]  # [B, S, 3C]
    if size <= 16:
        A, Bb = _bias_terms_grid(y, p["rel_pos_h"], p["rel_pos_w"], cfg, size)
        out = fused_window_attention_grid(
            y, A, Bb, num_heads=H, head_dim=hd, window=size, scale=hd**-0.5
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
        size > 16  # global grid only; window sizes use the grid kernel
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
        is_quantized(p["fc1"])
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
    for gi, gp in enumerate(params["global_blocks"]):
        for wp in params["window_blocks"][gi * per:(gi + 1) * per]:
            x = _block(x, wp, cfg, window=True)
        x = _block(x, gp, cfg, window=False)

    # Neck: 1x1 conv (matmul) -> LN -> 3x3 conv -> LN, fp32 statistics.
    x = x @ params["neck_conv1"]
    x = layer_norm(x, params["neck_ln1_scale"], params["neck_ln1_bias"], cfg.layer_norm_eps)
    x = F.conv2d(
        x.permute(0, 3, 1, 2), params["neck_conv2"].permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1)
    return layer_norm(x, params["neck_ln2_scale"], params["neck_ln2_bias"], cfg.layer_norm_eps)
