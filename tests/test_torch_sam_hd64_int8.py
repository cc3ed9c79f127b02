"""Parity with the JAX package on the CPU of the SAM kernel forms that
ViT-L's and ViT-B's 64-lane heads reach beside the bf16 scores: the int8
score form (`dots_i8`) of the window kernel (196 rows, and 200 as the
resident layout stores a window) and of the boundary-window kernel (the
merged edges and the corner), the lane-sliced global kernel at head_dim 64
with 4 heads (the JAX head group of ViT-B's 12) and with 2, in both score
and both exponential forms, its int8 pre-pass bit for bit against
`_rq_rows`, and two encoders with heads of 64: int8 towers with composite
bias weights in the resident layout with `attn_dots_i8` off and on, and
fp32 weights packed to 128 lanes a head. The same numpy inputs go through
the JAX function (its Pallas kernels in interpret mode) and the port's
plain version.

Tolerances, as the tests of the hd 80 forms hold them: outputs with int8
scores within 2e-2 of the largest value (`test_torch_dots_i8.py`: both
sides quantize with the same arithmetic, but a value within fp32
reassociation of a rounding tie may take the neighbouring code, which
moves a score by about 1/127 of one term); bf16 scores within 1e-2 of each
row's largest value (`test_torch_window_geometry.py`); the global kernel
with fp32 exponentials 3e-4 and with bf16 ones 2e-2
(`test_torch_sam_int8.py`); the fp32 packed encoder 5e-4
(`test_torch_sam_variants.py`); the pre-pass exact. The four-block int8
encoder takes limits of its own (`ENC_I8_MAX`, `ENC_I8_MEDIAN`, measured
beside its hd 80 twin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import quant as jquant
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import sam_attention

I8 = 2e-2
HD, W = 64, 14
SCALE = HD**-0.5


def setup_module():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """The same bf16 values on both sides: torch's bf16 copy of a numpy
    array and JAX's copy of it."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


def _row_rel_err(got, ref):
    got, ref = _f32(got), _f32(ref)
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float((np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max())


def _rel_to_max(got, ref):
    got, ref = _f32(got), _f32(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _window_inputs(rng, N, S, H):
    """y [N, S, 3*H*64] and the bias terms [N, S, H*14] at the encoder's
    size: q.rel_pos with an unscaled q, pre-scaled by 1/scale."""
    y = rng.standard_normal((N, S, 3 * H * HD))
    a, b = (2.0 / SCALE * rng.standard_normal((N, S, H * W)) for _ in range(2))
    return _bf16(y), _bf16(a), _bf16(b)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("H", [4, 2])
def test_global_y_quant_i8_hd64_bit_equal_to_jax_rq_rows(H, dtype):
    """K11's pre-pass at hd 64: each head's q and k rows and each row's
    [A | B] against `_rq_rows` (`ullava_tpu/ops/sam_attention.py:552`):
    codes and scales; a code row at hd 64 is its 64 codes, in bf16."""
    rng = np.random.default_rng(30)
    B, S, g = 2, 64, 8
    y = rng.standard_normal((B, S, 3 * H * HD)).astype(np.float32)
    a, b = (20.0 * rng.standard_normal((B, S, H, g)).astype(np.float32) for _ in range(2))
    a[0, 0], b[0, 0] = 0.0, 0.0  # an all-zero [A | B] row: the 1e-12 floor
    y[1, 3, :HD] = 0.0  # an all-zero q row of head 0
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jy, ja, jb = (jnp.asarray(t, jdt) for t in (y, a, b))
    ty, ta, tb = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(tdt) for t in (jy, ja, jb))
    codes, scales, ac, bc, abss = sam_attention.global_y_quant_i8_plain(ty, ta, tb, H, HD)
    assert codes.shape == (2, B, H, S, HD) and codes.dtype == torch.bfloat16
    for sec in range(2):
        for h in range(H):
            q, s = jsam._rq_rows(jy[:, :, (sec * H + h) * HD:(sec * H + h + 1) * HD])
            np.testing.assert_array_equal(codes[sec, :, h, :, :HD].float().numpy(),
                                          np.asarray(q, np.float32))
            np.testing.assert_array_equal(scales[sec, :, h].numpy(), np.asarray(s)[..., 0])
    assert not codes[..., HD:].any()
    q, s = jsam._rq_rows(jnp.concatenate([ja, jb], axis=-1))
    np.testing.assert_array_equal(ac.float().numpy(), np.asarray(q[..., :g], np.float32))
    np.testing.assert_array_equal(bc.float().numpy(), np.asarray(q[..., g:], np.float32))
    np.testing.assert_array_equal(abss.numpy(), np.asarray(s)[..., 0].transpose(0, 2, 1))


@pytest.mark.parametrize("total_rows", [0, 200], ids=["rows_196", "rows_200"])
def test_window_grid_dots_i8_hd64_matches_jax(total_rows):
    """K3's int8 score form at W 14, hd 64: two whole windows of 196 rows,
    or stored as 200 rows whose 4 tail rows are left out as keys (real
    rows compared; the tail rows finite and reaching no real row)."""
    H, S = 2, total_rows or W * W
    y, a, b = _window_inputs(np.random.default_rng(31), 2, S, H)
    kw = dict(num_heads=H, head_dim=HD, window=W, scale=SCALE)
    ref = jsam.fused_window_attention_grid(y[1], a[1], b[1], **kw, dots_i8=True,
                                           total_rows=total_rows, interpret=True)
    got = sam_attention.fused_window_attention_grid(y[0], a[0], b[0], **kw,
                                                    total_rows=total_rows, dots_i8=True)
    assert got.shape == (2, S, H * HD) and bool(torch.isfinite(got).all())
    assert _rel_to_max(got[:, :W * W], _f32(ref)[:, :W * W]) <= I8
    # Another function than the bf16-score form, close to it.
    bf16 = sam_attention.fused_window_attention_grid(y[0], a[0], b[0], **kw,
                                                     total_rows=total_rows)
    assert 0 < (bf16 - got)[:, :W * W].float().abs().max().item() < 5e-2
    if total_rows:
        y2 = y[0].clone()
        y2[:, W * W:] += 5.0
        again = sam_attention.fused_window_attention_grid(y2, a[0], b[0], **kw,
                                                          total_rows=total_rows, dots_i8=True)
        assert torch.equal(again[:, :W * W], got[:, :W * W])


_RECT = {"edge_pair": [(14, 8), (8, 14)], "corner": [(8, 8)]}


@pytest.mark.parametrize("cls", list(_RECT))
def test_window_rect_dots_i8_hd64_matches_jax(cls):
    """K14's int8 score form at hd 64 on the classes the resident layout
    sends it with composite bias weights: the two edges in one
    dual-geometry call and the corner, pad keys from the encoder's tables
    (equal on both sides)."""
    geoms, H = _RECT[cls], 2
    rng = np.random.default_rng(32)
    T = geoms[0][0] * geoms[0][1]
    y, a, b = _window_inputs(rng, len(geoms), T, H)
    qb_t, qb_j = _bf16(0.5 * rng.standard_normal(3 * H * HD))
    port, theirs = [], []
    for rows, cols in geoms:
        port.append((image_encoder._rect_onehot(rows, cols, W, torch.bfloat16, "cpu"),
                     *image_encoder._pad_tables(qb_t, rows, cols, W, H, HD, torch.bfloat16)))
        theirs.append((jie._rect_onehot(rows, cols, W, jnp.bfloat16),
                       *jie._pad_tables(qb_j, rows, cols, W, H, HD, jnp.bfloat16)))
    if len(geoms) == 1:
        tables, jtables, geometry = port[0], theirs[0], geoms[0]
    else:
        tables = tuple(torch.stack([t[i] for t in port]) for i in range(3))
        jtables = tuple(jnp.stack([t[i] for t in theirs]) for i in range(3))
        geometry = tuple(geoms)
    for mine, jax_t in zip(tables, jtables):
        np.testing.assert_array_equal(_f32(mine), _f32(jax_t))
    assert tables[1].shape[-1] == HD + 2 * W  # [.., H, P, 92]
    kw = dict(num_heads=H, head_dim=HD, window=W, scale=SCALE)
    ref = jsam.fused_window_attention_rect(y[1], a[1], b[1], *jtables, **kw, dots_i8=True,
                                           interpret=True)
    got = sam_attention.fused_window_attention_rect(y[0], a[0], b[0], *tables, **kw,
                                                    dots_i8=True, geometry=geometry)
    assert got.shape == (len(geoms), T, H * HD)
    assert _rel_to_max(got, ref) <= I8
    bf16 = sam_attention.fused_window_attention_rect(y[0], a[0], b[0], *tables, **kw,
                                                     geometry=geometry)
    assert _row_rel_err(bf16, jsam.fused_window_attention_rect(
        y[1], a[1], b[1], *jtables, **kw, interpret=True)) <= 1e-2
    assert (bf16 - got).float().abs().max().item() > 0


_GLOBAL_MODES = {"fp32": (False, False, 3e-4), "exp_bf16": (True, False, I8),
                 "dots_i8": (False, True, I8), "dots_i8_exp_bf16": (True, True, I8)}


@pytest.mark.parametrize("mode", list(_GLOBAL_MODES))
@pytest.mark.parametrize("H", [4, 2])
def test_global_y_hd64_matches_jax(H, mode):
    """K11 at hd 64 on a 32 x 32 grid (S = 1024): 4 heads take JAX's head
    group 4, ViT-B's for its 12 heads, 2 heads head group 2; each score
    form with each exponential form. JAX runs 128-row tiles, the plain
    version one softmax over all keys."""
    exp_bf16, dots_i8, tol = _GLOBAL_MODES[mode]
    g = 32
    rng = np.random.default_rng(33)
    S, C = g * g, H * HD
    y = rng.standard_normal((1, S, 3 * C)).astype(np.float32)
    a, b = ((0.4 / SCALE * rng.standard_normal((1, S, H, g))).astype(np.float32)
            for _ in range(2))
    kw = dict(num_heads=H, head_dim=HD, window=g, scale=SCALE, exp_bf16=exp_bf16,
              dots_i8=dots_i8)
    hg = image_encoder._global_head_group(image_encoder.SamVisionConfig(
        embed_dim=C, num_heads=H))
    assert hg == H
    ref = jsam.fused_global_attention_y(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), **kw,
                                        head_group=hg, block_q=128, block_k=128, interpret=True)
    got = sam_attention.fused_global_attention_y(_t(y), _t(a), _t(b), **kw, head_group=hg)
    assert got.shape == (1, S, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    # The bias terms matter at this tolerance, and their order too.
    swapped = sam_attention.fused_global_attention_y(_t(y), _t(b), _t(a), **kw)
    assert (swapped - got).abs().max() > 0.1


# embed 256 with 4 heads of 64, 4 blocks; img 512 at patch 16 is a 32 x 32
# grid (S = 1024): JAX's fused global route (`_use_global_fused`), the
# fused MLPs (F 1024, 1024 tokens) and, at window 14, all four window
# classes of the resident layout (2 x 2 full, 14 x 4, 4 x 14, 4 x 4).
_ENC = dict(img_size=512, patch_size=16, embed_dim=256, depth=4, num_heads=4, out_chans=16,
            window_size=14, global_attn_indexes=(1, 3))
# The int8 encoder's limits, in units of the largest embedding value. Four
# W8A8 blocks carry the two frameworks' rounding-tie flips (an int8
# activation code one step apart where fp32 sums differ in order) from
# block to block, so they exceed the one- and two-block limits of
# `test_torch_dots_i8.py` (2e-2 of the largest value, the bulk 1e-3): this
# encoder measured up to 3.1e-2 and a median of 2.3e-3 at hd 64, and its
# hd 80 twin (embed 320, the forms earlier slices ported) 2.0e-2 and
# 1.9e-3, on one CPU thread.
ENC_I8_MAX, ENC_I8_MEDIAN = 4e-2, 3e-3


def _encoder_cfgs(**kw):
    base = {**_ENC, **{k: kw.pop(k) for k in ("embed_dim",) if k in kw}}
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel="pallas_interpret", **kw)
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32, **kw)
    return jcfg, cfg


def _image(seed):
    return np.random.default_rng(seed).standard_normal((1, 512, 512, 3)).astype(np.float32)


@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80_twin"])
def test_encode_int8_resident_dots_i8_matches_jax(hd):
    """The encoder with heads of 64 (and its twin with ViT-H's 80), int8
    towers (`mlp_w8a8`) and composite bias weights in the resident layout,
    `attn_dots_i8` off and on, against the JAX encoder with the same knobs
    (`ENC_I8_MAX` of the largest embedding value, the median within
    `ENC_I8_MEDIAN` of it). The global blocks take the fused route, at hd
    64 with K11 at head group 4 on both sides, at hd 80 with the
    transpose-staged global kernel (320 lanes hold no 128-aligned head
    group)."""
    jcfg, cfg = _encoder_cfgs(embed_dim=4 * hd, mlp_w8a8=True, window_layout="resident")
    assert cfg.head_dim == hd
    assert image_encoder._global_head_group(cfg) == jie._global_head_group(jcfg) == (
        4 if hd == 64 else 0)
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, 34, std=0.1))
    jq = jie.precompute_window_bias_weights(
        jquant.quantize_tree(jp, jquant.SAM_ENCODER_QUANT_KEYS), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    assert image_encoder._use_global_fused(params["global_blocks"][0], cfg, cfg.grid)
    assert image_encoder._use_resident(cfg, params["window_blocks"][0])
    img = _image(34)
    out = {}
    for dots_i8 in (False, True):
        jc = dataclasses.replace(jcfg, attn_dots_i8=dots_i8)
        c = dataclasses.replace(cfg, attn_dots_i8=dots_i8)
        ref = np.asarray(jax.jit(jie.encode, static_argnums=1)(jq, jc, jnp.asarray(img)))
        got = image_encoder.encode(params, c, _t(img)).numpy()
        assert got.shape == (1, 32, 32, 16)
        err, top = np.abs(got - ref), np.abs(ref).max()
        assert err.max() <= ENC_I8_MAX * top, (dots_i8, err.max(), top)
        assert np.median(err) <= ENC_I8_MEDIAN * top, (dots_i8, np.median(err), top)
        out[dots_i8] = (got, np.median(err))
    # The knob changes the function: more than the bulk of either match.
    assert np.abs(out[True][0] - out[False][0]).max() > out[True][1]


def test_encode_hd64_packed_matches_jax_and_unpacked():
    """The hd 64 encoder's fp32 weights packed to 128 lanes a head (the
    card's hp; the block layout, the packed window and global kernels)
    against JAX `encode` of JAX's packed weights within 5e-4, and against
    the port's unpacked encode of the same weights within 1e-4: the pad
    lanes add exact zeros."""
    jcfg, cfg = _encoder_cfgs()
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, 35, std=0.2))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    packed = image_encoder.pack_sam_attention(params, cfg, head_pad=128)
    assert image_encoder._is_packed(packed["global_blocks"][0], cfg)
    assert packed["window_blocks"][0]["qkv"].shape == (256, 3 * 4 * 128)
    img = _image(35)
    ref = jax.jit(jie.encode, static_argnums=1)(
        jie.pack_sam_attention(jp, jcfg, head_pad=128), jcfg, jnp.asarray(img))
    got = image_encoder.encode(packed, cfg, _t(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4)
    unpacked = image_encoder.encode(params, dataclasses.replace(cfg, window_layout="block"),
                                    _t(img))
    # The projections contract 4 x 128 lanes instead of 256: another
    # summation order, fp32 noise over four blocks.
    np.testing.assert_allclose(got.numpy(), unpacked.numpy(), atol=1e-4, rtol=0)
