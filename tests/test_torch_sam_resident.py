"""Parity of the port's resident window layout of the SAM encoder with the
JAX package on the CPU: the same numpy inputs go through the JAX function
(its Pallas kernels in interpret mode) and the port's plain version, for
the partition, the composite bias weights, each fused function the layout
adds, the tables, the encoder as a whole (fp32 weights, and int8 weights
with composite bias weights carried across by the bridge) and `evaluate`.

Tolerances. fp32 paths are held to summation-order noise (stated where
used). An int8 activation within fp32 reassociation of .5 may round one
step apart between the two frameworks: int8 values the tests can see are
held to >= 99.9% exact and the rest within 1, and W8A8 outputs to `FLIP` =
2e-3 of the largest output value with a median error of 1e-5 of it, as in
`test_torch_sam_int8.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_int8_close, random_params, res_batch
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import mlp_kernel as jmlp
from ullava_tpu.ops import quant as jquant
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import mlp_kernel, quant, sam_attention

FLIP = 2e-3


def setup_module():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_w8a8(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, top = np.abs(got - ref), np.abs(ref).max()
    assert err.max() <= FLIP * top, (err.max(), top)
    assert np.median(err) <= 1e-5 * top, (np.median(err), top)


@pytest.mark.parametrize("pad", [False, True], ids=["compact", "padded"])
@pytest.mark.parametrize("g,ws", [(7, 3), (4, 2), (8, 3)])
def test_partition_resident_round_trip_and_matches_jax(g, ws, pad):
    """Exact: the partition only moves values. Grid 7 / window 3 has all
    four classes (rem 1), 4 / 2 the full class only, 8 / 3 rem 2."""
    x = np.random.default_rng(0).standard_normal((2, g, g, 5)).astype(np.float32)
    pad_to = -(-ws * ws // 8) * 8 if pad else 0
    cls = image_encoder._partition_resident(_t(x), ws, pad_to)
    ref = jie._partition_resident(jnp.asarray(x), ws, pad_to)
    assert set(cls) == set(ref) == ({"full", "right", "bottom", "corner"} if g % ws else {"full"})
    for name, t in cls.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[name]))
    f = g // ws
    assert cls["full"].shape == (2 * f * f, pad_to or ws * ws, 5)
    if pad:
        assert not cls["full"][:, ws * ws:].any()
        # What a block writes into the pad rows is dropped.
        cls["full"][:, ws * ws:] = 7.0
    back = image_encoder._unpartition_resident(cls, 2, g, ws)
    np.testing.assert_array_equal(back.numpy(), x)


def _tiny_cfgs(**kw):
    """Grid 4, window 3: one full (3x3), one right (3x1), one bottom (1x3)
    and one corner (1x1) window an image."""
    base = dict(window_size=3, global_attn_indexes=(1, 3))
    base.update(kw)
    jcfg = jie.SamVisionConfig.tiny(**base, attn_kernel="pallas_interpret",
                                    window_layout="resident")
    return jcfg, image_encoder.SamVisionConfig.tiny(**base, window_layout="resident")


def _quantized_with_composite(jcfg, seed):
    """A JAX encoder tree with int8 weights and composite bias weights, and
    the same carried across by the bridge."""
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, seed))
    jq = jquant.quantize_tree(jparams, jquant.SAM_ENCODER_QUANT_KEYS)
    jq = jie.precompute_window_bias_weights(jq, jcfg)
    return jq, params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")


def test_precompute_window_bias_weights_matches_jax_and_the_bridge_carries_them():
    """The composite is an fp32 product on both sides: `biasw` int8 >= 99.9%
    exact and the rest within 1, scales and `biasw_bias` rtol 1e-5."""
    jcfg, cfg = _tiny_cfgs()
    jq, bridged = _quantized_with_composite(jcfg, seed=1)
    H, R, C = cfg.num_heads, 2 * cfg.window_size - 1, cfg.embed_dim
    blocks = bridged["window_blocks"]
    assert len(blocks) == 2 and blocks[0]["biasw"]["q"].shape == (C, 2 * H * R)
    assert blocks[0]["biasw"]["q"].dtype == torch.int8
    assert blocks[0]["biasw"]["q"].stride() == (1, C)  # column-major like every int8 leaf
    assert blocks[0]["biasw_bias"].dtype == torch.float32
    assert blocks[0]["biasw_bias"].shape == (2 * H * R,)
    # The port's own preparation from the same int8 weights.
    bare = [{k: v for k, v in b.items() if not k.startswith("biasw")} for b in blocks]
    mine = image_encoder.precompute_window_bias_weights({**bridged, "window_blocks": bare}, cfg)
    assert "biasw" not in bare[0] and mine["global_blocks"] is bridged["global_blocks"]
    for i, blk in enumerate(mine["window_blocks"]):
        assert_int8_close(blk["biasw"]["q"].numpy(), jq["window_blocks"]["biasw"]["q"][i])
        np.testing.assert_allclose(blk["biasw"]["scale"].numpy(),
                                   np.asarray(jq["window_blocks"]["biasw"]["scale"][i]), rtol=1e-5)
        np.testing.assert_allclose(blk["biasw_bias"].numpy(),
                                   np.asarray(jq["window_blocks"]["biasw_bias"][i]),
                                   rtol=1e-5, atol=1e-7)
        assert blk["biasw"]["q"].stride() == (1, C)


@pytest.mark.parametrize("rows2", [0, 9], ids=["all_rows", "rows2"])
@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
def test_fused_ln_linear_dual_matches_jax(w8a8, rows2):
    """Both products share the LN'd (and quantized) rows; `rows2` keeps the
    leading 9 of every 16 rows of the second output."""
    rng = np.random.default_rng(2)
    N, T, C, F, F2 = 3, 16, 64, 48, 40
    x = (2.0 * rng.standard_normal((N, T, C)) + 0.3).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w1, w2 = (jquant.quantize_int8(jnp.asarray(0.1 * rng.standard_normal((C, n)), jnp.float32))
              for n in (F, F2))
    b1, b2 = ((0.5 * rng.standard_normal(n)).astype(np.float32) for n in (F, F2))
    ref_y, ref_p = jmlp.fused_ln_linear_dual(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), w1["q"], w1["scale"], jnp.asarray(b1),
        w2["q"], w2["scale"], jnp.asarray(b2), 1e-6, w8a8=w8a8, rows2=rows2, interpret=True)
    args = (_t(g), _t(b), quant.column_major(_t(w1["q"])), _t(w1["scale"]), _t(b1),
            quant.column_major(_t(w2["q"])), _t(w2["scale"]), _t(b2), 1e-6)
    y, p = mlp_kernel.fused_ln_linear_dual(_t(x), *args, w8a8=w8a8, rows2=rows2)
    assert y.shape == (N, T, F) and p.shape == (N, rows2 or T, F2)
    if w8a8:
        _close_w8a8(y, ref_y)
        _close_w8a8(p, ref_p)
        # The first output is `fused_ln_linear`'s, bit for bit.
        assert torch.equal(y, mlp_kernel.fused_ln_linear(_t(x), *args[:5], 1e-6))
        parts = mlp_kernel._ln_linear_dual_parts_plain(_t(x), *args, True, rows2 or T)
        assert parts[2].shape == (N * T, C) and parts[2].dtype == torch.int8
    else:  # fp32 operands on both sides: summation order only
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=2e-5, rtol=2e-5)
    # The 2-D form is the same rows with the window axis dropped.
    y2, p2 = mlp_kernel.fused_ln_linear_dual(_t(x)[0], *args, w8a8=w8a8, rows2=rows2)
    assert torch.equal(y2, y[0]) and torch.equal(p2, p[0])


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
def test_fused_ln_linear_dual_ragged_tiles_match_jax(w8a8):
    """Widths that leave both products a ragged last 128-column tile of
    the card kernel (F 136, F2 200), and rows2 < T with T not a multiple
    of its 128-row tile: the plain version the kernel is held to, held to
    the JAX kernel."""
    rng = np.random.default_rng(3)
    N, T, C, F, F2, rows2 = 3, 24, 64, 136, 200, 17
    x = (2.0 * rng.standard_normal((N, T, C)) + 0.3).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w1, w2 = (jquant.quantize_int8(jnp.asarray(0.1 * rng.standard_normal((C, n)), jnp.float32))
              for n in (F, F2))
    b1, b2 = ((0.5 * rng.standard_normal(n)).astype(np.float32) for n in (F, F2))
    ref_y, ref_p = jmlp.fused_ln_linear_dual(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), w1["q"], w1["scale"], jnp.asarray(b1),
        w2["q"], w2["scale"], jnp.asarray(b2), 1e-6, w8a8=w8a8, rows2=rows2, interpret=True)
    args = (_t(g), _t(b), quant.column_major(_t(w1["q"])), _t(w1["scale"]), _t(b1),
            quant.column_major(_t(w2["q"])), _t(w2["scale"]), _t(b2), 1e-6)
    y, p = mlp_kernel.fused_ln_linear_dual(_t(x), *args, w8a8=w8a8, rows2=rows2)
    assert y.shape == (N, T, F) and p.shape == (N, rows2, F2)
    if w8a8:
        _close_w8a8(y, ref_y)
        _close_w8a8(p, ref_p)
    else:
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=2e-5, rtol=2e-5)
    # The kept rows are the leading rows2 of every T of the untrimmed product.
    _, p_all = mlp_kernel.fused_ln_linear_dual(_t(x), *args, w8a8=w8a8, rows2=T)
    assert torch.equal(p, p_all[:, :rows2])


def _window_inputs(rng, N, T, H, hd, W):
    y = rng.standard_normal((N, T, 3 * H * hd)).astype(np.float32)
    inv = hd**0.5
    a, b = ((0.4 * inv * rng.standard_normal((N, T, H * W))).astype(np.float32) for _ in range(2))
    return y, a, b, dict(num_heads=H, head_dim=hd, window=W, scale=hd**-0.5)


def test_fused_window_attention_grid_total_rows_matches_jax():
    """Windows of 9 tokens stored as 16 rows: the 7 tail rows are left out
    as keys. Real query rows are compared (3e-4: fp32 summation order); the
    tail rows are finite and change nothing when their content changes."""
    rng = np.random.default_rng(3)
    y, a, b, kw = _window_inputs(rng, 4, 16, 2, 16, 3)
    ref = jsam.fused_window_attention_grid(
        jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), **kw, total_rows=16, interpret=True)
    got = sam_attention.fused_window_attention_grid(_t(y), _t(a), _t(b), **kw, total_rows=16)
    assert got.shape == (4, 16, 32) and torch.isfinite(got).all()
    np.testing.assert_allclose(got[:, :9].numpy(), np.asarray(ref)[:, :9], atol=3e-4, rtol=3e-4)
    y2, a2 = y.copy(), a.copy()
    y2[:, 9:] += 5.0
    a2[:, 9:] -= 3.0
    again = sam_attention.fused_window_attention_grid(_t(y2), _t(a2), _t(b), **kw, total_rows=16)
    assert torch.equal(again[:, :9], got[:, :9])
    # The compact call on the real rows alone is the same attention.
    compact = sam_attention.fused_window_attention_grid(
        _t(y[:, :9]), _t(a[:, :9]), _t(b[:, :9]), **kw)
    np.testing.assert_allclose(compact.numpy(), got[:, :9].numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        sam_attention.fused_window_attention_grid(_t(y), _t(a), _t(b), **kw)  # 16 rows, no total_rows
    with pytest.raises(ValueError):
        sam_attention.fused_window_attention_grid(
            _t(y[:, :8]), _t(a[:, :8]), _t(b[:, :8]), **kw, total_rows=8)


_RECT = {"right": [(4, 2)], "bottom": [(2, 4)], "corner": [(2, 2)], "dual": [(4, 2), (2, 4)]}


def _rect_tables(geoms, qkv_bias, W, H, hd, side):
    """The JAX package's tables (`side` "jax") or the port's for each
    geometry; stacked with a leading halves axis when there are two."""
    per = []
    for rows, cols in geoms:
        if side == "jax":
            oh = jie._rect_onehot(rows, cols, W, jnp.float32)
            pk, pv = jie._pad_tables(jnp.asarray(qkv_bias), rows, cols, W, H, hd, jnp.float32)
        else:
            oh = image_encoder._rect_onehot(rows, cols, W, torch.float32, "cpu")
            pk, pv = image_encoder._pad_tables(_t(qkv_bias), rows, cols, W, H, hd, torch.float32)
        per.append((oh, pk, pv))
    if len(per) == 1:
        return per[0]
    stack = jnp.stack if side == "jax" else torch.stack
    return tuple(stack([t[i] for t in per]) for i in range(3))


@pytest.mark.parametrize("dots_i8", [False, True], ids=["fp32_scores", "dots_i8"])
@pytest.mark.parametrize("cls", list(_RECT))
def test_fused_window_attention_rect_matches_jax(cls, dots_i8):
    """Boundary windows of a logical 4 x 4 window with their pad keys from
    the tables, one geometry or the right and bottom classes in one call.
    fp32 scores: 3e-4 (summation order). `dots_i8` quantizes q, k and the
    bias terms per row on both sides (same function): an int8 step that
    flips moves a score by about 1/127 of one term, 2e-2 as for the other
    int8-score forms."""
    rng = np.random.default_rng(4)
    H, hd, W = 2, 16, 4
    geoms = _RECT[cls]
    T = geoms[0][0] * geoms[0][1]
    N = 4
    y, a, b, kw = _window_inputs(rng, N, T, H, hd, W)
    qkv_bias = (0.5 * rng.standard_normal(3 * H * hd)).astype(np.float32)
    joh, jpk, jpv = _rect_tables(geoms, qkv_bias, W, H, hd, "jax")
    oh, pk, pv = _rect_tables(geoms, qkv_bias, W, H, hd, "torch")
    for mine, theirs in ((oh, joh), (pk, jpk), (pv, jpv)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    ref = jsam.fused_window_attention_rect(
        jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), joh, jpk, jpv, **kw, dots_i8=dots_i8,
        interpret=True)
    geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
    got = sam_attention.fused_window_attention_rect(
        _t(y), _t(a), _t(b), oh, pk, pv, **kw, dots_i8=dots_i8, geometry=geometry)
    assert got.shape == (N, T, H * hd)
    tol = 2e-2 if dots_i8 else 3e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    # `geometry` is optional on the CPU, and one that contradicts the tables is refused.
    bare = sam_attention.fused_window_attention_rect(_t(y), _t(a), _t(b), oh, pk, pv, **kw,
                                                     dots_i8=dots_i8)
    assert torch.equal(bare, got)
    wrong = tuple(g[::-1] for g in geoms) if len(geoms) == 2 else geoms[0][::-1]
    if wrong != geometry:
        with pytest.raises(ValueError, match="one-hot"):
            sam_attention.fused_window_attention_rect(
                _t(y), _t(a), _t(b), oh, pk, pv, **kw, geometry=wrong)
    if not dots_i8:
        # The pad keys take part: without their value the output moves.
        other = sam_attention.fused_window_attention_rect(
            _t(y), _t(a), _t(b), oh, pk, torch.zeros_like(pv), **kw)
        assert (other - got).abs().max() > 1e-2


def test_rect_attention_is_the_padded_window_attention():
    """The function the tables rebuild: scatter a 3 x 2 rectangle into a
    zero-padded 4 x 4 window whose pad rows carry qkv = qkv_bias, run the
    whole-window attention, and read the real rows back (1e-5: the same
    fp32 terms in another order)."""
    rng = np.random.default_rng(5)
    H, hd, W, rows, cols = 2, 16, 4, 3, 2
    N, T = 3, rows * cols
    y, _, _, kw = _window_inputs(rng, N, T, H, hd, W)
    qkv_bias = (0.5 * rng.standard_normal(3 * H * hd)).astype(np.float32)
    cfg = image_encoder.SamVisionConfig.tiny(embed_dim=H * hd, num_heads=H, window_size=W)
    rel_h, rel_w = (_t((0.3 * rng.standard_normal((2 * W - 1, hd))).astype(np.float32))
                    for _ in range(2))
    a, b = image_encoder._bias_terms_rect(_t(y), rel_h, rel_w, cfg, rows, cols, W)
    oh = image_encoder._rect_onehot(rows, cols, W, torch.float32, "cpu")
    pk, pv = image_encoder._pad_tables(_t(qkv_bias), rows, cols, W, H, hd, torch.float32)
    got = sam_attention.fused_window_attention_rect(_t(y), a, b, oh, pk, pv, **kw,
                                                    geometry=(rows, cols))
    full = _t(qkv_bias).expand(N, W, W, -1).clone()
    full[:, :rows, :cols] = _t(y).reshape(N, rows, cols, -1)
    full = full.reshape(N, W * W, -1)
    fa, fb = image_encoder._bias_terms_grid(full, rel_h, rel_w, cfg, W)
    ref = sam_attention.fused_window_attention_grid(full, fa, fb, **kw)
    ref = ref.reshape(N, W, W, -1)[:, :rows, :cols].reshape(N, T, -1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,cols,pad_rows", [(3, 3, 7), (3, 1, 0), (1, 3, 0), (1, 1, 0)])
def test_assemble_bias_terms_and_pad_tables_match_jax(rows, cols, pad_rows):
    """Exact: slices, concatenations and constants only."""
    rng = np.random.default_rng(6)
    W, H, hd, N = 3, 2, 16, 4
    R = 2 * W - 1
    P = rng.standard_normal((N, rows * cols, 2 * H * R)).astype(np.float32)
    jA, jB = jie._assemble_bias_terms(jnp.asarray(P), rows, cols, W, H, pad_rows=pad_rows)
    A, Bb = image_encoder._assemble_bias_terms(_t(P), rows, cols, W, H, pad_rows=pad_rows)
    assert A.shape == (N, rows * cols + pad_rows, H * W)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(Bb.numpy(), np.asarray(jB))
    qkv_bias = rng.standard_normal(3 * H * hd).astype(np.float32)
    if rows * cols < W * W:
        jk, jv = jie._pad_tables(jnp.asarray(qkv_bias), rows, cols, W, H, hd, jnp.float32)
        k, v = image_encoder._pad_tables(_t(qkv_bias), rows, cols, W, H, hd, torch.float32)
        assert k.shape == (H, W * W - rows * cols, hd + 2 * W)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # The composite route's terms are the standalone route's on the same q.
    cfg = image_encoder.SamVisionConfig.tiny(embed_dim=H * hd, num_heads=H, window_size=W)
    y = _t(rng.standard_normal((N, rows * cols, 3 * H * hd)).astype(np.float32))
    rels = [_t((0.3 * rng.standard_normal((R, hd))).astype(np.float32)) for _ in range(2)]
    ref_a, ref_b = image_encoder._bias_terms_rect(y, *rels, cfg, rows, cols, W)
    q4 = y[:, :, :H * hd].reshape(N, -1, H, hd)
    Pq = torch.stack([torch.einsum("nthd,rd->nthr", q4, r * hd**0.5) for r in rels], dim=2)
    got_a, got_b = image_encoder._assemble_bias_terms(
        Pq.reshape(N, -1, 2 * H * R), rows, cols, W, H)
    np.testing.assert_allclose(got_a.numpy(), ref_a.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), ref_b.numpy(), atol=1e-5)


def test_encode_resident_fp32_matches_block_layout_and_jax():
    """fp32 weights: plain LN and projections around the window kernels,
    the grid kernel on the full class and the boundary kernel on each of
    the other three. 2e-4 against the port's own block layout and against
    JAX resident (fp32 through four blocks and the neck)."""
    jcfg, cfg = _tiny_cfgs()
    jparams = random_params(jie.init_params, jcfg, seed=7, std=0.2)
    params = params_from_jax(jparams, device="cpu")
    img = np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)
    got = image_encoder.encode(params, cfg, _t(img))
    block = image_encoder.encode(params, dataclasses.replace(cfg, window_layout="block"), _t(img))
    ref = jax.jit(jie.encode, static_argnums=1)(jparams, jcfg, jnp.asarray(img))
    assert got.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(got.numpy(), block.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    # "auto" is resident here, and the default.
    auto = image_encoder.encode(params, dataclasses.replace(cfg, window_layout="auto"), _t(img))
    assert torch.equal(auto, got)
    assert image_encoder._use_resident(image_encoder.SamVisionConfig.tiny())
    assert not image_encoder._use_resident(image_encoder.SamVisionConfig.tiny(window_size=5))


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
def test_encode_resident_int8_composite_matches_jax(w8a8):
    """int8 weights with composite bias weights from the JAX package,
    carried across by the bridge: the dual LN1+qkv on every class (the
    full class stored as 16 rows for its 9 tokens, the right and bottom
    classes as one stream with one dual-geometry attention call), proj +
    residual fused. With int8 activations an int8 step may flip between
    the frameworks (`FLIP`); weight-only is fp32 noise (3e-4)."""
    jcfg, cfg = _tiny_cfgs(mlp_w8a8=w8a8)
    jq, params = _quantized_with_composite(jcfg, seed=8)
    img = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jie.encode, static_argnums=1)(jq, jcfg, jnp.asarray(img)))
    got = image_encoder.encode(params, cfg, _t(img)).numpy()
    if w8a8:
        _close_w8a8(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=3e-4, rtol=3e-4)
    # Without the composite weights the standalone bias products give the
    # same function up to the composite's int8 rounding (5e-3, the JAX
    # package's own limit for the pair).
    bare = {**params, "window_blocks": [
        {k: v for k, v in b.items() if not k.startswith("biasw")} for b in params["window_blocks"]]}
    alone = image_encoder.encode(bare, cfg, _t(img)).numpy()
    np.testing.assert_allclose(got, alone, atol=5e-3, rtol=5e-3)
    assert np.abs(got - alone).max() > 0


def test_block_resident_merges_the_edge_classes_only_with_int8_weights():
    jcfg, cfg = _tiny_cfgs()
    _, params = _quantized_with_composite(jcfg, seed=9)
    x = _t(np.random.default_rng(9).standard_normal((2, 4, 4, 32)).astype(np.float32))
    cls = image_encoder._partition_resident(x, 3, 16)
    p = params["window_blocks"][0]
    assert image_encoder._merge_edge_classes(cls, p)
    assert not image_encoder._merge_edge_classes({"full": cls["full"]}, p)
    fp = {k: (quant.dequantize(v, torch.float32) if quant.is_quantized(v) else v)
          for k, v in p.items() if not k.startswith("biasw")}
    assert not image_encoder._merge_edge_classes(cls, fp)
    out = image_encoder._block_resident(cls, p, cfg)
    assert {k: v.shape for k, v in out.items()} == {k: v.shape for k, v in cls.items()}
    # Merged or class by class, the edge windows get the same values.
    pair = image_encoder._attn_resident_edge_pair(cls["right"], cls["bottom"], p, cfg)
    one = image_encoder._attn_resident_cls(cls["right"], p, cfg, 3, 1)
    np.testing.assert_allclose(pair[:2].numpy(), one.numpy(), atol=1e-6)


def test_evaluate_with_the_resident_int8_encoder_matches_jax():
    """RES `evaluate` with all three towers int8 and the SAM encoder in the
    resident layout with composite bias weights prepared by the port
    itself (`quantize_towers`, then `precompute_window_bias_weights`).
    Limit 2e-3 as for the block layout: int8 activations of the LLM may
    round one step apart."""
    from ullava_tpu.models import generate as jgen
    from ullava_tpu.models import llama as jllama
    from ullava_tpu.models import ullava as jullava
    from ullava_tpu_torch.models import generate, llama, ullava

    kw = dict(vocab_size=160, a8_prefill=True, kv_quant=True)
    jcfg = jullava.UllavaConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg,
        core=dataclasses.replace(jcfg.core, llm=jllama.LlamaConfig.tiny(**kw)),
        sam=dataclasses.replace(jcfg.sam, vision=dataclasses.replace(
            jcfg.sam.vision, attn_kernel="pallas_interpret", window_layout="resident",
            mlp_w8a8=True)),
    )
    cfg = ullava.UllavaConfig.tiny()
    cfg = dataclasses.replace(
        cfg,
        core=dataclasses.replace(cfg.core, llm=llama.LlamaConfig.tiny(**kw)),
        sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(cfg.sam.vision, mlp_w8a8=True)),
    )
    assert cfg.sam.vision.window_layout == "auto"  # the default serves resident
    raw = random_params(jullava.init_params, jcfg, seed=10)
    jparams = jax.tree_util.tree_map(jnp.asarray, raw)
    jparams["core"]["llm"] = jquant.quantize_tree(jparams["core"]["llm"], jquant.LLAMA_QUANT_KEYS)
    jparams["core"]["vision"] = jquant.quantize_tree(
        jparams["core"]["vision"], jquant.CLIP_QUANT_KEYS)
    jparams["sam"]["image_encoder"] = jie.precompute_window_bias_weights(
        jquant.quantize_tree(jparams["sam"]["image_encoder"], jquant.SAM_ENCODER_QUANT_KEYS),
        jcfg.sam.vision)
    params = ullava.precompute_window_bias_weights(
        ullava.quantize_towers(ullava.quantize_llm(params_from_jax(raw, device="cpu"))), cfg)
    blk = params["sam"]["image_encoder"]["window_blocks"][0]
    assert blk["biasw"]["q"].dtype == torch.int8 and blk["biasw_bias"].dtype == torch.float32

    batch = res_batch(cfg, np.random.default_rng(10), [12, 10])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    gc = generate.GenerateConfig(max_new_tokens=6)
    first = ullava.evaluate(params, cfg, gc, **tbatch)
    seg = int(first["sequences"][0, 14])
    cfg = dataclasses.replace(cfg, seg_token_idx=seg)
    jcfg = dataclasses.replace(jcfg, seg_token_idx=seg)
    ref = jax.jit(jullava.evaluate, static_argnums=(1, 2))(
        jparams, jcfg, jgen.GenerateConfig(max_new_tokens=6, temperature=0.0),
        **{k: jnp.asarray(v) for k, v in batch.items()})
    out = ullava.evaluate(params, cfg, gc, **tbatch)
    for key in ("sequences", "lengths", "seg_valid", "loc_valid"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    assert bool(out["seg_valid"][0, 0])
    for key in ("low_res_masks", "pred_boxes", "iou_pred"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-3, rtol=2e-3)
