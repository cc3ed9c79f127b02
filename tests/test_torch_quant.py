"""Parity of the port's int8 serving ops with the JAX package: the weight
and activation quantization of `ops/quant.py`, and the plain versions of
the five int8-path kernels against the JAX functions with their Pallas
kernels in interpret mode, on the same inputs drawn from a numpy seed.

Tolerances: int8 outputs are rounded from fp32 values that the two
frameworks sum in different orders, so a value within that noise of .5
may round the other way; as the JAX package's own tests do, at least
99.9% of the int8 values must agree exactly and the rest within 1.
Abs-max and scale outputs agree to rtol 1e-6, fp32 outputs to 2e-5.
The CUDA kernels themselves are held to these plain versions on the card
by `tests/test_torch_cuda_int8.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_int8_close
from ullava_tpu.ops import decode_attention as jdec
from ullava_tpu.ops import mlp_kernel as jmlp
from ullava_tpu.ops import norms as jnorms
from ullava_tpu.ops import quant as jquant
from ullava_tpu_torch.ops import decode_attention, mlp_kernel, norms, quant

ATOL = RTOL = 2e-5


def setup_module():
    torch.set_num_threads(1)


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def test_quantize_int8_and_dequantize_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 48, 40)).astype(np.float32)  # stacked [L, in, out]
    w[1, :, 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    ref = jquant.quantize_int8(jnp.asarray(w))
    got = quant.quantize_int8(_t(w))
    assert got["q"].dtype == torch.int8 and tuple(got["scale"].shape) == (3, 1, 40)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    _close(got["scale"], ref["scale"], atol=0, rtol=1e-6)
    _close(quant.dequantize(got, torch.float32), jquant.dequantize(ref, jnp.float32), atol=0, rtol=1e-6)
    assert quant.is_quantized(got) and not quant.is_quantized(_t(w))
    assert quant.dequantize(got["q"]) is got["q"]


@pytest.mark.parametrize("quantized", [False, True])
def test_apply_linear_matches_jax(quantized):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    jw, tw = jnp.asarray(w), _t(w)
    if quantized:
        jw, tw = jquant.quantize_int8(jw), quant.quantize_int8(tw)
    _close(quant.apply_linear(_t(x), tw), jquant.apply_linear(jnp.asarray(x), jw), atol=1e-4)


def test_apply_linear_a8_and_prequant_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32) * 3
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    w = rng.standard_normal((64, 24)).astype(np.float32)
    jw, tw = jquant.quantize_int8(jnp.asarray(w)), quant.quantize_int8(_t(w))
    # The int32 products are exact; the fp32 rescale differs by rounding.
    _close(quant.apply_linear_a8(_t(x), tw), jquant.apply_linear_a8(jnp.asarray(x), jw), atol=1e-4)

    xq = rng.integers(-127, 128, size=(18, 64)).astype(np.int8)
    amax = np.abs(rng.standard_normal((18, 1))).astype(np.float32)
    ref = jquant.apply_linear_a8_prequant(jnp.asarray(xq), jnp.asarray(amax), jw, jnp.float32)
    _close(quant.apply_linear_a8_prequant(_t(xq), _t(amax), tw, torch.float32), ref, atol=1e-4)


@pytest.mark.parametrize("M", [1, 16, 17])
def test_int8_matmul_padded_is_bit_equal(M):
    """The card's library int8 product refuses 16 rows or fewer, so
    `int8_matmul` pads them with zero rows to 32 there and slices after:
    bit-equal to the product of the unpadded rows, since every output row
    depends on its own input row only."""
    rng = np.random.default_rng(12)
    xq = _t(rng.integers(-127, 128, size=(M, 64)).astype(np.int8))
    wq = quant.column_major(_t(rng.integers(-127, 128, size=(64, 24)).astype(np.int8)))
    got = quant.int8_matmul_padded(xq, wq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, 24)
    np.testing.assert_array_equal(got.numpy(), torch._int_mm(xq, wq).numpy())
    np.testing.assert_array_equal(got.numpy(), quant.int8_matmul(xq, wq).numpy())
    np.testing.assert_array_equal(
        got.numpy(), xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64))


def test_int8_weights_are_stored_column_major():
    """`quantize_int8` and the bridge lay `q` out with stride 1 along its
    `in` axis (shape and values unchanged), stacked or not."""
    from ullava_tpu_torch import bridge

    rng = np.random.default_rng(11)
    w = rng.standard_normal((2, 24, 16)).astype(np.float32)
    ref = jquant.quantize_int8(jnp.asarray(w))
    got = quant.quantize_int8(_t(w))
    assert tuple(got["q"].shape) == (2, 24, 16) and got["q"].stride()[-2:] == (1, 24)
    tree = {"layers": {"q_proj": jax.tree_util.tree_map(np.asarray, ref)}}
    layers = bridge.params_from_jax(tree, "cpu")["layers"]
    for i, layer in enumerate(layers):
        q = layer["q_proj"]["q"]
        assert q.dtype == torch.int8 and tuple(q.shape) == (24, 16) and q.stride() == (1, 24)
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref["q"][i]))
        assert tuple(layer["q_proj"]["scale"].shape) == (1, 16)


def test_quantize_tree_matches_jax_keys():
    assert quant.LLAMA_QUANT_KEYS == jquant.LLAMA_QUANT_KEYS
    rng = np.random.default_rng(3)
    tree = {
        "embed_tokens": rng.standard_normal((10, 8)).astype(np.float32),
        "layers": [{"q_proj": rng.standard_normal((8, 8)).astype(np.float32),
                    "input_norm": rng.standard_normal(8).astype(np.float32)}],
        "lm_head": rng.standard_normal((8, 10)).astype(np.float32),
    }
    ref = jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), jquant.LLAMA_QUANT_KEYS)
    got = quant.quantize_tree(jax.tree_util.tree_map(_t, tree), quant.LLAMA_QUANT_KEYS)
    assert not quant.is_quantized(got["embed_tokens"]) and not quant.is_quantized(got["layers"][0]["input_norm"])
    for g, r in ((got["lm_head"], ref["lm_head"]), (got["layers"][0]["q_proj"], ref["layers"][0]["q_proj"])):
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(r["q"]))
        _close(g["scale"], r["scale"], atol=0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
def test_rms_norm_quant_matches_jax_interpret(residual, dtype):
    rng = np.random.default_rng(4)
    rows, D = 32, 256
    x = rng.standard_normal((2, rows // 2, D)).astype(np.float32)
    res = rng.standard_normal((2, rows // 2, D)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jres, jw = (jnp.asarray(a, jd) for a in (x, res, w))
    tx, tres, tw = (_t(a, td) for a in (x, res, w))
    if residual:
        jh, jq, js = jnorms.rms_norm_residual_quant(jx, jres, jw, 1e-6, interpret=True)
        h, q, s = norms.rms_norm_residual_quant(tx, tres, tw, 1e-6)
        # h is the fp32 sum rounded once to the working dtype: exact.
        np.testing.assert_array_equal(_np(h), np.asarray(jh, np.float32))
        assert h.dtype == td
    else:
        jq, js = jnorms.rms_norm_quant(jx, jw, 1e-6, interpret=True)
        q, s = norms.rms_norm_quant(tx, tw, 1e-6)
    assert q.dtype == torch.int8 and q.shape == tx.shape and tuple(s.shape) == (rows, 1)
    assert_int8_close(q.numpy(), jq)
    _close(s, js, atol=0, rtol=1e-6)


def test_rms_norm_residual_quant_norms_the_unrounded_sum():
    """In bf16 the int8 rows come from the fp32 sum x + res, not from the
    bf16 `h` that is stored: quantizing the rounded h gives other rows."""
    rng = np.random.default_rng(5)
    x, res = (_t(rng.standard_normal((16, 256)).astype(np.float32), torch.bfloat16) for _ in range(2))
    w = torch.ones(256, dtype=torch.bfloat16)
    h, q, _ = norms.rms_norm_residual_quant(x, res, w)
    q_from_h, _ = norms.rms_norm_quant(h, w)
    assert (q != q_from_h).float().mean() > 0.01


def test_silu_mul_quant_matches_jax_interpret():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((16, 344)).astype(np.float32) * 2  # 344: not a power of two
    u = rng.standard_normal((16, 344)).astype(np.float32)
    jq, js = jmlp.silu_mul_quant(jnp.asarray(g), jnp.asarray(u), interpret=True)
    q, s = mlp_kernel.silu_mul_quant(_t(g), _t(u))
    assert q.dtype == torch.int8 and tuple(s.shape) == (16, 1)
    assert_int8_close(q.numpy(), jq)
    _close(s, js, atol=0, rtol=1e-6)


def _empty_cache(rng, L, B, maxS, Hkv, hd):
    """A cache pre-filled with noise, so that a row written by mistake or
    read past its length shows."""
    ck, cv = (rng.integers(-127, 128, size=(L, B, maxS, Hkv * hd)).astype(np.int8) for _ in range(2))
    ks, vs = (np.abs(rng.standard_normal((L, B, maxS, Hkv))).astype(np.float32) for _ in range(2))
    return ck, cv, ks, vs


def test_quantize_kv_rows_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq, js = jdec.quantize_kv_rows(jnp.asarray(x))
    q, s = decode_attention.quantize_kv_rows(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js, atol=0, rtol=1e-6)


def test_prefill_quantize_write_matches_jax_interpret():
    rng = np.random.default_rng(8)
    L, B, S, maxS, Hkv, hd, layer = 3, 2, 8, 16, 2, 16, 1
    k, v = (rng.standard_normal((B, S, Hkv, hd)).astype(np.float32) for _ in range(2))
    cache = _empty_cache(rng, L, B, maxS, Hkv, hd)
    ref = jdec.prefill_quantize_write(
        jnp.asarray(k), jnp.asarray(v), *(jnp.asarray(c) for c in cache),
        jnp.asarray(layer, jnp.int32), interpret=True,
    )
    tc = [_t(c) for c in cache]
    got = decode_attention.prefill_quantize_write(_t(k), _t(v), *tc, layer)
    for g, c, r, before in zip(got, tc, ref, cache):
        assert g is c  # updated in place, the same tensors returned
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            _close(g, r, atol=0, rtol=1e-6)
        # Rows [S, maxS) and the other layers keep their bytes.
        np.testing.assert_array_equal(g.numpy()[layer, :, S:], before[layer, :, S:])
        np.testing.assert_array_equal(g.numpy()[[0, 2]], before[[0, 2]])


def tie_rows(rng, B, S, Hkv, hd):
    """[B, S, Hkv, hd] rows on which x / scale falls exactly on k + 0.5: each
    (row, head) holds one +-amax with amax = 127 * 2^-4, so its scale is
    2^-4 exactly, and every other value is (k + 0.5) * 2^-4 for an integer
    k in [-127, 126], exact in bf16. Rounding half to even must take the
    even neighbour of each."""
    x = (rng.integers(-127, 127, size=(B, S, Hkv, hd)) + 0.5) * 2.0**-4
    peak = rng.integers(0, hd, size=(B, S, Hkv))
    sign = rng.choice([-1.0, 1.0], size=(B, S, Hkv))
    np.put_along_axis(x, peak[..., None], (sign * 127 * 2.0**-4)[..., None], axis=-1)
    return x.astype(np.float32)


def test_prefill_quantize_write_rounds_ties_to_even_like_jax_interpret():
    rng = np.random.default_rng(9)
    L, B, S, maxS, Hkv, hd, layer = 2, 2, 8, 12, 3, 16, 1
    k, v = tie_rows(rng, B, S, Hkv, hd), tie_rows(rng, B, S, Hkv, hd)
    cache = _empty_cache(rng, L, B, maxS, Hkv, hd)
    ref = jdec.prefill_quantize_write(
        jnp.asarray(k), jnp.asarray(v), *(jnp.asarray(c) for c in cache),
        jnp.asarray(layer, jnp.int32), interpret=True,
    )
    tc = [_t(c) for c in cache]
    got = decode_attention.prefill_quantize_write(_t(k), _t(v), *tc, layer)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for x, q, s in ((k, got[0], got[2]), (v, got[1], got[3])):
        np.testing.assert_array_equal(s.numpy()[layer, :, :S], np.full((B, S, Hkv), 2.0**-4, np.float32))
        even = np.round(x * 16.0)  # numpy rounds half to even
        assert (np.abs(x * 16.0 - np.trunc(x * 16.0)) == 0.5).mean() > 0.9  # mostly ties
        np.testing.assert_array_equal(q.numpy()[layer, :, :S].reshape(B, S, Hkv, hd), even)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_decode_attention_fused_write_matches_jax_interpret(H, Hkv):
    """MHA and GQA, ragged write positions (one at 0: no history)."""
    rng = np.random.default_rng(9)
    L, B, maxS, hd, layer = 2, 3, 16, 16, 1
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    cache = _empty_cache(rng, L, B, maxS, Hkv, hd)
    kq, vq = (rng.integers(-127, 128, size=(B, Hkv * hd)).astype(np.int8) for _ in range(2))
    ksn, vsn = (np.abs(rng.standard_normal((B, Hkv))).astype(np.float32) * 0.02 for _ in range(2))
    cache[2][...] *= 0.02
    wp = np.array([11, 0, 5], np.int32)
    scale = hd**-0.5
    ref = jdec.decode_attention_int8_fused_write(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ksn), jnp.asarray(vq), jnp.asarray(vsn),
        *(jnp.asarray(c) for c in cache), jnp.asarray(wp), jnp.asarray(layer, jnp.int32),
        scale=scale, interpret=True,
    )
    tc = [_t(c) for c in cache]
    got = decode_attention.decode_attention_int8_fused_write(
        _t(q), _t(kq), _t(ksn), _t(vq), _t(vsn), *tc, _t(wp), layer, scale=scale
    )
    _close(got[0], ref[0], atol=3e-5)
    for g, c, r in zip(got[1:], tc, ref[1:]):
        assert g is c
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # The yardstick form agrees with it when given the same lengths.
    again = decode_attention.decode_attention_int8_xla(
        _t(q), *tc, _t(wp) + 1, layer, scale=scale
    )
    ref_xla = jdec.decode_attention_int8_xla(
        jnp.asarray(q), *ref[1:], jnp.asarray(wp) + 1, jnp.asarray(layer, jnp.int32), scale=scale
    )
    _close(again, ref_xla, atol=3e-5)


# Write positions at the edges of the card kernel's row tiles (16 rows a
# warp at head_dim 128, 128 at 16), its first row and its last: the plain
# version the kernel is held to on the card, held here to the JAX kernel.
_WRITE_EDGES = {
    128: (160, [0, 15, 16, 17, 63, 64, 65, 159]),
    16: (264, [0, 127, 128, 129, 255, 256, 257, 263]),
}


@pytest.mark.parametrize("hd", list(_WRITE_EDGES))
def test_decode_attention_fused_write_tile_edges_match_jax_interpret(hd):
    """GQA rep 4 (8 q heads on 2 kv heads), one sample a write position."""
    rng = np.random.default_rng(11)
    maxS, positions = _WRITE_EDGES[hd]
    L, B, H, Hkv, layer = 2, len(positions), 8, 2, 0
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    cache = _empty_cache(rng, L, B, maxS, Hkv, hd)
    cache[2][...] *= 0.02
    cache[3][...] *= 0.02
    kq, vq = (rng.integers(-127, 128, size=(B, Hkv * hd)).astype(np.int8) for _ in range(2))
    ksn, vsn = (np.abs(rng.standard_normal((B, Hkv))).astype(np.float32) * 0.02 for _ in range(2))
    wp = np.array(positions, np.int32)
    scale = hd**-0.5
    ref = jdec.decode_attention_int8_fused_write(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ksn), jnp.asarray(vq), jnp.asarray(vsn),
        *(jnp.asarray(c) for c in cache), jnp.asarray(wp), jnp.asarray(layer, jnp.int32),
        scale=scale, interpret=True,
    )
    tc = [_t(c) for c in cache]
    got = decode_attention.decode_attention_int8_fused_write(
        _t(q), _t(kq), _t(ksn), _t(vq), _t(vsn), *tc, _t(wp), layer, scale=scale
    )
    _close(got[0], ref[0], atol=3e-5)
    for g, r, before in zip(got[1:], ref[1:], cache):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        # Only row write_pos[b] of the layer changed.
        changed = np.argwhere((g.numpy() != before).reshape(L, B, maxS, -1).any(-1))
        assert all(l_ == layer and s_ == wp[b_] for l_, b_, s_ in changed), changed


def test_fused_write_splits_fill_the_card_only_where_blocks_are_few():
    """The card kernel's split of a sample's rows: none at the int8
    serve's B=16 x 32 heads on 132 SMs (at any cache length), more blocks
    a (sample, head) for small batches over long caches, none for caches
    under 512 rows, at most 32."""
    splits = decode_attention.fused_write_splits
    assert splits(16, 32, 352, 132) == 1 and splits(16, 32, 2048, 132) == 1
    assert splits(4, 32, 2048, 132) == 4 and splits(1, 32, 2048, 132) == 8
    assert splits(1, 32, 352, 132) == 1 and splits(1, 1, 1 << 20, 132) == 32


def test_rms_norm_large_input_matches_jax_interpret():
    """The plain version of `rms_norm` (what a CPU tensor takes), held to
    the JAX forward kernel at the 4096 rows from which the JAX package
    launches it."""
    rng = np.random.default_rng(10)
    rows, D = 4096, 32
    x = rng.standard_normal((2, rows // 2, D)).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(D).astype(np.float32)
    ref = jnorms._rms_norm_pallas(jnp.asarray(x).reshape(rows, D), jnp.asarray(w), 1e-6, True)
    _close(norms.rms_norm(_t(x), _t(w), 1e-6).reshape(rows, D), ref)
