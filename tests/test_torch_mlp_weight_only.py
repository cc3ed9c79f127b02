"""Parity of the weight-only (`w8a8=False`) fused SAM functions with the
JAX package on the CPU, in the arithmetic that their CUDA kernels copy:
bf16 inputs, so that the rounding points show (the LN'd row and the GELU
output rounded to bf16 before their products, the int8 weight widened to
bf16, fp32 sums, the scale after the product), against the JAX Pallas
kernels in interpret mode; and the int8-towers SAM encoder with
`mlp_w8a8` off in the resident layout, with and without the composite
bias weights, whose routes must reach the same fused functions as the JAX
package's.

Tolerances: bf16 outputs within 1e-2 of each row's largest value (one bf16
ulp of it is at most 2^-7; the two frameworks sum in other orders, so a
value near a rounding boundary of the LN'd row or of the output may land
one ulp apart); the fp32 encoder within 3e-4, fp32 summation order.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import mlp_kernel as jmlp
from ullava_tpu.ops import quant as jquant
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import mlp_kernel, quant

_TOL = 1e-2


def setup_module():
    torch.set_num_threads(1)


def _row_rel_err(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float((np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


def _bf16(rng, shape, scale=1.0, shift=0.0):
    """(numpy fp32 values exactly representable in bf16, the torch bf16 tensor)."""
    t = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale + shift).to(torch.bfloat16)
    return t.float().numpy(), t


def _weight(rng, K, N):
    w = jquant.quantize_int8(jnp.asarray(0.05 * rng.standard_normal((K, N)), jnp.float32))
    q, s = np.array(w["q"]), np.array(w["scale"])
    return (jnp.asarray(q), jnp.asarray(s)), (quant.column_major(torch.from_numpy(q)), torch.from_numpy(s))


def _jbf(a):
    return jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("form", ["ln_3d", "ln_2d", "residual_no_ln"])
def test_weight_only_fused_ln_linear_in_bf16_matches_jax(form):
    """K10 weight-only: LN1+qkv on window-major classes ([N, T, C] with T
    = 49, not tile-aligned) or flat tokens, and proj + residual."""
    rng = np.random.default_rng(21)
    lead, C, N = ((3, 49), 128, 384) if form == "ln_3d" else ((64,), 128, 128)
    x, tx = _bf16(rng, (*lead, C), 2.0, 0.3)
    (jw, js), (tw, ts) = _weight(rng, C, N)
    bias, tbias = _bf16(rng, (N,), 0.5)
    ln = form != "residual_no_ln"
    (g, tg), (b, tb) = (_bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)) if ln else ((None, None),) * 2
    res, tres = _bf16(rng, (*lead, N)) if not ln else (None, None)
    ref = jmlp.fused_ln_linear(
        _jbf(x), None if g is None else _jbf(g), None if b is None else _jbf(b), jw, js, _jbf(bias),
        1e-6, w8a8=False, residual=None if res is None else _jbf(res), interpret=True)
    got = mlp_kernel.fused_ln_linear(tx, tg, tb, tw, ts, tbias, 1e-6, w8a8=False, residual=tres)
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, N)
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.parametrize(
    "N,T,rows2", [(2, 49, 49), (2, 49, 45), (5, 64, 64), (3, 112, 112), (3, 200, 196)],
    ids=["all_rows", "trimmed", "corner_5x64", "edge_3x112", "full_3x200"])
def test_weight_only_fused_ln_linear_dual_in_bf16_matches_jax(N, T, rows2):
    """K13 weight-only: LN1+qkv and the composite bias columns (f32 bias)
    from one bf16 LN'd row; the second output keeps `rows2` rows. The last
    three cases take the encode's class geometries, where a 256-row token
    tile of the CUDA kernel crosses windows and N * T is not a multiple of
    256; F2 = 104 is not a multiple of its 128-channel tiles."""
    rng = np.random.default_rng(22)
    C, F1, F2 = 128, 384, 104
    x, tx = _bf16(rng, (N, T, C), 2.0, 0.3)
    (g, tg), (b, tb) = _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    (jw, js), (tw, ts) = _weight(rng, C, F1)
    (jw2, js2), (tw2, ts2) = _weight(rng, C, F2)
    bias, tbias = _bf16(rng, (F1,), 0.5)
    bias2 = (0.5 * rng.standard_normal(F2)).astype(np.float32)
    ry, rp = jmlp.fused_ln_linear_dual(
        _jbf(x), _jbf(g), _jbf(b), jw, js, _jbf(bias), jw2, js2, jnp.asarray(bias2), 1e-6,
        w8a8=False, rows2=rows2, interpret=True)
    y, p = mlp_kernel.fused_ln_linear_dual(tx, tg, tb, tw, ts, tbias, tw2, ts2,
                                           torch.from_numpy(bias2), 1e-6, w8a8=False, rows2=rows2)
    assert p.shape == (N, rows2, F2) and p.dtype == torch.bfloat16
    assert _row_rel_err(y, ry) <= _TOL and _row_rel_err(p, rp) <= _TOL


def test_weight_only_fused_mlp_block_in_bf16_matches_jax():
    """K12 weight-only over two F-chunks of 512: the GELU output rounded
    to bf16 before fc2 on both sides. The CUDA kernel sums fc2 over all of
    F before its per-column scale (one chunk): the same function up to
    fp32 rounding, held here to the same gate."""
    rng = np.random.default_rng(23)
    T, C, F = 64, 128, 1024
    x, tx = _bf16(rng, (T, C), 2.0, 0.3)
    (g, tg), (b, tb) = _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    (jw1, js1), (tw1, ts1) = _weight(rng, C, F)
    (jw2, js2), (tw2, ts2) = _weight(rng, F, C)
    (b1, tb1), (b2, tb2) = _bf16(rng, (F,), 0.5), _bf16(rng, (C,), 0.5)
    ref = jmlp.fused_mlp_block(_jbf(x), _jbf(g), _jbf(b), jw1, js1, _jbf(b1), jw2, js2, _jbf(b2),
                               1e-6, block_t=64, f_chunk=512, w8a8=False, interpret=True)
    args = (tx, tg, tb, tw1, ts1, tb1, tw2, ts2, tb2, 1e-6)
    got = mlp_kernel.fused_mlp_block(*args, f_chunk=512, w8a8=False)
    assert got.dtype == torch.bfloat16
    assert _row_rel_err(got, ref) <= _TOL
    one_chunk = mlp_kernel.fused_mlp_block(*args, f_chunk=F, w8a8=False)
    assert _row_rel_err(one_chunk, ref) <= _TOL
    # The polynomial GELU is part of the function: the exact erf is not it.
    exact = (torch.nn.functional.layer_norm(tx.float(), (C,), tg.float(), tb.float(), 1e-6)
             .to(torch.bfloat16).float() @ tw1.float() * ts1 + tb1.float())
    exact = torch.nn.functional.gelu(exact).to(torch.bfloat16).float() @ tw2.float() * ts2
    exact = (exact + tb2.float() + tx.float()).to(torch.bfloat16)
    assert (exact.float() - got.float()).abs().max() > 0


# ------------------------------------------------------- encoder routes


def _count_calls(monkeypatch, module, names):
    """Wrap `module`'s fused functions; a call made from inside another
    wrapped call (the JAX `fused_linear` calls `fused_ln_linear`) is not
    counted. Returns the Counter of (name, w8a8) calls."""
    calls, depth = collections.Counter(), [0]

    def wrap(name, fn):
        def counted(*args, **kw):
            if depth[0] == 0:
                calls[name, kw.get("w8a8")] += 1
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return counted

    for name in names:
        monkeypatch.setattr(module, name, wrap(name, getattr(module, name)))
    return calls


@pytest.mark.parametrize("biasw", [False, True], ids=["no_biasw", "biasw"])
def test_int8_towers_encoder_weight_only_routes_match_jax(monkeypatch, biasw):
    """The smallest encoder that clears the fused gates (img 512, patch 16,
    embed 128, two heads of 64; grid 32, window 14) with int8 weights and
    `mlp_w8a8` off, in the resident layout: the window block's three
    classes (full, the merged right and bottom, corner) each through
    `fused_ln_linear` (or `fused_ln_linear_dual` with the composite bias
    weights) and `fused_linear`, their MLPs below the 512-row gate on the
    plain chain; the global block through `fused_ln_linear`,
    `fused_linear` and `fused_mlp_block`. Both packages make the same
    calls, all weight-only, and give the same embeddings."""
    base = dict(img_size=512, patch_size=16, embed_dim=128, depth=2, num_heads=2, out_chans=16,
                window_size=14, global_attn_indexes=(1,))
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel="pallas_interpret",
                               window_layout="resident")
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32, window_layout="resident")
    assert not cfg.mlp_w8a8 and not jcfg.mlp_w8a8
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, seed=24, std=0.1))
    jp = jquant.quantize_tree(jp, jquant.SAM_ENCODER_QUANT_KEYS)
    if biasw:
        jp = jie.precompute_window_bias_weights(jp, jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    names = ("fused_ln_linear", "fused_linear", "fused_ln_linear_dual", "fused_mlp_block")
    img = np.random.default_rng(24).standard_normal((1, 512, 512, 3)).astype(np.float32)

    jcalls = _count_calls(monkeypatch, jmlp, names)
    ref = np.asarray(jax.jit(lambda p, x: jie.encode(p, jcfg, x))(jp, jnp.asarray(img)))
    calls = _count_calls(monkeypatch, image_encoder, names)
    got = image_encoder.encode(params, cfg, torch.from_numpy(img)).numpy()

    # window block: 3 classes x (LN1+qkv, proj); global block: LN1+qkv, proj, MLP
    expect = {("fused_ln_linear", False): 1, ("fused_linear", False): 4,
              ("fused_mlp_block", False): 1}
    if biasw:
        expect["fused_ln_linear_dual", False] = 3
    else:
        expect["fused_ln_linear", False] += 3
    assert dict(calls) == expect == dict(jcalls)
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=3e-4)
    # Another function than the W8A8 route.
    w8 = image_encoder.encode(params, dataclasses.replace(cfg, mlp_w8a8=True), torch.from_numpy(img))
    assert np.abs(w8.numpy() - got).max() > np.abs(got - ref).max()
