"""Parity of the port's int8 SAM encoder path with the JAX package on the
CPU: the same numpy inputs go through the JAX function (its Pallas kernels
in interpret mode) and the port's plain version, for each fused function,
for the encoder as a whole, for the int8 CLIP tower and for `evaluate`
with all three towers int8.

Tolerances. An int8 activation within fp32 reassociation of .5 may round
one step apart between the two frameworks: int8 values the tests can see
are held to >= 99.9% exact and the rest within 1. One flipped step moves
an output by about 1/127 of one term of its sum, so W8A8 outputs are held
to `FLIP` = 2e-3 of the largest output value (ten times tighter than the
2% the JAX package allows W8A8 against weight-only), and their bulk (the
median error) to 1e-5 of it. Paths without int8 activations are held to
fp32 summation-order noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_int8_close, random_params, res_batch
from ullava_tpu.models import clip_vit as jclip
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import mlp_kernel as jmlp
from ullava_tpu.ops import quant as jquant
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import clip_vit
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


def _linear_inputs(rng, lead, C, N):
    """x, LN scale and bias, an int8 weight (JAX layout), bias, residual."""
    w = jquant.quantize_int8(jnp.asarray(0.1 * rng.standard_normal((C, N)), jnp.float32))
    return dict(
        x=(2.0 * rng.standard_normal((*lead, C)) + 0.3).astype(np.float32),
        g=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        b=(0.1 * rng.standard_normal(C)).astype(np.float32),
        wq=np.asarray(w["q"]), ws=np.asarray(w["scale"]),
        bias=(0.5 * rng.standard_normal(N)).astype(np.float32),
        res=rng.standard_normal((*lead, N)).astype(np.float32),
    )


def test_gelu_exact_and_row_quant_match_jax():
    """The polynomial-erf GELU is held to the JAX `_gelu_exact` (1e-6: the
    Horner steps may fuse differently), not to the exact erf, which it
    misses by up to 8.2e-4 by design."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-6, 6, 4001), 3 * rng.standard_normal(4000)]).astype(np.float32)
    got = mlp_kernel._gelu_exact(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmlp._gelu_exact(jnp.asarray(x))), atol=1e-6, rtol=0)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert 1e-4 < np.abs(got - exact).max() < 1e-3  # the polynomial, not the exact erf
    rows = (3 * rng.standard_normal((64, 96))).astype(np.float32)
    rows[5] = 0.0  # an all-zero row takes the 1e-12 floor
    q, s = mlp_kernel._row_quant(_t(rows))
    jq, js = jmlp._row_quant(jnp.asarray(rows))
    assert_int8_close(q.numpy(), jq)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("lead", [(2, 16), (32,)], ids=["3d", "2d"])
@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
def test_fused_ln_linear_matches_jax(lead, w8a8):
    d = _linear_inputs(np.random.default_rng(1), lead, 64, 48)
    ref = jmlp.fused_ln_linear(
        jnp.asarray(d["x"]), jnp.asarray(d["g"]), jnp.asarray(d["b"]), jnp.asarray(d["wq"]),
        jnp.asarray(d["ws"]), jnp.asarray(d["bias"]), 1e-6, w8a8=w8a8, interpret=True)
    got = mlp_kernel.fused_ln_linear(
        _t(d["x"]), _t(d["g"]), _t(d["b"]), quant.column_major(_t(d["wq"])), _t(d["ws"]),
        _t(d["bias"]), 1e-6, w8a8=w8a8)
    assert got.shape == (*lead, 48)
    if w8a8:
        _close_w8a8(got, ref)
    else:  # fp32 operands both sides: summation order only
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_fused_linear_with_residual_matches_jax():
    d = _linear_inputs(np.random.default_rng(2), (2, 16), 64, 64)
    ref = jmlp.fused_linear(
        jnp.asarray(d["x"]), jnp.asarray(d["wq"]), jnp.asarray(d["ws"]), jnp.asarray(d["bias"]),
        residual=jnp.asarray(d["res"]), interpret=True)
    args = (_t(d["x"]), quant.column_major(_t(d["wq"])), _t(d["ws"]), _t(d["bias"]))
    got = mlp_kernel.fused_linear(*args, residual=_t(d["res"]))
    _close_w8a8(got, ref)
    # The residual is added, and a mismatched one is refused.
    bare = mlp_kernel.fused_linear(*args)
    np.testing.assert_allclose((got - bare).numpy(), d["res"], atol=1e-5)
    with pytest.raises(ValueError):
        mlp_kernel.fused_linear(*args, residual=_t(d["res"])[:1])


@pytest.mark.parametrize("f_chunk", [0, 128], ids=["default_chunk", "chunk128"])
@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
def test_fused_mlp_block_matches_jax(w8a8, f_chunk):
    """F = 512: the default rule gives one chunk of 512, `f_chunk=128` four
    chunks, each with its own abs-max per row."""
    rng = np.random.default_rng(3)
    T, C, F = 32, 64, 512
    d1, d2 = _linear_inputs(rng, (T,), C, F), _linear_inputs(rng, (T,), F, C)
    jargs = [jnp.asarray(a) for a in (
        d1["x"], d1["g"], d1["b"], d1["wq"], d1["ws"], d1["bias"], d2["wq"], d2["ws"], d2["bias"])]
    ref = jmlp.fused_mlp_block(*jargs, 1e-6, block_t=16, f_chunk=f_chunk, w8a8=w8a8, interpret=True)
    targs = [_t(d1["x"]), _t(d1["g"]), _t(d1["b"]), quant.column_major(_t(d1["wq"])), _t(d1["ws"]),
             _t(d1["bias"]), quant.column_major(_t(d2["wq"])), _t(d2["ws"]), _t(d2["bias"])]
    got = mlp_kernel.fused_mlp_block(*targs, 1e-6, f_chunk=f_chunk, w8a8=w8a8)
    if w8a8:
        _close_w8a8(got, ref)
        # The chunking is part of the function: one scale per whole row is
        # a different result.
        other = mlp_kernel.fused_mlp_block(*targs, 1e-6, f_chunk=512 if f_chunk else 128, w8a8=True)
        assert (got - other).abs().max() > 1e-4
        parts = mlp_kernel._mlp_block_parts_plain(*targs, 1e-6, f_chunk or 512, True)
        assert parts[3].shape == (T, F) and parts[4].shape == (T, F // (f_chunk or 512))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)
    assert mlp_kernel.default_f_chunk(512) == 512 and mlp_kernel.default_f_chunk(5120) == 1024
    with pytest.raises(ValueError):
        mlp_kernel.fused_mlp_block(*targs, 1e-6, f_chunk=384, w8a8=w8a8)


def test_fused_mlp_block_chunk_spread_matches_jax():
    """Four chunks of 128 whose fc1 columns grow 1x, 3x, 9x and 27x, so a
    row's chunk abs-maxima differ severalfold: each chunk's int8 codes and
    scale are its own (one scale for two chunks, or the next chunk's, is
    a different result)."""
    rng = np.random.default_rng(7)
    T, C, F, fc = 48, 64, 512, 128
    d1, d2 = _linear_inputs(rng, (T,), C, F), _linear_inputs(rng, (T,), F, C)
    gain = (3.0 ** (np.arange(F) // fc)).astype(np.float32)
    w1 = jquant.quantize_int8(jnp.asarray(0.1 * rng.standard_normal((C, F)) * gain, jnp.float32))
    d1["wq"], d1["ws"] = np.asarray(w1["q"]), np.asarray(w1["scale"])
    jargs = [jnp.asarray(a) for a in (
        d1["x"], d1["g"], d1["b"], d1["wq"], d1["ws"], d1["bias"], d2["wq"], d2["ws"], d2["bias"])]
    ref = jmlp.fused_mlp_block(*jargs, 1e-6, block_t=16, f_chunk=fc, w8a8=True, interpret=True)
    targs = [_t(d1["x"]), _t(d1["g"]), _t(d1["b"]), quant.column_major(_t(d1["wq"])), _t(d1["ws"]),
             _t(d1["bias"]), quant.column_major(_t(d2["wq"])), _t(d2["ws"]), _t(d2["bias"])]
    got = mlp_kernel.fused_mlp_block(*targs, 1e-6, f_chunk=fc, w8a8=True)
    _close_w8a8(got, ref)
    hs = mlp_kernel._mlp_block_parts_plain(*targs, 1e-6, fc, True)[4]
    spread = (hs.amax(1) / hs.amin(1)).median().item()
    assert hs.shape == (T, 4) and spread > 5, spread
    # One scale for the whole row is a different result at this spread.
    one = mlp_kernel.fused_mlp_block(*targs, 1e-6, f_chunk=F, w8a8=True)
    assert (one.float() - got.float()).abs().max() > 2 * FLIP * got.abs().max()


def _attention_inputs(rng, B=1, H=4, W=16, hd=32):
    S, C = W * W, H * hd
    y = rng.standard_normal((B, S, 3 * C)).astype(np.float32)
    inv = hd**0.5
    a = (0.4 * inv * rng.standard_normal((B, S, H, W))).astype(np.float32)
    b = (0.4 * inv * rng.standard_normal((B, S, H, W))).astype(np.float32)
    return y, a, b, dict(num_heads=H, head_dim=hd, window=W, scale=hd**-0.5)


@pytest.mark.parametrize("mode", ["fp32", "exp_bf16", "dots_i8"])
def test_fused_global_attention_y_matches_jax(mode):
    """fp32 to summation-order noise. With `exp_bf16` the rounding of
    `s - m` depends on the running maximum, so on the key tiling (JAX: two
    tiles of 128 keys; the plain version: one global maximum): the two
    agree to bf16 probability precision, 2e-2 as the JAX package's own
    test allows. `dots_i8` adds per-row int8 scores on both sides (same
    function, same limit)."""
    y, a, b, kw = _attention_inputs(np.random.default_rng(4))
    flags = dict(exp_bf16=mode != "fp32", dots_i8=mode == "dots_i8")
    ref = jsam.fused_global_attention_y(
        jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), **kw, block_q=128, block_k=128,
        interpret=True, **flags)
    got = sam_attention.fused_global_attention_y(_t(y), _t(a), _t(b), **kw, head_group=4, **flags)
    tol = 3e-4 if mode == "fp32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    # The bias terms matter at this tolerance, and their order too.
    swapped = sam_attention.fused_global_attention_y(_t(y), _t(b), _t(a), **kw, **flags)
    assert (swapped - got).abs().max() > 0.1


def test_fused_global_attention_exp_bf16_matches_jax():
    """The transpose-staged global kernel's serving form, same limit."""
    rng = np.random.default_rng(10)
    N, W, hd = 3, 16, 32
    q, k, v = (rng.standard_normal((N, W * W, hd)).astype(np.float32) for _ in range(3))
    a, b = (0.4 * rng.standard_normal((N, W * W, W)).astype(np.float32) for _ in range(2))
    ref = jsam.fused_global_attention(
        *(jnp.asarray(t) for t in (q, k, v, a, b)), window=W, scale=hd**-0.5,
        block_q=128, block_k=128, exp_bf16=True, interpret=True)
    got = sam_attention.fused_global_attention(
        *(_t(t) for t in (q, k, v, a, b)), window=W, scale=hd**-0.5, exp_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2, rtol=2e-2)
    exact = sam_attention.fused_global_attention(
        *(_t(t) for t in (q, k, v, a, b)), window=W, scale=hd**-0.5)
    assert 0 < (got - exact).abs().max() < 2e-2  # another rounding, not another function


def _encoder_cfgs(**kw):
    """The smallest encoder that clears the fused gates (grid 32: S = 1024,
    F = 512, two heads of 64), with a window that does not divide the grid
    (32 -> 42 after LN1)."""
    base = dict(img_size=512, patch_size=16, embed_dim=128, depth=2, num_heads=2, out_chans=16,
                window_size=14, global_attn_indexes=(1,))
    base.update(kw)
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, mlp_w8a8=True,
                               attn_kernel="pallas_interpret", window_layout="block")
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32, mlp_w8a8=True,
                                        window_layout="block")
    return jcfg, cfg


def test_bias_terms_global_natural_match_jax():
    jcfg, cfg = _encoder_cfgs()
    rng = np.random.default_rng(5)
    y = rng.standard_normal((1, 1024, 3 * 128)).astype(np.float32)
    rel = {k: (0.2 * rng.standard_normal((63, 64))).astype(np.float32)
           for k in ("rel_pos_h", "rel_pos_w")}
    jA, jB = jie._bias_terms_global_natural(
        jnp.asarray(y), {k: jnp.asarray(v) for k, v in rel.items()}, jcfg, 32)
    A, Bb = image_encoder._bias_terms_global_natural(
        _t(y), {k: _t(v) for k, v in rel.items()}, cfg, 32)
    assert A.shape == (1, 1024, 2, 32)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(Bb.numpy(), np.asarray(jB), atol=2e-5, rtol=2e-5)
    assert image_encoder._global_head_group(cfg) == jie._global_head_group(jcfg) == 2


def _quantized_encoder(jcfg, seed):
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, seed, std=0.1))
    jq = jquant.quantize_tree(jparams, jquant.SAM_ENCODER_QUANT_KEYS)
    return jq, params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")


@pytest.mark.parametrize("embed_dim", [128, 96], ids=["lane_sliced", "transpose_staged"])
def test_encode_int8_fused_route_matches_jax_pallas_interpret(embed_dim):
    """At 128 wide (two heads of 64): both blocks' MLPs through
    `fused_mlp_block`, the global block through `fused_ln_linear` ->
    `fused_global_attention_y` (bf16 exponentials) -> `fused_linear`, the
    window block through the window kernel between weight-only
    projections. At 96 wide (two heads of 48) no head slab is 128-aligned,
    so the global block's attention goes through head-major copies and
    `fused_global_attention` with bf16 exponentials, and F = 384 keeps the
    MLPs on the plain chain. The bridge carries the int8
    leaves over as they are (nothing new in it). Limit 1e-2 of the largest
    embedding value (median error 1e-3 of it): the bf16 exponentials of
    the global block round against different maxima on the two sides, as
    in the kernel test, and the neck's LayerNorms carry that on."""
    jcfg, cfg = _encoder_cfgs(embed_dim=embed_dim)
    jq, params = _quantized_encoder(jcfg, seed=6)
    blk = params["global_blocks"][0]
    assert blk["qkv"]["q"].dtype == torch.int8 and blk["qkv"]["q"].stride() == (1, embed_dim)
    assert blk["fc1"]["scale"].shape == (1, 4 * embed_dim)
    assert params["patch_proj"]["q"].dtype == torch.int8
    assert image_encoder._use_global_fused(blk, cfg, cfg.grid)
    assert image_encoder._global_head_group(cfg) == jie._global_head_group(jcfg) == (
        2 if embed_dim == 128 else 0)
    img = np.random.default_rng(6).standard_normal((1, 512, 512, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jie.encode, static_argnums=1)(jq, jcfg, jnp.asarray(img)))
    got = image_encoder.encode(params, cfg, _t(img)).numpy()
    assert got.shape == (1, 32, 32, 16)
    err = np.abs(got - ref)
    assert err.max() <= 1e-2 * np.abs(ref).max(), (err.max(), np.abs(ref).max())
    assert np.median(err) <= 1e-3 * np.abs(ref).max()
    # The int8 route is another function than the weight-only chain.
    plain = image_encoder.encode(params, dataclasses.replace(cfg, mlp_w8a8=False), _t(img)).numpy()
    assert np.abs(got - plain).max() > err.max()


def test_encode_int8_weights_below_the_gates_take_the_plain_chain():
    """Grid 4 (16 tokens an image): no gate holds, so int8 weights meet
    weight-only `apply_linear`, the exact-erf GELU and the window kernel
    in every block, on both sides. No int8 activations: fp32 noise only."""
    jcfg, cfg = _encoder_cfgs(img_size=64, embed_dim=32, depth=4, window_size=3,
                              global_attn_indexes=(1, 3))
    jq, params = _quantized_encoder(jcfg, seed=7)
    assert not image_encoder._use_global_fused(params["global_blocks"][0], cfg, cfg.grid)
    img = np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jie.encode, static_argnums=1)(jq, jcfg, jnp.asarray(img))
    got = image_encoder.encode(params, cfg, _t(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_clip_int8_forward_matches_jax():
    jcfg, cfg = jclip.CLIPVisionConfig.tiny(), clip_vit.CLIPVisionConfig.tiny()
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jclip.init_params, jcfg, seed=8))
    jq = jquant.quantize_tree(jparams, jquant.CLIP_QUANT_KEYS)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    assert params["layers"][0]["fc1"]["q"].dtype == torch.int8
    img = np.random.default_rng(8).standard_normal((2, 28, 28, 3)).astype(np.float32)
    ref = jclip.forward(jq, jcfg, jnp.asarray(img), hidden_layer=-2)
    got = clip_vit.forward(params, cfg, _t(img), hidden_layer=-2)
    # Weight-only int8: fp32 activations, summation order only.
    np.testing.assert_allclose(got["patch_features"].numpy(), np.asarray(ref["patch_features"]),
                               atol=2e-4, rtol=2e-4)
    # `quantize_tree` of the port gives the same leaves, per-layer lists intact.
    mine = quant.quantize_tree(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        quant.CLIP_QUANT_KEYS)
    assert isinstance(mine["layers"], list) and len(mine["layers"]) == cfg.num_layers
    assert torch.equal(mine["layers"][1]["out_proj"]["q"], params["layers"][1]["out_proj"]["q"])
    assert torch.equal(mine["patch_proj"]["q"], params["patch_proj"]["q"])
    assert mine["position_embedding"].dtype == torch.float32


def test_evaluate_with_three_int8_towers_matches_jax():
    """RES `evaluate` with the int8 LLM (W8A8 prefill, int8 KV cache), the
    int8 CLIP tower and the int8 SAM encoder (`mlp_w8a8`; at this size its
    blocks are below the fused gates). Limit 2e-3 as for the int8 LLM
    alone: its int8 activations may round one step apart."""
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
            jcfg.sam.vision, attn_kernel="pallas_interpret", window_layout="block",
            mlp_w8a8=True)),
    )
    cfg = ullava.UllavaConfig.tiny()
    cfg = dataclasses.replace(
        cfg,
        core=dataclasses.replace(cfg.core, llm=llama.LlamaConfig.tiny(**kw)),
        sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(
            cfg.sam.vision, mlp_w8a8=True, window_layout="block")),
    )
    raw = random_params(jullava.init_params, jcfg, seed=9)
    jparams = jax.tree_util.tree_map(jnp.asarray, raw)
    jparams["core"]["llm"] = jquant.quantize_tree(jparams["core"]["llm"], jquant.LLAMA_QUANT_KEYS)
    jparams["core"]["vision"] = jquant.quantize_tree(
        jparams["core"]["vision"], jquant.CLIP_QUANT_KEYS)
    jparams["sam"]["image_encoder"] = jquant.quantize_tree(
        jparams["sam"]["image_encoder"], jquant.SAM_ENCODER_QUANT_KEYS)
    # The port's own quantizers on the bf16-free copy give the same tree.
    params = ullava.quantize_towers(ullava.quantize_llm(params_from_jax(raw, device="cpu")))
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for mine, theirs in (
        (params["sam"]["image_encoder"]["window_blocks"][1]["fc2"],
         bridged["sam"]["image_encoder"]["window_blocks"][1]["fc2"]),
        (params["core"]["vision"]["layers"][0]["q_proj"],
         bridged["core"]["vision"]["layers"][0]["q_proj"]),
        (params["sam"]["image_encoder"]["patch_proj"], bridged["sam"]["image_encoder"]["patch_proj"]),
    ):
        assert torch.equal(mine["q"], theirs["q"]) and torch.equal(mine["scale"], theirs["scale"])
    assert "int8" not in str(jax.tree_util.tree_map(lambda t: t.dtype, params["sam"]["mask_decoder"]))

    batch = res_batch(cfg, np.random.default_rng(9), [12, 10])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    gc = generate.GenerateConfig(max_new_tokens=6, temperature=0.0)
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


def test_unported_layouts_and_forms_raise(monkeypatch):
    for layout in ("resident", "auto", "block"):
        assert image_encoder.SamVisionConfig(window_layout=layout).window_layout == layout
    with pytest.raises(ValueError):
        image_encoder.SamVisionConfig(window_layout="packed")
    assert image_encoder.SamVisionConfig().window_layout == "auto"
    # `attn_dots_i8` is ported: the config builds, and the encoder hands
    # the flag to the window, boundary and lane-sliced global attention.
    seen = []

    def spy(name):
        real = getattr(sam_attention, name)

        def call(*args, **kw):
            seen.append((name, kw.get("dots_i8")))
            return real(*args, **kw)
        return call

    for name in ("fused_window_attention_grid", "fused_window_attention_rect",
                 "fused_global_attention_y"):
        monkeypatch.setattr(image_encoder, name, spy(name))
    jcfg, cfg = _encoder_cfgs(window_size=3, attn_dots_i8=True)
    assert cfg.attn_dots_i8
    _, params = _quantized_encoder(jcfg, seed=13)
    img = _t(np.random.default_rng(13).standard_normal((1, 512, 512, 3)).astype(np.float32))
    for layout in ("block", "resident"):
        seen.clear()
        image_encoder.encode(params, dataclasses.replace(cfg, window_layout=layout), img)
        names = {"fused_window_attention_grid", "fused_global_attention_y"} | (
            {"fused_window_attention_rect"} if layout == "resident" else set())
        assert {n for n, _ in seen} == names and all(flag is True for _, flag in seen), seen
