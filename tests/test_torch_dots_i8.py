"""Parity of the port's all-int8 serving configuration with the JAX package
on the CPU: the int8 score form (`dots_i8`) of the window kernel and the
pre-pass of the global one (bit for bit against `_rq_rows`), the flash
forward at head_dim 64 (the CLIP tower's), the SAM encoder with
`attn_dots_i8` in both window layouts, and `evaluate` with every int8 knob
on (`attn_dots_i8`, CLIP `a8` and `attn_impl="flash"`). The same numpy
inputs go through the JAX function (its Pallas kernels in interpret mode)
and the port's plain version.

Tolerances. `dots_i8` quantizes q, k and each row's bias terms to int8 on
both sides with the same arithmetic; a value within fp32 reassociation of
a rounding tie may take the neighbouring code in one framework, which
moves a score by about 1/127 of one term: `dots_i8` outputs are held to
2e-2 of the largest value, the limit of the other int8-score tests
(`test_torch_sam_int8.py`, `test_torch_sam_resident.py`). Flash paths
without int8 are held to 3e-4 (fp32 summation order).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params, res_batch
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import quant as jquant
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import attention, sam_attention

I8 = 2e-2
# The module, not the function of the same name that `ullava_tpu.ops` exports.
jattn = importlib.import_module("ullava_tpu.ops.attention")


def setup_module():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_i8(got, ref, rows=slice(None)):
    got, ref = np.asarray(got, np.float32)[:, rows], np.asarray(ref, np.float32)[:, rows]
    err, top = np.abs(got - ref), np.abs(ref).max()
    assert err.max() <= I8 * top, (err.max(), top)
    return err.max() / top


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_global_y_quant_i8_plain_matches_jax_rq_rows_bit_for_bit(dtype):
    """The pre-pass of K11's int8 form (`global_y_quant_i8_plain`, every
    row quantized once) against the TPU kernel's `_rq_rows` on each
    head's q and k rows and each row's [A | B] (`ullava_tpu/ops/
    sam_attention.py:596-604`): codes, scales and the code pads, exact."""
    rng = np.random.default_rng(7)
    B, S, H, hd, W = 2, 64, 3, 80, 8
    y = rng.standard_normal((B, S, 3 * H * hd)).astype(np.float32)
    a, b = (20.0 * rng.standard_normal((B, S, H, W)).astype(np.float32) for _ in range(2))
    a[0, 0] = 0.0  # an all-zero row: the 1e-12 floor
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jy, ja, jb = (jnp.asarray(t, jdt) for t in (y, a, b))
    ty, ta, tb = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(tdt) for t in (jy, ja, jb))
    codes, scales, ac, bc, abss = sam_attention.global_y_quant_i8_plain(ty, ta, tb, H, hd)
    for sec in range(2):
        for h in range(H):
            q, s = jsam._rq_rows(jy[:, :, (sec * H + h) * hd:(sec * H + h + 1) * hd])
            np.testing.assert_array_equal(codes[sec, :, h, :, :hd].numpy(), np.asarray(q))
            np.testing.assert_array_equal(scales[sec, :, h].numpy(), np.asarray(s)[..., 0])
    assert not codes[..., hd:].any()
    q, s = jsam._rq_rows(jnp.concatenate([ja, jb], axis=-1))
    np.testing.assert_array_equal(ac.float().numpy(), np.asarray(q[..., :W], np.float32))
    np.testing.assert_array_equal(bc.float().numpy(), np.asarray(q[..., W:], np.float32))
    np.testing.assert_array_equal(abss.numpy(), np.asarray(s)[..., 0].transpose(0, 2, 1))
    assert ac.dtype == tdt


@pytest.mark.parametrize("total_rows", [0, 200], ids=["block_196", "padded_200"])
def test_fused_window_attention_grid_dots_i8_matches_jax(total_rows):
    """K3's int8 score form at the ViT-H window (W 14): 196 tokens a
    window, or stored as 200 rows with the last four left out as keys. Real
    query rows are compared; the pad rows are finite and do not matter."""
    rng = np.random.default_rng(0)
    N, H, hd, W = 3, 2, 16, 14
    S = total_rows or W * W
    y = rng.standard_normal((N, S, 3 * H * hd)).astype(np.float32)
    a, b = ((0.4 * hd**0.5 * rng.standard_normal((N, S, H * W))).astype(np.float32)
            for _ in range(2))
    kw = dict(num_heads=H, head_dim=hd, window=W, scale=hd**-0.5)
    ref = jsam.fused_window_attention_grid(
        jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), **kw, dots_i8=True,
        total_rows=total_rows, interpret=True)
    got = sam_attention.fused_window_attention_grid(
        _t(y), _t(a), _t(b), **kw, total_rows=total_rows, dots_i8=True)
    assert got.shape == (N, S, H * hd) and torch.isfinite(got).all()
    _close_i8(got.numpy(), ref, slice(0, W * W))
    # Another function than the bf16-score form, close to it.
    exact = sam_attention.fused_window_attention_grid(
        _t(y), _t(a), _t(b), **kw, total_rows=total_rows)
    diff = (exact - got)[:, :W * W].abs().max().item()
    assert 0 < diff < 5e-2
    # The pad rows' content changes no real row.
    if total_rows:
        y2 = y.copy()
        y2[:, W * W:] += 5.0
        again = sam_attention.fused_window_attention_grid(
            _t(y2), _t(a), _t(b), **kw, total_rows=total_rows, dots_i8=True)
        assert torch.equal(again[:, :W * W], got[:, :W * W])


@pytest.mark.parametrize("causal", [False, True], ids=["clip", "causal"])
def test_flash_attention_fwd_bsh_hd64_matches_jax(causal):
    """K2 at head_dim 64 with ragged kv_lens: CLIP's use (not causal, 257
    live keys of 264) and the causal form the same entry takes."""
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 264, 4, 64
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    lens = np.asarray([257, 200], np.int32)
    ref = jattn.flash_attention_fwd_bsh(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(lens), causal=causal,
        scale=hd**-0.5, block_q=128, block_k=128, interpret=True)
    got = attention.flash_attention_fwd_bsh(
        _t(q), _t(k), _t(v), _t(lens), causal=causal, scale=hd**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4, rtol=3e-4)
    # The pad keys are left out: changing them changes nothing.
    k2, v2 = k.copy(), v.copy()
    k2[0, 257:] += 3.0
    v2[0, 257:] -= 3.0
    again = attention.flash_attention_fwd_bsh(
        _t(q), _t(k2), _t(v2), _t(lens), causal=causal, scale=hd**-0.5)
    assert torch.equal(again, got)


def _quantized(jcfg, seed, composite):
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, seed))
    jq = jquant.quantize_tree(jparams, jquant.SAM_ENCODER_QUANT_KEYS)
    if composite:
        jq = jie.precompute_window_bias_weights(jq, jcfg)
    return jq, params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")


_LAYOUTS = {
    # Grid 32, window 14 (padded to 42 after LN1), two heads of 64: the
    # window block through K3, the global block through fused LN+qkv, K11
    # (`exp_bf16` with int8 scores) and fused proj, the MLPs fused.
    "block": dict(img_size=512, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                  out_chans=16, window_size=14, global_attn_indexes=(1,),
                  window_layout="block"),
    # Grid 4, window 3: the full class through K3 (9 tokens stored as 16
    # rows), the right and bottom classes through one dual-geometry K14
    # call and the corner through another, with composite bias weights.
    "resident": dict(img_size=64, patch_size=16, embed_dim=32, depth=4, num_heads=2,
                     out_chans=16, window_size=3, global_attn_indexes=(1, 3),
                     window_layout="resident"),
}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_encode_attn_dots_i8_matches_jax(layout):
    """The int8 encoder (`mlp_w8a8`) with `attn_dots_i8` against the JAX
    encoder with the same knobs. Int8 activations and int8 scores on both
    sides: `I8` of the largest embedding value, the bulk (median) within
    1e-3 of it. The knob changes the function: the bf16-score encoder
    differs by more than that bulk."""
    base = _LAYOUTS[layout]
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, mlp_w8a8=True, attn_dots_i8=True,
                               attn_kernel="pallas_interpret")
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32, mlp_w8a8=True,
                                        attn_dots_i8=True)
    jq, params = _quantized(jcfg, seed=11, composite=layout == "resident")
    img = np.random.default_rng(11).standard_normal(
        (1 if layout == "block" else 2, base["img_size"], base["img_size"], 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jie.encode, static_argnums=1)(jq, jcfg, jnp.asarray(img)))
    got = image_encoder.encode(params, cfg, _t(img)).numpy()
    err, top = np.abs(got - ref), np.abs(ref).max()
    assert err.max() <= I8 * top, (err.max(), top)
    assert np.median(err) <= 1e-3 * top, (np.median(err), top)
    bf16_scores = image_encoder.encode(
        params, dataclasses.replace(cfg, attn_dots_i8=False), _t(img)).numpy()
    assert np.abs(got - bf16_scores).max() > np.median(err)


def test_evaluate_all_int8_matches_jax(monkeypatch):
    """The whole slice: RES `evaluate` with the int8 LLM (W8A8 prefill, int8
    KV cache), the int8 CLIP tower with `a8` and `attn_impl="flash"` (128
    wide, two heads of 64: the 5 tokens padded to 8), and the int8 SAM
    encoder with `mlp_w8a8` and `attn_dots_i8` in the resident layout with
    composite bias weights (window 3: all four classes). The JAX package
    takes the CLIP knobs only on a TPU, so its `_on_tpu` answers True in
    this test (and its flash runs in interpret mode); its sources are
    untouched. Greedy tokens must be equal; masks and boxes within 2e-2,
    the `dots_i8` limit, as the encoder's int8 scores reach them."""
    from ullava_tpu.models import clip_vit as jclip
    from ullava_tpu.models import generate as jgen
    from ullava_tpu.models import llama as jllama
    from ullava_tpu.models import ullava as jullava
    from ullava_tpu_torch.models import clip_vit, generate, llama, ullava

    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    kw = dict(vocab_size=160, a8_prefill=True, kv_quant=True)
    clip = dict(hidden_size=128, num_heads=2)
    sam = dict(window_size=3, mlp_w8a8=True, attn_dots_i8=True)
    jcfg = jullava.UllavaConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg,
        core=dataclasses.replace(
            jcfg.core, llm=jllama.LlamaConfig.tiny(**kw),
            vision=jclip.CLIPVisionConfig.tiny(**clip, a8=True, attn_impl="flash_interpret")),
        sam=dataclasses.replace(jcfg.sam, vision=dataclasses.replace(
            jcfg.sam.vision, **sam, attn_kernel="pallas_interpret", window_layout="resident")),
    )
    cfg = ullava.UllavaConfig.tiny()
    cfg = dataclasses.replace(
        cfg,
        core=dataclasses.replace(
            cfg.core, llm=llama.LlamaConfig.tiny(**kw),
            vision=clip_vit.CLIPVisionConfig.tiny(**clip, a8=True, attn_impl="flash")),
        sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(cfg.sam.vision, **sam)),
    )
    raw = random_params(jullava.init_params, jcfg, seed=12)
    jparams = jax.tree_util.tree_map(jnp.asarray, raw)
    jparams["core"]["llm"] = jquant.quantize_tree(jparams["core"]["llm"], jquant.LLAMA_QUANT_KEYS)
    jparams["core"]["vision"] = jquant.quantize_tree(
        jparams["core"]["vision"], jquant.CLIP_QUANT_KEYS)
    jparams["sam"]["image_encoder"] = jie.precompute_window_bias_weights(
        jquant.quantize_tree(jparams["sam"]["image_encoder"], jquant.SAM_ENCODER_QUANT_KEYS),
        jcfg.sam.vision)
    params = ullava.precompute_window_bias_weights(
        ullava.quantize_towers(ullava.quantize_llm(params_from_jax(raw, device="cpu"))), cfg)

    batch = res_batch(cfg, np.random.default_rng(12), [12, 10])
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
        got, want = out[key].numpy(), np.asarray(ref[key])
        assert np.abs(got - want).max() <= I8 * max(np.abs(want).max(), 1.0), key
