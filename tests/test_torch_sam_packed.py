"""Parity of the port's SAM packed attention layout with the JAX package:
`pack_sam_attention` leaf for leaf (fp32 and int8 leaves, through
`bridge.params_from_jax`), the packed encoder against JAX `encode` with
its Pallas kernels in interpret mode and against the port's unpacked
encoder, the refusal of packed int8 weights at a fused global block, the
plain versions of the four kernels of this layout and of the two kernels
no path calls against the Pallas kernels in interpret mode, and one tiny
serve with a packed SAM encoder against JAX `evaluate`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from torch_port_helpers import res_batch as _batch
from ullava_tpu.models import generate as jgen
from ullava_tpu.models import ullava as jullava
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import decode_attention as jdec
from ullava_tpu.ops import quant as jquant
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import generate, ullava
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import decode_attention, sam_attention
from ullava_tpu_torch.serve import serve

# fp32 through the blocks and the neck; sums run in different orders.
ATOL = RTOL = 2e-4


def setup_module():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def _cfgs(**kw):
    """JAX (Pallas in interpret mode) and port encoder configs, fp32; the
    defaults are `tests/test_sam.py:440-444`'s packed setup."""
    base = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, out_chans=32,
                window_size=2, global_attn_indexes=(0, 1))
    base.update(kw)
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel="pallas_interpret")
    return jcfg, image_encoder.SamVisionConfig(**base, dtype=torch.float32)


def _encoder(jcfg, seed, int8=False):
    """A JAX encoder tree from a numpy seed (rel-pos tables, positions and
    biases random too), int8 qkv/proj/fc1/fc2/patch_proj if `int8`."""
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, seed, std=0.2))
    if int8:
        jp = jquant.quantize_tree(jp, jquant.SAM_ENCODER_QUANT_KEYS)
    return jp


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_tree(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same_tree(g, r, f"{path}/{i}")
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert torch.equal(got, ref), path


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_pack_sam_attention_matches_jax_leaf_for_leaf(int8):
    """Exact: the packing is a relayout with zero (q, rel_pos, bias) and
    one (int8 scale) pads. The JAX packed tree also converts through the
    bridge as it is, int8 leaves included, with `q` column-major."""
    jcfg, cfg = _cfgs(depth=4, window_size=2, global_attn_indexes=(1, 3))
    jp = _encoder(jcfg, seed=1, int8=int8)
    jpacked = params_from_jax(_np(jie.pack_sam_attention(jp, jcfg, head_pad=32)), device="cpu")
    packed = image_encoder.pack_sam_attention(params_from_jax(_np(jp), device="cpu"), cfg,
                                              head_pad=32)
    _assert_same_tree(packed, jpacked)
    blk = packed["window_blocks"][0]
    H, hp, C = 4, 32, 64
    qkv = blk["qkv"]["q"] if int8 else blk["qkv"]
    proj = blk["proj"]["q"] if int8 else blk["proj"]
    assert qkv.shape == (C, 3 * H * hp) and proj.shape == (H * hp, C)
    assert blk["rel_pos_h"].shape[-1] == hp and image_encoder._is_packed(blk, cfg)
    if int8:
        assert qkv.dtype == torch.int8 and qkv.stride() == (1, C)
        assert proj.stride() == (1, H * hp)
        assert torch.all(blk["qkv"]["scale"].reshape(3, H, hp)[..., 16:] == 1.0)
    assert torch.all(qkv.reshape(C, 3, H, hp)[..., 16:] == 0)
    # A head_dim that fills the pad already: the tree comes back as it is.
    assert image_encoder.pack_sam_attention(packed, cfg, head_pad=16) is packed


@pytest.mark.parametrize("kw", [
    {},
    dict(img_size=68, patch_size=4, depth=4, window_size=3, global_attn_indexes=(1, 3)),
], ids=["windows_only", "grid17_global"])
def test_encode_packed_matches_jax_interpret_and_unpacked(kw):
    """fp32, head_pad 32 (head_dim 16). `windows_only` is the JAX tests'
    setup: two global blocks at grid 4, which the size <= 16 dispatch sends
    to the packed window kernel. `grid17_global` adds window blocks (grid
    17, window 3: padded after LN1 in the block layout, which packed
    weights always take) and global blocks at grid 17, through the packed
    global kernel. Against JAX `encode` of the same packed weights at
    2e-4; against the port's unpacked encode of the same weights at atol
    1e-5 (`tests/test_sam.py:419`): the pads add exact zeros."""
    jcfg, cfg = _cfgs(**kw)
    jp = _encoder(jcfg, seed=2)
    jpacked = jie.pack_sam_attention(jp, jcfg, head_pad=32)
    params = params_from_jax(_np(jp), device="cpu")
    packed = image_encoder.pack_sam_attention(params, cfg, head_pad=32)
    img = np.random.default_rng(2).standard_normal((2, cfg.img_size, cfg.img_size, 3)).astype(
        np.float32)
    ref = jax.jit(jie.encode, static_argnums=1)(jpacked, jcfg, jnp.asarray(img))
    got = image_encoder.encode(packed, cfg, _t(img))
    assert got.shape == (2, cfg.grid, cfg.grid, 32)
    if packed["window_blocks"]:  # "auto" is resident for these weights unpacked, not packed
        assert image_encoder._use_resident(cfg, params["window_blocks"][0])
        assert not image_encoder._use_resident(cfg, packed["window_blocks"][0])
    _close(got, ref)
    unpacked = image_encoder.encode(params, dataclasses.replace(cfg, window_layout="block"), _t(img))
    _close(got, unpacked.numpy(), atol=1e-5, rtol=0)


def test_encode_packed_int8_matches_jax_interpret_and_unpacked():
    """`tests/test_sam.py:421-431`'s int8 case (qkv, proj, fc1, fc2 and
    patch_proj int8, weight-only), where `_use_global_fused` is off (grid
    4): packed against JAX `encode` in interpret mode, and against the
    port's unpacked int8 encoder at atol 1e-5."""
    jcfg, cfg = _cfgs()
    jq = _encoder(jcfg, seed=3, int8=True)
    params = params_from_jax(_np(jq), device="cpu")
    packed = image_encoder.pack_sam_attention(params, cfg, head_pad=32)
    assert not image_encoder._use_global_fused(packed["global_blocks"][0], cfg, cfg.grid)
    img = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jie.encode, static_argnums=1)(
        jie.pack_sam_attention(jq, jcfg, head_pad=32), jcfg, jnp.asarray(img))
    got = image_encoder.encode(packed, cfg, _t(img))
    _close(got, ref)
    _close(got, image_encoder.encode(params, cfg, _t(img)).numpy(), atol=1e-5, rtol=0)


def test_packed_int8_fused_global_block_is_refused_as_in_jax():
    """Packed int8 qkv/proj at a global block that the fused int8 route
    takes (grid 32 > 16, S = 1024): the JAX package's `_attn_global_fused`
    reshapes the packed qkv output to 3*C and fails; the port refuses the
    same configuration with a ValueError that says so."""
    jcfg, cfg = _cfgs(img_size=512, depth=1, global_attn_indexes=(0,))
    jq = _encoder(jcfg, seed=4, int8=True)
    packed = image_encoder.pack_sam_attention(params_from_jax(_np(jq), device="cpu"), cfg,
                                              head_pad=32)
    assert image_encoder._use_global_fused(packed["global_blocks"][0], cfg, cfg.grid)
    img = np.random.default_rng(4).standard_normal((1, 512, 512, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="JAX package fails here too"):
        image_encoder.encode(packed, cfg, _t(img))
    with pytest.raises((TypeError, ValueError), match="reshape"):
        jie.encode(jie.pack_sam_attention(jq, jcfg, head_pad=32), jcfg, jnp.asarray(img))


def _packed_case(rng, N, H, hp, hd, W, dtype):
    """A packed projection output with zero pad lanes and raw bias terms
    of the size the encoder makes (a few units), in `dtype`."""
    S = W * W
    y = np.zeros((N, S, 3, H, hp), np.float32)
    y[..., :hd] = rng.standard_normal((N, S, 3, H, hd))
    a, b = (2.0 * rng.standard_normal((N, H, S, W)).astype(np.float32) for _ in range(2))
    y = y.reshape(N, S, 3 * H * hp)
    if dtype == "bf16":  # round once, hand both sides the same values
        y, a, b = (np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (y, a, b))
    return y, a, b


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return _t(a)


# bf16 outputs: both sides round p and the output to bf16 from fp32 sums
# taken in different orders, so an element may land one bf16 step apart
# (2^-8 of its value); fp32: summation order only.
_TOLS = {"fp32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_window_attention_packed_plain_matches_jax_interpret(dtype):
    """ViT-H's window (14 x 14) and head pad (128) over 80 real lanes, two
    windows of two heads (`tests/test_sam.py:255-286`'s window)."""
    N, H, hp, hd, W = 2, 2, 128, 80, 14
    y, a, b = _packed_case(np.random.default_rng(5), N, H, hp, hd, W, dtype)
    kw = dict(num_heads=H, head_pad=hp, window=W, scale=hd**-0.5)
    ref = jsam.fused_window_attention_packed(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b),
                                             interpret=True, **kw)
    got = sam_attention.fused_window_attention_packed(*(_to_torch(t) for t in (y, a, b)), **kw)
    assert got.shape == (N, W * W, H * hp) and got.dtype == _to_torch(y).dtype
    _close(got, np.asarray(ref, np.float32), **_TOLS[dtype])
    # Pad lanes of the output are exact zeros (zero v lanes).
    assert torch.all(got.reshape(N, W * W, H, hp)[..., hd:] == 0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_global_attention_packed_plain_matches_jax_interpret(dtype):
    """A 32 x 32 grid (S = 1024) with the TPU kernel's tiles at 256, so its
    online softmax spans four key tiles; the plain version takes one
    softmax over all keys."""
    B, H, hp, hd, W = 1, 2, 128, 80, 32
    y, a, b = _packed_case(np.random.default_rng(6), B, H, hp, hd, W, dtype)
    kw = dict(num_heads=H, head_pad=hp, window=W, scale=hd**-0.5)
    ref = jsam.fused_global_attention_packed(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b),
                                             block_q=256, block_k=256, interpret=True, **kw)
    got = sam_attention.fused_global_attention_packed(*(_to_torch(t) for t in (y, a, b)), **kw)
    assert got.shape == (B, W * W, H * hp)
    _close(got, np.asarray(ref, np.float32), **_TOLS[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_window_attention_plain_matches_jax_interpret(dtype):
    """The per-(window, head) kernel at `tests/test_sam.py:255-286`'s
    shapes: window 14, hd 80, two (window, head) pairs, the bias terms from
    `decomposed_bias_terms` of the unscaled q."""
    rng = np.random.default_rng(7)
    N, W, hd = 2, 14, 80
    S = W * W
    q, k, v = (rng.standard_normal((N, S, hd)).astype(np.float32) for _ in range(3))
    rh, rw = (0.1 * rng.standard_normal((2 * W - 1, hd)).astype(np.float32) for _ in range(2))
    A, Bb = jsam.decomposed_bias_terms(jnp.asarray(q).reshape(1, N, W, W, hd), jnp.asarray(rh),
                                       jnp.asarray(rw), W)
    ins = [q, k, v, np.asarray(A).reshape(N, S, W), np.asarray(Bb).reshape(N, S, W)]
    if dtype == "bf16":
        ins = [np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in ins]
    ref = jsam.fused_window_attention(*(jnp.asarray(t) for t in ins), window=W, scale=hd**-0.5,
                                      interpret=True)
    got = sam_attention.fused_window_attention(*(_to_torch(t) for t in ins), window=W,
                                               scale=hd**-0.5)
    _close(got, np.asarray(ref, np.float32), **_TOLS[dtype])


def _decode_case(rng, L=3, B=2, S=256, H=4, Hkv=4, hd=128, lens=None):
    """`tests/test_decode_attention.py:19-28`'s case, with Hkv kv heads:
    rows past kv_lens hold data too (stale rows the mask must hide)."""
    q = jnp.asarray(rng.standard_normal((B, 1, H, hd)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((L, B, S, Hkv, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((L, B, S, Hkv, hd)), jnp.float32)
    kq, ks = jdec.quantize_kv_rows(k)
    vq, vs = jdec.quantize_kv_rows(v)
    lens = jnp.asarray(lens or [S, S // 2 + 3], jnp.int32)
    return q, kq.reshape(L, B, S, Hkv * hd), vq.reshape(L, B, S, Hkv * hd), ks, vs, lens


@pytest.mark.parametrize("case", [
    dict(layer=1, dtype="fp32"),
    dict(layer=2, dtype="fp32", S=96),
    dict(layer=0, dtype="bf16", S=128),
    dict(layer=1, dtype="fp32", B=4, Hkv=2, lens=[256, 1, 77, 200]),
    dict(layer=2, dtype="bf16", B=4, H=8, Hkv=2, S=64, lens=[64, 5, 33, 0]),
], ids=["fp32", "fp32_short", "bf16", "gqa_ragged", "gqa_bf16_empty_row"])
def test_decode_attention_int8_plain_matches_jax_interpret(case):
    """`tests/test_decode_attention.py:30-51, 172-190`'s cases, plus GQA
    with ragged kv_lens (one row with a single live position and, in bf16,
    one with none: every position masked alike, a uniform average as in
    the TPU kernel). Limits: fp32 2e-5 (`tests/test_decode_attention.py`);
    bf16 one bf16 step of the output (p * v_scale is rounded to bf16 on
    both sides from fp32 sums in different orders)."""
    case = dict(case)
    layer, dtype = case.pop("layer"), case.pop("dtype")
    q, kq, vq, ks, vs, lens = _decode_case(np.random.default_rng(8), **case)
    if dtype == "bf16":
        q = q.astype(jnp.bfloat16)
    hd = q.shape[-1]
    ref = jdec.decode_attention_int8(q, kq, vq, ks, vs, lens, jnp.int32(layer), scale=hd**-0.5,
                                     interpret=True)
    tq = _to_torch(q)
    got = decode_attention.decode_attention_int8(
        tq, *(_to_torch(t) for t in (kq, vq, ks, vs, lens)), layer, scale=hd**-0.5)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    tol = dict(atol=2e-5, rtol=0) if dtype == "fp32" else dict(atol=1e-2, rtol=1e-2)
    _close(got, np.asarray(ref, np.float32), **tol)
    if dtype == "fp32":  # the XLA-form reference agrees where a row is live
        xla = decode_attention.decode_attention_int8_xla(
            tq, *(_to_torch(t) for t in (kq, vq, ks, vs, lens)), layer, scale=hd**-0.5)
        _close(got, xla.numpy(), atol=2e-5, rtol=0)


def test_serve_with_packed_sam_encoder_matches_jax_evaluate():
    """One `serve.serve` of the tiny model with its SAM image encoder packed
    to head_pad 32 against JAX `evaluate` of the same packed weights
    (Pallas in interpret mode), as `tests/test_torch_ullava.py` holds the
    unpacked serve."""
    jcfg = jullava.UllavaConfig.tiny()
    jcfg = dataclasses.replace(jcfg, sam=dataclasses.replace(jcfg.sam, vision=dataclasses.replace(
        jcfg.sam.vision, attn_kernel="pallas_interpret")))
    cfg = ullava.UllavaConfig.tiny()
    jparams = random_params(jullava.init_params, jcfg, seed=5)
    params = params_from_jax(jparams, device="cpu")
    batch = _batch(cfg, np.random.default_rng(5), [12, 10])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    gc = generate.GenerateConfig(max_new_tokens=6)
    first = ullava.evaluate(params, cfg, gc, **tbatch)
    seg = int(first["sequences"][0, 14])  # a token the model generates: the [SEG] path is live
    cfg = dataclasses.replace(cfg, seg_token_idx=seg)
    jcfg = dataclasses.replace(jcfg, seg_token_idx=seg)

    jenc = jax.tree_util.tree_map(jnp.asarray, jparams["sam"]["image_encoder"])
    jparams["sam"]["image_encoder"] = _np(jie.pack_sam_attention(jenc, jcfg.sam.vision, head_pad=32))
    params["sam"]["image_encoder"] = image_encoder.pack_sam_attention(
        params["sam"]["image_encoder"], cfg.sam.vision, head_pad=32)
    assert image_encoder._is_packed(params["sam"]["image_encoder"]["window_blocks"][0],
                                    cfg.sam.vision)
    jgc = jgen.GenerateConfig(max_new_tokens=6, temperature=0.0)
    ref = jax.jit(jullava.evaluate, static_argnums=(1, 2))(
        jparams, jcfg, jgc, **{k: jnp.asarray(v) for k, v in batch.items()})
    requests = [dict(input_ids=batch["input_ids"][b, :n], image=batch["images"][b],
                     image_sam=batch["images_sam"][b])
                for b, n in enumerate(batch["prompt_lens"])]
    served = serve((cfg, params), requests, device="cpu", gen=gc)
    lens = np.asarray(ref["lengths"]).tolist()
    assert served["sequences"] == [np.asarray(ref["sequences"])[b, :n].tolist()
                                   for b, n in enumerate(lens)]
    assert bool(np.asarray(ref["seg_valid"])[0, 0])
    _close(served["low_res_masks"], ref["low_res_masks"])
    _close(served["pred_boxes"], ref["pred_boxes"])
    assert served["launches"] == dict.fromkeys(served["launches"], 0)  # CPU: plain versions
