"""The port's configuration knobs that the JAX package's configs carry and
every `bench.py` preset sets, held to the JAX package on the CPU:

- `LlamaConfig.rope_f32`, `max_position_embeddings` and `attn_impl="auto"`
  (`ullava_tpu/models/llama.py:43, 52, 58`): `apply_rotary` in bf16 bit for
  bit, and a bf16 tiny LLaMA at `rope_f32=False` (prefill logits, a decode
  step, a training loss), each rotation inside a decode step and a
  training forward bit for bit at its setting; "auto" takes the plain path
  on CPU tensors, as the JAX package does off the TPU;
- `SamVisionConfig.attn_kernel` (`ullava_tpu/models/sam/image_encoder.py:56`,
  `_use_pallas` :243-254): the configuration of `tests/test_sam.py:392-431`,
  packed int8 weights with `attn_kernel="xla"`, against JAX `encode`, and
  "xla" through plain attention alone, on any device (no SAM attention
  wrapper is called).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models import llama as jllama
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import quant as jquant
from ullava_tpu.ops import rope as jrope
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import llama
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import attention, rope


def setup_module():
    torch.set_num_threads(1)


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _bf16_torch(x):
    return torch.from_numpy(_f32(x)).to(torch.bfloat16)


def test_llama_config_fields_match_jax():
    jcfg, cfg = jllama.LlamaConfig(), llama.LlamaConfig()
    for name in ("max_position_embeddings", "rope_f32", "attn_impl"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.attn_impl == "auto" and cfg.rope_f32 and cfg.max_position_embeddings == 2048
    assert (llama.LlamaConfig.tiny().max_position_embeddings
            == jllama.LlamaConfig.tiny().max_position_embeddings == 256)


@pytest.mark.parametrize("compute", ["bf16", "fp32"])
def test_apply_rotary_compute_dtype_matches_jax_bit_for_bit(compute):
    """bf16 q/k rotated with the same tables: in bf16 each product and sum
    rounds to bf16 on both sides; in fp32 (the default) once at the end."""
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((2, 9, 4, 64)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((2, 9, 2, 64)), jnp.bfloat16)
    cos, sin = jrope.rope_cos_sin(jnp.asarray(np.arange(9)[None].repeat(2, 0)), 64)
    jdt, dt = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (None, None)
    jq, jk = jrope.apply_rotary(q, k, cos, sin, compute_dtype=jdt)
    tq, tk = rope.apply_rotary(_bf16_torch(q), _bf16_torch(k), torch.from_numpy(_f32(cos)),
                               torch.from_numpy(_f32(sin)), compute_dtype=dt)
    assert tq.dtype == tk.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.float().numpy(), _f32(jq))
    np.testing.assert_array_equal(tk.float().numpy(), _f32(jk))


# bf16 through two layers on both sides, rounding at different places
# (products, the softmax, the norms): a logit may move a few bf16 steps of
# the largest logit (one step is 2^-8 of it); the training loss, a mean of
# fp32 log-sum-exps, agrees far closer.
LOGIT_TOL, LOSS_TOL = 3e-2, 1e-3


def _max_rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_llama_rope_f32_false_bf16_matches_jax():
    """`rope_f32=False` in a bf16 tiny config: the prefill (whose fused
    rotary stays fp32 in both packages' serving kernels; the JAX package
    off the TPU rotates in bf16 there, inside the tolerance), one decode
    step and the training loss, which rotate in bf16 on both sides."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.bfloat16, rope_f32=False)
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, rope_f32=False)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                random_params(jllama.init_params, jllama.LlamaConfig.tiny(), 0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    B, S, total = 2, 7, 11
    ids = rng.integers(0, jcfg.vocab_size, size=(B, S))
    lens = np.array([7, 4], np.int32)
    cache = llama.init_kv_cache(cfg, B, total, device="cpu")
    jout = jllama.forward(jp, jcfg, input_ids=jnp.asarray(ids), kv_lens=jnp.asarray(lens),
                          kv_cache=jllama.init_kv_cache(jcfg, B, total))
    out = llama.forward(params, cfg, input_ids=torch.as_tensor(ids),
                        kv_lens=torch.as_tensor(lens), kv_cache=cache)
    for b, n in enumerate(lens):
        assert _max_rel(out["logits"][b, :n].float().numpy(),
                        _f32(jout["logits"])[b, :n]) <= LOGIT_TOL

    pos = lens.copy()
    tok = rng.integers(0, jcfg.vocab_size, size=(B, 1))
    jout = jllama.forward(jp, jcfg, input_ids=jnp.asarray(tok), positions=jnp.asarray(pos[:, None]),
                          kv_lens=jnp.asarray(pos + 1), kv_cache=jout["kv_cache"],
                          write_pos=jnp.asarray(pos))
    out = llama.forward(params, cfg, input_ids=torch.as_tensor(tok),
                        positions=torch.as_tensor(pos[:, None]), kv_lens=torch.as_tensor(pos + 1),
                        kv_cache=cache, write_pos=torch.as_tensor(pos))
    assert _max_rel(out["logits"].float().numpy(), _f32(jout["logits"])) <= LOGIT_TOL

    ids2 = rng.integers(0, jcfg.vocab_size, size=(B, 16))
    lens2 = np.array([16, 12], np.int32)

    def jloss(p):
        lg = jllama.forward(p, jcfg, input_ids=jnp.asarray(ids2),
                            kv_lens=jnp.asarray(lens2))["logits"].astype(jnp.float32)
        picked = jnp.take_along_axis(lg, jnp.asarray(ids2)[..., None], -1)[..., 0]
        return jnp.mean(jax.nn.logsumexp(lg, -1) - picked)

    with torch.enable_grad():
        lg = llama.forward(params, cfg, input_ids=torch.as_tensor(ids2),
                           kv_lens=torch.as_tensor(lens2))["logits"].float()
        loss = (torch.logsumexp(lg, -1) - lg.gather(-1, torch.as_tensor(ids2)[..., None])[..., 0]).mean()
    ref = float(jloss(jp))
    assert abs(float(loss) - ref) <= LOSS_TOL * abs(ref)


@pytest.mark.parametrize("rope_f32", [False, True])
def test_llama_rope_f32_reaches_decode_and_training(rope_f32, monkeypatch):
    """Every rotation `_layer` makes in a decode step and in a training
    forward (the cache-less path) is JAX `apply_rotary` at the config's
    setting bit for bit, and at the other setting it is not: the knob, not
    the tolerance, decides."""
    calls = []
    real = llama.apply_rotary

    def spy(q, k, cos, sin, compute_dtype=None):
        out = real(q, k, cos, sin, compute_dtype=compute_dtype)
        calls.append((q, k, cos, sin, out))
        return out

    monkeypatch.setattr(llama, "apply_rotary", spy)
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, rope_f32=rope_f32)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                random_params(jllama.init_params, jllama.LlamaConfig.tiny(), 2))
    params = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 2, 6
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S)))
    lens = torch.tensor([6, 4], dtype=torch.int32)
    cache = llama.init_kv_cache(cfg, B, S + 1, device="cpu")
    llama.forward(params, cfg, input_ids=ids, kv_lens=lens, kv_cache=cache)
    assert not calls  # the serving prefill rotates inside K1
    llama.forward(params, cfg, input_ids=ids[:, :1], positions=lens[:, None].long(),
                  kv_lens=lens + 1, kv_cache=cache, write_pos=lens.long())
    with torch.enable_grad():
        llama.forward(params, cfg, input_ids=ids, kv_lens=lens)
    assert len(calls) == 2 * cfg.num_layers
    own, other = (None, jnp.bfloat16) if rope_f32 else (jnp.bfloat16, None)
    differs = False
    for q, k, cos, sin, (tq, tk) in calls:
        args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k)]
        args += [jnp.asarray(t.float().numpy()) for t in (cos, sin)]
        jq, jk = jrope.apply_rotary(*args, compute_dtype=own)
        np.testing.assert_array_equal(tq.float().numpy(), _f32(jq))
        np.testing.assert_array_equal(tk.float().numpy(), _f32(jk))
        oq, ok = jrope.apply_rotary(*args, compute_dtype=other)
        differs |= not (np.array_equal(tq.float().numpy(), _f32(oq))
                        and np.array_equal(tk.float().numpy(), _f32(ok)))
    assert differs


@pytest.mark.parametrize("sq,hd,kv_heads", [(128, 128, 2), (16, 128, 2), (128, 64, 2), (128, 128, 1)],
                         ids=["flash_shape", "short", "hd64", "gqa"])
def test_attention_auto_takes_the_plain_path_on_cpu(sq, hd, kv_heads):
    """"auto" on CPU tensors is the plain path, bit for bit, whether or
    not the JAX flash conditions hold (on the card they take flash)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, sq, 2, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, sq, kv_heads, hd)).astype(np.float32))
            for _ in range(2))
    lens = torch.tensor([sq, sq - 3], dtype=torch.int32)
    got = attention.attention(q, k, v, causal=True, kv_lens=lens, impl="auto")
    ref = attention.attention_xla(q, k, v, causal=True, kv_lens=lens)
    assert torch.equal(got, ref)


def test_llama_auto_default_equals_xla_on_cpu():
    assert llama.LlamaConfig().attn_impl == "auto"
    cfg = llama.LlamaConfig.tiny(attn_impl="auto")
    params = params_from_jax(random_params(jllama.init_params, jllama.LlamaConfig.tiny(), 3),
                             device="cpu")
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 512, size=(2, 9)))
    got = llama.forward(params, cfg, input_ids=ids)["logits"]
    ref = llama.forward(params, dataclasses.replace(cfg, attn_impl="xla"), input_ids=ids)["logits"]
    assert torch.equal(got, ref)


def _sam_cfgs(attn_kernel):
    """`tests/test_sam.py:400-404`'s encoder, fp32."""
    base = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, out_chans=32,
                window_size=2, global_attn_indexes=(0, 1))
    return (jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel=attn_kernel),
            image_encoder.SamVisionConfig(**base, dtype=torch.float32, attn_kernel=attn_kernel))


def test_sam_attn_kernel_xla_packed_int8_matches_jax():
    """`tests/test_sam.py:392-431`: window and global blocks' weights int8,
    packed head-major at head_pad 32, `attn_kernel="xla"`, against JAX
    `encode` of the same packed tree, which takes its XLA attention (2e-4:
    fp32, sums in other orders), and against the port's unpacked encode at
    JAX's atol 1e-5 (the pads add exact zeros)."""
    jcfg, cfg = _sam_cfgs("xla")
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, 5, std=0.2))
    jq = dict(jp)
    for blocks in ("window_blocks", "global_blocks"):
        jq[blocks] = jquant.quantize_tree(jp[blocks], jquant.SAM_ENCODER_QUANT_KEYS)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    packed = image_encoder.pack_sam_attention(params, cfg, head_pad=32)
    img = np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jie.encode(jie.pack_sam_attention(jq, jcfg, head_pad=32), jcfg, jnp.asarray(img))
    got = image_encoder.encode(packed, cfg, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    unpacked = image_encoder.encode(params, cfg, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), unpacked.numpy(), atol=1e-5, rtol=0)


def test_sam_attn_kernel_modes(monkeypatch):
    """"xla" takes the JAX package's off-TPU routes (the block layout, no
    fused route, `attention_xla` with the materialised rel-pos bias) on
    any device: no SAM attention wrapper is called, so on the card no SAM
    attention kernel is launched. It agrees with the fused routes' plain
    versions and with JAX `encode` at "xla" (fp32, sums in other orders)."""
    jcfg, cfg = _sam_cfgs("auto")
    for bad in ("pallas", "triton"):
        with pytest.raises(ValueError, match="attn_kernel"):
            dataclasses.replace(cfg, attn_kernel=bad)
    with pytest.raises(ValueError, match="block layout"):
        dataclasses.replace(cfg, attn_kernel="xla", window_layout="resident")
    xla = dataclasses.replace(cfg, attn_kernel="xla")
    assert not image_encoder._use_resident(xla) and image_encoder._use_resident(cfg)
    jparams = random_params(jie.init_params, jcfg, 6, std=0.2)
    params = params_from_jax(jparams, device="cpu")
    img = np.random.default_rng(6).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ref, block = (image_encoder.encode(params, c, torch.from_numpy(img))
                  for c in (cfg, dataclasses.replace(cfg, window_layout="block")))

    def refused(*args, **kw):
        raise AssertionError("a SAM attention wrapper was called on the xla route")

    for name in ("fused_window_attention_grid", "fused_window_attention_rect",
                 "fused_global_attention", "fused_global_attention_y",
                 "fused_window_attention_packed", "fused_global_attention_packed"):
        monkeypatch.setattr(image_encoder, name, refused)
    got = image_encoder.encode(params, xla, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), block.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
    jref = jie.encode(jax.tree_util.tree_map(jnp.asarray, jparams),
                      dataclasses.replace(jcfg, attn_kernel="xla"), jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=2e-4, rtol=2e-4)
