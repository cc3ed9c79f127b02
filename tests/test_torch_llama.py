"""Parity of the port's LLaMA prefill/decode and greedy generation with the
JAX package, at tiny fp32 sizes from one seed (weights copied through
`bridge.params_from_jax`, inputs drawn with numpy).

The port's prefill runs its serving path (fused rotary + the flash
wrapper, plain versions on the CPU; the tiny config's `attn_impl="flash"`),
and again with the default "auto" (the plain path on the CPU); the JAX
side runs its reference path.
The second half holds the int8 serving path (int8 weights, W8A8 prefill,
int8 KV cache) to the JAX package on the same quantized tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.models import generate as jgen
from ullava_tpu.models import llama as jllama
from ullava_tpu.models import ullava_core as jcore
from ullava_tpu.ops import quant as jquant
from torch_port_helpers import assert_int8_close, random_params
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import generate, llama, ullava_core

# fp32 on both sides through a few layers; sums run in different orders.
ATOL = RTOL = 1e-4


def setup_module():
    torch.set_num_threads(1)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_prefill_and_decode_steps_match_jax():
    _prefill_and_decode_steps("flash")


def test_prefill_and_decode_steps_match_jax_auto():
    """The default `attn_impl="auto"`: the plain path on the CPU."""
    _prefill_and_decode_steps("auto")


def _prefill_and_decode_steps(attn_impl):
    jcfg = jllama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig.tiny(attn_impl=attn_impl)
    jparams = random_params(jllama.init_params, jcfg, seed=0)
    params = params_from_jax(jparams, device="cpu")

    rng = np.random.default_rng(0)
    B, S, total = 2, 7, 11
    ids = rng.integers(0, jcfg.vocab_size, size=(B, S))
    lens = np.array([7, 4], np.int32)

    jcache = jllama.init_kv_cache(jcfg, B, total)
    cache = llama.init_kv_cache(cfg, B, total, device="cpu")
    jout = jllama.forward(jparams, jcfg, input_ids=jnp.asarray(ids),
                          kv_lens=jnp.asarray(lens), kv_cache=jcache)
    out = llama.forward(params, cfg, input_ids=torch.as_tensor(ids),
                        kv_lens=torch.as_tensor(lens), kv_cache=cache)
    for b, n in enumerate(lens):  # rows past the prompt are padding
        _close(out["hidden_states"][b, :n], np.asarray(jout["hidden_states"])[b, :n])
        _close(out["logits"][b, :n], np.asarray(jout["logits"])[b, :n])
    jcache = jout["kv_cache"]

    pos = lens.copy()
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1))
        jout = jllama.forward(
            jparams, jcfg, input_ids=jnp.asarray(tok), positions=jnp.asarray(pos[:, None]),
            kv_lens=jnp.asarray(pos + 1), kv_cache=jcache, write_pos=jnp.asarray(pos),
        )
        out = llama.forward(
            params, cfg, input_ids=torch.as_tensor(tok), positions=torch.as_tensor(pos[:, None]),
            kv_lens=torch.as_tensor(pos + 1), kv_cache=cache, write_pos=torch.as_tensor(pos),
        )
        _close(out["hidden_states"], jout["hidden_states"])
        _close(out["logits"], jout["logits"])
        jcache = jout["kv_cache"]
        pos = pos + 1
    for name in ("k", "v"):
        for b in range(B):
            _close(cache[name][:, b, : pos[b]], np.asarray(jcache[name])[:, b, : pos[b]])


def _prompts(cfg, rng, lens):
    P = 4  # tiny CLIP: (28 / 14)^2 patches
    ids = rng.integers(5, 140, size=(len(lens), max(lens)))
    for b, n in enumerate(lens):
        ids[b, 1] = cfg.img_start_id
        ids[b, 2:2 + P] = 3
        ids[b, 2 + P] = cfg.img_end_id
        ids[b, n:] = 0
    return ids


def test_generate_matches_jax_greedy():
    _generate_greedy("flash")


def test_generate_matches_jax_greedy_auto():
    _generate_greedy("auto")


def _generate_greedy(attn_impl):
    jcfg = jcore.UllavaCoreConfig.tiny()
    cfg = ullava_core.UllavaCoreConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl=attn_impl))
    jparams = random_params(jcore.init_params, jcfg, seed=1)
    params = params_from_jax(jparams, device="cpu")

    rng = np.random.default_rng(1)
    lens = np.array([12, 9], np.int32)
    ids = _prompts(cfg, rng, lens)
    images = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)

    tids, tlens, timgs = (torch.as_tensor(a) for a in (ids, lens, images))
    first = generate.generate(params, cfg, generate.GenerateConfig(max_new_tokens=8),
                              input_ids=tids, prompt_lens=tlens, images=timgs)
    # Stop sample 0 at its third generated token (a per-sample stop).
    stop = int(first["sequences"][0, lens[0] + 2])
    jgc = jgen.GenerateConfig(max_new_tokens=8, temperature=0.0, stop_token_ids=(stop,))
    gc = generate.GenerateConfig(max_new_tokens=8, stop_token_ids=(stop,))
    jout = jgen.generate(
        jparams, jcfg, jgc,
        input_ids=jnp.asarray(ids), prompt_lens=jnp.asarray(lens), images=jnp.asarray(images),
    )
    out = generate.generate(params, cfg, gc, input_ids=tids, prompt_lens=tlens, images=timgs)
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(jout["sequences"]))
    np.testing.assert_array_equal(out["lengths"].numpy(), np.asarray(jout["lengths"]))
    _close(out["hidden_last"], jout["hidden_last"])

    seqs = np.asarray(jout["sequences"])
    token = int(seqs[1, lens[1] + 1])
    jh, jv = jgen.readout_token_hidden(jout["sequences"], jout["hidden_last"],
                                       jout["lengths"], token, 2)
    h, v = generate.readout_token_hidden(out["sequences"], out["hidden_last"],
                                         out["lengths"], token, 2)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    _close(h, jh)


# ---------------------------------------------------------------------------
# The int8 serving path: int8 weights, W8A8 prefill, int8 KV cache.
# ---------------------------------------------------------------------------

# The port runs its fused structure (add + norm + quantize at both norm
# sites with the MLP residual deferred, silu_mul_quant, write-and-attend
# decode), the JAX package on the CPU its unfused one; in fp32 the two
# compute the same values up to summation order. An activation within that
# noise of a rounding boundary may quantize one int8 step apart, which
# moves an output by about 1e-3 of its scale: the tolerance admits a few
# such flips (without one the two agree to about 1e-6).
INT8_ATOL = INT8_RTOL = 2e-3


def _int8_pair(init, jcfg, seed, llm_of=lambda p: p):
    """The same int8 LLM weights for both sides: quantized by the JAX
    package, carried over by the bridge."""
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(init, jcfg, seed=seed))
    llm = llm_of(jparams)
    llm.update(jquant.quantize_tree(dict(llm), jquant.LLAMA_QUANT_KEYS))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, params


@pytest.mark.parametrize("kv_heads,fused", [(4, True), (2, True), (4, False)])
def test_int8_prefill_and_decode_steps_match_jax(kv_heads, fused):
    _int8_prefill_and_decode(kv_heads, fused, np.array([8, 5], np.int32), total=11)


@pytest.mark.parametrize("S", [16, 12])
@pytest.mark.parametrize("fused", [True, False])
def test_int8_one_sample_short_prompt_matches_jax(S, fused):
    """One sample of 16 tokens or fewer under W8A8 prefill: every int8
    product has 16 rows or fewer, which the card's library product refuses
    and `quant.int8_matmul` pads there; on the CPU the same function."""
    _int8_prefill_and_decode(4, fused, np.array([S], np.int32), total=S + 2)


def _int8_prefill_and_decode(kv_heads, fused, lens, total):
    """W8A8 prefill of prompts of `lens` tokens (padded to the longest),
    then two teacher-forced decode steps, against the JAX package."""
    kw = dict(num_kv_heads=kv_heads, a8_prefill=True, kv_quant=True, fused_norm_quant=fused)
    jcfg, cfg = jllama.LlamaConfig.tiny(**kw), llama.LlamaConfig.tiny(**kw)
    jparams, params = _int8_pair(jllama.init_params, jcfg, seed=2)
    assert params["layers"][1]["down_proj"]["q"].dtype == torch.int8
    assert tuple(params["layers"][1]["down_proj"]["scale"].shape) == (1, cfg.hidden_size)

    rng = np.random.default_rng(2)
    B, S = len(lens), int(lens.max())
    ids = rng.integers(0, jcfg.vocab_size, size=(B, S))
    jcache = jllama.init_kv_cache(jcfg, B, total)
    cache = llama.init_kv_cache(cfg, B, total, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    assert cache["k"].dtype == torch.int8 and cache["k"].shape[2] == -(-total // 8) * 8  # in 8s

    jout = jllama.forward(jparams, jcfg, input_ids=jnp.asarray(ids),
                          kv_lens=jnp.asarray(lens), kv_cache=jcache)
    out = llama.forward(params, cfg, input_ids=torch.as_tensor(ids),
                        kv_lens=torch.as_tensor(lens), kv_cache=cache)
    for b, n in enumerate(lens):
        _close(out["hidden_states"][b, :n], np.asarray(jout["hidden_states"])[b, :n], INT8_ATOL, INT8_RTOL)
        _close(out["logits"][b, :n], np.asarray(jout["logits"])[b, :n], INT8_ATOL, INT8_RTOL)
    jcache = jout["kv_cache"]

    pos = lens.copy()
    for step in range(2):  # teacher-forced: the same tokens go to both
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1))
        jout = jllama.forward(
            jparams, jcfg, input_ids=jnp.asarray(tok), positions=jnp.asarray(pos[:, None]),
            kv_lens=jnp.asarray(pos + 1), kv_cache=jcache, write_pos=jnp.asarray(pos),
        )
        out = llama.forward(
            params, cfg, input_ids=torch.as_tensor(tok), positions=torch.as_tensor(pos[:, None]),
            kv_lens=torch.as_tensor(pos + 1), kv_cache=cache, write_pos=torch.as_tensor(pos),
        )
        _close(out["hidden_states"], jout["hidden_states"], INT8_ATOL, INT8_RTOL)
        _close(out["logits"], jout["logits"], INT8_ATOL, INT8_RTOL)
        jcache = jout["kv_cache"]
        pos = pos + 1
    for b in range(B):  # the rows each side wrote: prompt and two steps
        for name in ("k", "v"):
            assert_int8_close(cache[name][:, b, : pos[b]].numpy(), np.asarray(jcache[name])[:, b, : pos[b]])
        for name in ("k_scale", "v_scale"):
            _close(cache[name][:, b, : pos[b]], np.asarray(jcache[name])[:, b, : pos[b]], 0, 1e-4)


def test_int8_generate_matches_jax_greedy():
    """Greedy int8 generation, with a per-sample stop. A random tiny model
    has nearly flat logits, so sequences are compared up to the first
    token whose top-2 logit margin in the JAX run is under the tolerance:
    past it an int8 rounding flip may pick another token."""
    llm_kw = dict(vocab_size=160, a8_prefill=True, kv_quant=True)
    jcfg = jcore.UllavaCoreConfig.tiny(llm=jllama.LlamaConfig.tiny(**llm_kw))
    cfg = ullava_core.UllavaCoreConfig.tiny(llm=llama.LlamaConfig.tiny(**llm_kw))
    jparams, params = _int8_pair(jcore.init_params, jcfg, seed=3, llm_of=lambda p: p["llm"])

    rng = np.random.default_rng(3)
    lens = np.array([12, 9], np.int32)
    ids = _prompts(cfg, rng, lens)
    images = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    tids, tlens, timgs = (torch.as_tensor(a) for a in (ids, lens, images))
    first = generate.generate(params, cfg, generate.GenerateConfig(max_new_tokens=8),
                              input_ids=tids, prompt_lens=tlens, images=timgs)
    stop = int(first["sequences"][0, lens[0] + 2])
    jgc = jgen.GenerateConfig(max_new_tokens=8, temperature=0.0, stop_token_ids=(stop,))
    gc = generate.GenerateConfig(max_new_tokens=8, stop_token_ids=(stop,))
    jout = jgen.generate(
        jparams, jcfg, jgc,
        input_ids=jnp.asarray(ids), prompt_lens=jnp.asarray(lens), images=jnp.asarray(images),
    )
    out = generate.generate(params, cfg, gc, input_ids=tids, prompt_lens=tlens, images=timgs)

    jseq, jhid = np.asarray(jout["sequences"]), np.asarray(jout["hidden_last"])
    head = np.asarray(jquant.dequantize(jparams["llm"]["lm_head"], jnp.float32))
    compared = 0
    for b, n in enumerate(lens):
        end = int(jout["lengths"][b])
        for j in range(n, end):  # token j came from hidden_last[b, j - 1]
            top2 = np.sort(jhid[b, j - 1] @ head)[-2:]
            if top2[1] - top2[0] < INT8_ATOL:
                end = j
                break
        assert end > n  # at least the first generated token is compared
        np.testing.assert_array_equal(out["sequences"][b, :end].numpy(), jseq[b, :end])
        _close(out["hidden_last"][b, : end - 1], jhid[b, : end - 1], INT8_ATOL, INT8_RTOL)
        compared += end - n
    assert compared >= 6
