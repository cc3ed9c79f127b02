"""End-to-end parity of the port's RES `evaluate` (CLIP -> LLaMA prefill and
greedy decode -> [SEG]/[LOC] readout -> SAM encode -> mask decode) with
the JAX package at tiny fp32 sizes, weights copied through
`bridge.params_from_jax`, and of `serve.serve` with `evaluate`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import random_params
from torch_port_helpers import res_batch as _batch
from ullava_tpu.models import generate as jgen
from ullava_tpu.models import ullava as jullava
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import generate, ullava
from ullava_tpu_torch.serve import serve

# fp32 through the whole stack; sums run in different orders.
ATOL = RTOL = 2e-4


def setup_module():
    torch.set_num_threads(1)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_evaluate_matches_jax_and_serve():
    _evaluate_and_serve("flash")


def test_evaluate_matches_jax_and_serve_auto():
    """The LLM at the default `attn_impl="auto"`: the plain path on the CPU."""
    _evaluate_and_serve("auto")


def _evaluate_and_serve(attn_impl):
    jcfg = jullava.UllavaConfig.tiny()
    jcfg = dataclasses.replace(jcfg, sam=dataclasses.replace(jcfg.sam, vision=dataclasses.replace(
        jcfg.sam.vision, attn_kernel="pallas_interpret", window_layout="block")))
    cfg = ullava.UllavaConfig.tiny()
    cfg = dataclasses.replace(cfg, sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(
        cfg.sam.vision, window_layout="block")), core=dataclasses.replace(
        cfg.core, llm=dataclasses.replace(cfg.core.llm, attn_impl=attn_impl)))
    jparams = random_params(jullava.init_params, jcfg, seed=0)
    params = params_from_jax(jparams, device="cpu")
    batch = _batch(cfg, np.random.default_rng(0), [12, 10])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    gc = generate.GenerateConfig(max_new_tokens=6, temperature=0.0)

    # Read out a token the model does generate, so the [SEG] path is live.
    first = ullava.evaluate(params, cfg, gc, **tbatch)
    seg = int(first["sequences"][0, 14])
    cfg = dataclasses.replace(cfg, seg_token_idx=seg)
    jcfg = dataclasses.replace(jcfg, seg_token_idx=seg)

    jgc = jgen.GenerateConfig(max_new_tokens=6, temperature=0.0)
    ref = jax.jit(jullava.evaluate, static_argnums=(1, 2))(
        jparams, jcfg, jgc, **{k: jnp.asarray(v) for k, v in batch.items()}
    )
    out = ullava.evaluate(params, cfg, gc, **tbatch)
    for key in ("sequences", "lengths", "seg_valid", "loc_valid"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    assert bool(out["seg_valid"][0, 0])
    for key in ("low_res_masks", "pred_boxes", "iou_pred"):
        _close(out[key], ref[key])

    requests = [
        dict(input_ids=batch["input_ids"][b, :n], image=batch["images"][b],
             image_sam=batch["images_sam"][b])
        for b, n in enumerate(batch["prompt_lens"])
    ]
    served = serve((cfg, params), requests, device="cpu", gen=gc)
    lens = out["lengths"].tolist()
    assert served["sequences"] == [out["sequences"][b, :n].tolist() for b, n in enumerate(lens)]
    _close(served["low_res_masks"], out["low_res_masks"].numpy(), atol=0, rtol=0)
    assert served["launches"] == dict.fromkeys(served["launches"], 0)  # CPU: plain versions


def test_int8_llm_evaluate_matches_jax():
    """RES `evaluate` end to end with the int8 LLM (int8 weights, W8A8
    prefill, int8 KV cache; CLIP and SAM unchanged), the weights quantized
    by the JAX package and carried over by the bridge. Tolerance 2e-3: an
    int8 activation may round one step apart between the two frameworks,
    which moves the [SEG] hidden state by about 1e-3 of its scale; token
    ids are compared over the generated span, which this seed keeps clear
    of near-ties."""
    from ullava_tpu.models import llama as jllama
    from ullava_tpu.ops import quant as jquant
    from ullava_tpu_torch.models import llama

    kw = dict(vocab_size=160, a8_prefill=True, kv_quant=True)
    jcfg = jullava.UllavaConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg,
        core=dataclasses.replace(jcfg.core, llm=jllama.LlamaConfig.tiny(**kw)),
        sam=dataclasses.replace(jcfg.sam, vision=dataclasses.replace(
            jcfg.sam.vision, attn_kernel="pallas_interpret", window_layout="block")),
    )
    cfg = ullava.UllavaConfig.tiny()
    cfg = dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, llm=llama.LlamaConfig.tiny(**kw)),
        sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(
            cfg.sam.vision, window_layout="block")))
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jullava.init_params, jcfg, seed=4))
    jparams["core"]["llm"] = jquant.quantize_tree(jparams["core"]["llm"], jquant.LLAMA_QUANT_KEYS)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert params["core"]["llm"]["lm_head"]["q"].dtype == torch.int8

    batch = _batch(cfg, np.random.default_rng(4), [12, 10])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    gc = generate.GenerateConfig(max_new_tokens=6, temperature=0.0)
    first = ullava.evaluate(params, cfg, gc, **tbatch)
    seg = int(first["sequences"][0, 14])
    cfg = dataclasses.replace(cfg, seg_token_idx=seg)
    jcfg = dataclasses.replace(jcfg, seg_token_idx=seg)

    jgc = jgen.GenerateConfig(max_new_tokens=6, temperature=0.0)
    ref = jax.jit(jullava.evaluate, static_argnums=(1, 2))(
        jparams, jcfg, jgc, **{k: jnp.asarray(v) for k, v in batch.items()}
    )
    out = ullava.evaluate(params, cfg, gc, **tbatch)
    for key in ("sequences", "lengths", "seg_valid", "loc_valid"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    assert bool(out["seg_valid"][0, 0])
    for key in ("low_res_masks", "pred_boxes", "iou_pred"):
        _close(out[key], ref[key], atol=2e-3, rtol=2e-3)

    # `quantize_llm` of the port gives the same int8 leaves as the JAX tree.
    plain = params_from_jax(random_params(jullava.init_params, jcfg, seed=4), device="cpu")
    mine = ullava.quantize_llm(plain)["core"]["llm"]
    for name in ("q_proj", "down_proj"):
        assert torch.equal(mine["layers"][1][name]["q"], params["core"]["llm"]["layers"][1][name]["q"])
    assert torch.equal(mine["lm_head"]["q"], params["core"]["llm"]["lm_head"]["q"])
    assert mine["embed_tokens"].dtype == torch.float32
