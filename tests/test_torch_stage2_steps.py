"""Three stage-2 train steps of the port against the jitted JAX step at
tiny fp32 sizes, both packages handed the same freeze patterns: LoRA over
int8 towers, LoRA over an int8 LLM as well (`bench.py run_stage2`'s
model, here with `a8_prefill` off on both sides: under autograd the port
runs its int8 linears weight-only, `test_torch_stage2.py`), and full
finetuning (`STAGE2`). Weights go through `bridge.params_from_jax`; the
batch is drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    BENCH_LORA,
    jax_batch,
    random_params,
    stage2_batch,
    stage2_cfgs,
    torch_batch,
)
from ullava_tpu.models import llama as jllama
from ullava_tpu.models import ullava as jullava
from ullava_tpu.ops import quant as jquant
from ullava_tpu.training import optim as joptim
from ullava_tpu.training import train_step as jstep
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import make_stage2_step, make_train_state


def setup_module():
    torch.set_num_threads(1)


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def tiny_stage2():
    jcfg, cfg = stage2_cfgs()
    return jcfg, cfg, random_params(jullava.init_params, jcfg, seed=3)


def _stage2_trees(jcfg, jparams, case):
    """A JAX stage-2 tree as `models/build.py:248-283` builds it for the
    case: int8 towers, the LLM int8 too for "lora_int8_llm", LoRA r=4 on
    both LoRA cases (B bumped off zero, so that A has a gradient from the
    first step on)."""
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jp["sam"]["image_encoder"] = jquant.quantize_tree(jp["sam"]["image_encoder"],
                                                      jquant.SAM_ENCODER_QUANT_KEYS)
    jp["core"]["vision"] = jquant.quantize_tree(jp["core"]["vision"], jquant.CLIP_QUANT_KEYS)
    if case == "lora_int8_llm":
        jp["core"]["llm"] = jquant.quantize_tree(jp["core"]["llm"], jquant.LLAMA_QUANT_KEYS)
    if case != "full":
        jp["core"]["llm"] = jllama.add_lora(jp["core"]["llm"], jcfg.core.llm, jax.random.PRNGKey(2), r=4)
        for k in ("q_proj_lora_b", "v_proj_lora_b"):
            lb = jp["core"]["llm"]["layers"][k]
            jp["core"]["llm"]["layers"][k] = lb + 0.01 * jax.random.normal(jax.random.PRNGKey(3), lb.shape)
    return jp


@pytest.mark.parametrize("case", ["lora_int8_towers", "lora_int8_llm", "full"])
def test_stage2_steps_match_jax(tiny_stage2, case):
    """Three stage-2 steps against the jitted JAX step, both packages
    handed the same freeze patterns (`bench.py:855-859`'s for LoRA,
    `STAGE2` for full finetuning): the loss, the gradient norm and the
    four aux losses of each step within 1e-5 (fp32, sums in another
    order); the trainable leaves after step 3: 99% within 1e-4 of lr (plus
    1e-5 relative) and all within the 2 lr per step by which Adam can move
    an element whose gradient is near zero, where fp32 noise decides the
    normalised step (an adapter A of 256 elements, whose gradient flows
    through the small B, holds one such element); the frozen leaves
    bit-unchanged."""
    jcfg, cfg, jparams = tiny_stage2
    jp = _stage2_trees(jcfg, jparams, case)
    patterns = joptim.STAGE2 if case == "full" else BENCH_LORA
    batch = stage2_batch(cfg, np.random.default_rng(11))
    lr = 1e-3
    tx = joptim.make_optimizer(lr)
    jstate, jlabels = jstep.make_train_state(jp, tx, patterns)
    jfn = jstep.jit_step(jstep.make_stage2_step(jcfg, tx, jlabels))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    before = [(n, t.clone()) for n, t in optim.named_leaves(params)]
    state, labels = make_train_state(params, optim.make_optimizer(lr), patterns)
    fn = make_stage2_step(cfg, optim.make_optimizer(lr), labels)
    tb, jb = torch_batch(batch), jax_batch(batch)
    for _ in range(3):
        jstate, jm = jfn(jstate, jb)
        state, m = fn(state, tb)
        for key in ("loss", "grad_norm", "ce_loss", "mask_bce_loss", "mask_dice_loss", "bbox_loss"):
            _close(m[key], jm[key], rtol=1e-5, atol=1e-5)
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu")
    n_train = n_moved = 0
    for (name, t0), (_, t), (_, r), (_, lab) in zip(
            before, optim.named_leaves(state.params), optim.named_leaves(after),
            optim.named_leaves(labels)):
        if lab == "train":
            # A leaf moves on both sides or on neither (a key bias of an
            # attention has no gradient: softmax ignores a shift of all keys).
            n_train += 1
            n_moved += not torch.equal(t, t0)
            assert torch.equal(t, t0) == torch.equal(r, t0), name
            diff = (t - r).abs()
            assert (diff <= 1e-4 * lr + 1e-5 * r.abs()).float().mean() >= 0.99, name
            assert diff.max() <= 3 * 2 * lr, name
        else:
            assert torch.equal(t, t0), name
    n_heads = 3 * 2 + 2 * 3  # seg / det projectors (2 linears), det decoder (3)
    assert n_moved > n_heads  # the mask decoder's unused mask tokens and key biases stay
    if case != "full":  # and the adapters of both layers
        assert sum(1 for n, lab in optim.named_leaves(labels) if "lora" in n and lab == "train") == 8
