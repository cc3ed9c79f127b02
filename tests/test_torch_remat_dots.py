"""`LlamaConfig.remat_policy="dots"` in the port: the selective
checkpoint keeps the outputs of the matmuls without batch dims and
recomputes the rest (the JAX policy `dots_with_no_batch_dims_saveable`).
On the CPU its gradients are bit-equal to the 'full' policy's, and
within the tolerance of the stage-1 layer parity test to JAX's 'dots';
its policy saves mm, addmm and _int_mm and recomputes bmm; it keeps what
it says it keeps (fewer tensors recomputed than under 'full'); and a
stage-1 step under it gives the 'full' step's loss and update bit for
bit."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from torch_port_helpers import random_params
from ullava_tpu.models import llama as jllama
from ullava_tpu_torch import train
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import llama, ullava_core
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import make_stage1_step, make_train_state

LEAVES = ("q_proj", "o_proj", "input_norm", "down_proj", "up_proj")


def setup_module():
    torch.set_num_threads(1)


def _jcfg(policy):
    return jllama.LlamaConfig.tiny(num_layers=2, remat=True, remat_policy=policy,
                                   attn_impl="xla")


def _cfg(policy):
    return llama.LlamaConfig.tiny(num_layers=2, remat=True, remat_policy=policy)


def _inputs():
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((2, 24, 64)).astype(np.float32)
    proj = rng.standard_normal((2, 24, 64)).astype(np.float32)
    return emb, proj, np.asarray([24, 17], np.int32)


def _port_grads(params, policy, emb, proj, lens):
    params = copy.deepcopy(params)
    leaves = [lp[k] for lp in params["layers"] for k in LEAVES] + [params["norm"]]
    for t in leaves:
        t.requires_grad_(True)
    e = torch.tensor(emb, requires_grad=True)
    h = llama.forward(params, _cfg(policy), inputs_embeds=e, kv_lens=torch.as_tensor(lens),
                      compute_logits=False)["hidden_states"]
    loss = (h * torch.tensor(proj)).sum()
    return loss, torch.autograd.grad(loss, [e] + leaves)


def test_dots_policy_saves_only_matmuls_without_batch_dims():
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten._int_mm.default):
        assert llama._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default, aten.add.Tensor):
        assert llama._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_dots_gradients_bit_equal_full():
    """Two layers, remat on: the loss and every gradient (the embeddings,
    five leaves of each layer, the final norm) bit-equal between the
    policies (the recompute gives the saved matmul outputs' own bits)."""
    jp = random_params(jllama.init_params, _jcfg("full"), seed=4)
    params = params_from_jax(jp, device="cpu")
    emb, proj, lens = _inputs()
    loss_f, g_full = _port_grads(params, "full", emb, proj, lens)
    loss_d, g_dots = _port_grads(params, "dots", emb, proj, lens)
    assert torch.equal(loss_f, loss_d)
    for a, b in zip(g_full, g_dots, strict=True):
        assert torch.equal(a, b)


def test_dots_matches_jax_dots():
    """The port's 'dots' against `jax.grad` of the JAX decoder under its
    'dots' policy, at the tolerances of the stage-1 layer parity test
    (`test_torch_train.py::test_llama_training_layer_matches_jax`: the
    loss to 1e-2 + 1e-5 relative, each gradient to 1e-4 of its largest
    value + 1e-3 relative)."""
    jcfg = _jcfg("dots")
    jp = random_params(jllama.init_params, jcfg, seed=4)
    emb, proj, lens = _inputs()

    def jloss(p, e):
        h = jllama.forward(p, jcfg, inputs_embeds=e, kv_lens=jnp.asarray(lens),
                           compute_logits=False)["hidden_states"]
        return (h * proj).sum()

    loss_ref, (gp, ge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(emb))
    loss, grads = _port_grads(params_from_jax(jp, device="cpu"), "dots", emb, proj, lens)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_ref), atol=1e-2, rtol=1e-5)
    refs = [ge] + [gp["layers"][k][i] for i in range(2) for k in LEAVES] + [gp["norm"]]
    for g, r in zip(grads, refs, strict=True):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max(), rtol=1e-3)


def _recomputed_ops(policy):
    """The aten ops run in the backward of one remat'd layer stack."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    params = llama.init_params(_cfg(policy), device="cpu")
    for lp in params["layers"]:
        lp["q_proj"].requires_grad_(True)
    e = torch.randn(2, 8, 64, requires_grad=True)
    h = llama.forward(params, _cfg(policy), inputs_embeds=e, compute_logits=False)
    loss = h["hidden_states"].sum()
    with Log() as log:
        loss.backward()
    return log.ops


def test_dots_recomputes_no_matmul():
    """The mm of the backward of two layers (q_proj trains): under 'dots'
    only the backward's own, 7 input gradients and q_proj's weight
    gradient a layer; under 'full' also the recomputed forward linears (6
    a layer: the recompute stops once it has every saved tensor, and no
    backward needs the down projection's output)."""
    mm = torch.ops.aten.mm.default
    full = sum(op == mm for op in _recomputed_ops("full"))
    dots = sum(op == mm for op in _recomputed_ops("dots"))
    assert (full, dots) == (2 * (8 + 6), 2 * 8)


def test_stage1_step_under_dots_equals_full():
    """One stage-1 finetuning step (every LLM leaf trains) from the same
    state under each policy: the same loss, gradient norm and updated
    parameters, bit for bit."""
    out = {}
    for policy in ("full", "dots"):
        cfg = ullava_core.UllavaCoreConfig.tiny(
            llm=llama.LlamaConfig.tiny(vocab_size=160, remat=True, remat_policy=policy),
            projector_from_scratch=False)
        params = {"core": ullava_core.init_params(cfg, torch.Generator().manual_seed(2), "cpu")}
        tx = optim.make_optimizer(1e-3)
        state, labels = make_train_state(params, tx, optim.STAGE1_FINETUNE)
        state, m = make_stage1_step(cfg, tx, labels)(state, train.make_batch(cfg, 2, 16,
                                                                             device="cpu"))
        out[policy] = (m, [t.detach().clone() for _, t in optim.named_leaves(state.params)])
    (mf, pf), (md, pd) = out["full"], out["dots"]
    assert torch.equal(mf["loss"], md["loss"]) and torch.equal(mf["grad_norm"], md["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(pf, pd, strict=True))


@pytest.mark.parametrize("policy", ["offload", "everything"])
def test_unknown_policy_raises(policy):
    cfg = dataclasses.replace(_cfg("full"), remat_policy=policy)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        llama.forward(params, cfg, inputs_embeds=torch.randn(1, 4, 64, requires_grad=True))
