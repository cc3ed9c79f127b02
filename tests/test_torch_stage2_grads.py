"""The stage-2 gradient reading (`ullava_tpu_torch/microbench/stage2_grads.py`)
on the CPU: the per-leaf reading on hand-made gradients, the leaf names in
the order of the step's gradients, and the plain stand-ins of its card
witnesses, which must compute exactly what their wrappers' CPU branches
do and be put back after the block."""

import collections

import pytest
import torch

from torch_port_helpers import stage2_cfgs
from ullava_tpu_torch import train
from ullava_tpu_torch.microbench import stage2_grads
from ullava_tpu_torch.models import ullava
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import stage2_loss, trainable_grads


def test_step_reading_per_leaf():
    ref = [torch.tensor([3.0, 4.0]), torch.tensor([0.0, 0.0]), torch.tensor([1e-4, -1e-4])]
    got = [torch.tensor([3.0, 4.5]), torch.tensor([0.0, 1e-9]), torch.tensor([-1e-4, -1e-4])]
    summary, leaves = stage2_grads.step_reading(["a#0", "b#1", "c#2"], got, ref)
    assert leaves["a#0"]["rel_err"] == pytest.approx(0.1)
    assert leaves["a#0"]["sign_agree"] == 1.0 and leaves["a#0"]["share"] == pytest.approx(1.0)
    assert leaves["b#1"]["rel_err"] == 1.0 and leaves["b#1"]["sign_agree"] == 1.0
    assert leaves["c#2"]["rel_err"] == pytest.approx(2 ** 0.5)
    assert leaves["c#2"]["sign_agree"] == 0.5
    # Over all leaves the zero one is worst; over those carrying 1e-3 of
    # the norm (a#0 alone) a#0 is.
    assert summary["all"]["worst_leaf"] == "c#2" and summary["all"]["least_sign_leaf"] == "c#2"
    assert summary["carrying"]["leaves"] == 1 and summary["carrying"]["worst_leaf"] == "a#0"


@pytest.fixture(scope="module")
def tiny_stage2():
    _, cfg = stage2_cfgs()
    params = ullava.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    cfg, params = train.build_stage2(cfg, params, device="cpu")
    batch = train.make_stage2_batch(cfg, 2, 24, seed=1, device="cpu")
    labels = optim.trainable_labels(params, optim.STAGE2_LORA)
    return cfg, params, batch, labels


def test_leaf_names_follow_the_gradients(tiny_stage2):
    cfg, params, batch, labels = tiny_stage2
    names = stage2_grads.leaf_names(params, labels)
    train_leaves = optim.partition_params(params, labels)
    assert len(names) == len(train_leaves) > 0
    assert all(n.endswith(f"#{i}") for i, n in enumerate(names))
    assert any("lora_b" in n for n in names) and not any("q_proj/q" in n for n in names)


@pytest.mark.parametrize("scope", ["k15", "llm", "all"])
def test_plain_stand_ins_are_the_wrappers_cpu_branches(tiny_stage2, scope):
    """On CPU tensors every wrapper already takes its plain version, so the
    step's gradients under the stand-ins are bit-equal to the wrappers'."""
    cfg, params, batch, labels = tiny_stage2
    loss_fn = stage2_loss(cfg)
    loss, _, ref = trainable_grads(loss_fn, params, labels, batch)
    patches = stage2_grads._plain_patches(scope)
    originals = [getattr(mod, name) for mod, name, _ in patches]
    calls = collections.Counter()
    with stage2_grads.plain_on_card(scope):
        for mod, name, fn in patches:
            assert getattr(mod, name).__code__ is fn.__code__

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)

            setattr(mod, name, counted)
        loss2, _, got = trainable_grads(loss_fn, params, labels, batch)
    assert [getattr(mod, name) for mod, name, _ in patches] == originals
    assert torch.equal(loss, loss2)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    reached = {"k15": {"flash_attention_fwd"},
               "llm": {"flash_attention_fwd", "flash_attention_bwd", "_rms_norm_fwd",
                       "rms_norm_bwd"}}.get(scope)
    if reached is None:  # the tiny encoder reaches these of the SAM stand-ins
        reached = {"flash_attention_fwd", "flash_attention_bwd", "_rms_norm_fwd", "rms_norm_bwd",
                   "fused_ln_linear", "fused_linear", "fused_window_attention_grid"}
    assert reached <= set(calls), calls
