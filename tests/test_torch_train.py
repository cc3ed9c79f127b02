"""Parity of the port's stage-1 training path with the JAX package at tiny
fp32 sizes: the RMSNorm and flash attention backward (JAX Pallas kernels
in interpret mode), a LLaMA layer under autograd, the stage-1 loss in
both cross-entropy forms with images and videos, the pretraining detach
of the text embeddings, the schedule and the clipped AdamW update against
optax, three train steps under both freeze policies, and the trainer's
loop with checkpoints and resume. Weights go through
`bridge.params_from_jax`; inputs are drawn with numpy.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models import llama as jllama
from ullava_tpu.models import ullava_core as jcore
from ullava_tpu.ops.attention import flash_attention_bwd as jflash_bwd
from ullava_tpu.ops.attention import flash_attention_fwd as jflash_fwd
from ullava_tpu.ops.norms import _rms_norm_pallas
from ullava_tpu.training import optim as joptim
from ullava_tpu.training import train_step as jstep
from ullava_tpu_torch import train
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import llama, ullava_core
from ullava_tpu_torch.ops import attention, norms
from ullava_tpu_torch.training import checkpoint as ckpt
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import make_stage1_step, make_train_state
from ullava_tpu_torch.training.trainer import Trainer


def setup_module():
    torch.set_num_threads(1)


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref), atol=atol, rtol=rtol)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("need_dw", [True, False])
def test_rms_norm_fwd_bwd_matches_jax(need_dw):
    """The RMSNorm Function (plain forward, `rms_norm_bwd_plain`) against
    jax.vjp of the Pallas custom VJP in interpret mode (tolerances of the
    JAX package's own test, `tests/test_ops.py:287-308`)."""
    rng = np.random.default_rng(3)
    x, dy = rng.standard_normal((2, 24, 256), np.float32), rng.standard_normal((2, 24, 256), np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a, b: _rms_norm_pallas(a, b, 1e-6, True),
                         jnp.asarray(x.reshape(48, 256)), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy.reshape(48, 256)))
    xt, wt = _t(x, True), _t(w, need_dw)
    y = norms.rms_norm(xt, wt, 1e-6)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    grads = torch.autograd.grad(y, (xt, wt) if need_dw else (xt,), _t(dy))
    _close(y.reshape(48, 256), y_ref, 1e-5)
    _close(grads[0].reshape(48, 256), dx_ref, 1e-4)
    if need_dw:
        _close(grads[1], dw_ref, 1e-4, 2e-5)
    else:
        assert norms.rms_norm_bwd(xt.detach(), wt, _t(dy), 1e-6, need_dw=False)[1] is None


@pytest.mark.parametrize("lens", [None, (200, 77)])
def test_flash_attention_fwd_bwd_matches_jax(lens):
    """o, lse and (dq, dk, dv) against the JAX training kernels in
    interpret mode on the same inputs (head-major there, [B, S, H, hd]
    here); tolerances of the JAX package's tests (`tests/test_ops.py:113,
    161`)."""
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 256, 2, 128
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    kv = np.asarray(lens or (S, S), np.int32)
    sc = D**-0.5
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, do)]
    o_ref, lse_ref = jflash_fwd(hm[0], hm[1], hm[2], jnp.asarray(kv), causal=True, scale=sc,
                                interpret=True)
    o, lse = attention.flash_attention_fwd(_t(q), _t(k), _t(v), _t(kv), causal=True, scale=sc)
    _close(o.transpose(1, 2), o_ref, 2e-4)
    _close(lse, np.asarray(lse_ref)[..., 0], 2e-4)
    # The backward of the same forward: JAX's o and lse into both.
    grads_ref = jflash_bwd(hm[0], hm[1], hm[2], o_ref, lse_ref, hm[3], jnp.asarray(kv),
                           causal=True, scale=sc, interpret=True)
    o_bsh = _t(np.asarray(o_ref).transpose(0, 2, 1, 3))
    grads = attention.flash_attention_bwd(_t(q), _t(k), _t(v), o_bsh,
                                          _t(np.asarray(lse_ref)[..., 0]), _t(do), _t(kv),
                                          causal=True, scale=sc)
    for g, r in zip(grads, grads_ref):
        _close(g.transpose(1, 2), r, 5e-3, 1e-3)
    for b, n in enumerate(kv):  # key rows past kv_len: exact zeros
        assert not grads[1][b, n:].any() and not grads[2][b, n:].any()


@pytest.mark.parametrize("causal,lens", [(True, (40, 23)), (False, (40, 31))])
def test_attention_flash_gradients_match_plain_autograd(causal, lens):
    """`attention(impl="flash")` under autograd is the Function (the
    hazard: a route that fills an output outside autograd would drop the
    gradient); its gradients equal torch autograd through `attention_xla`
    wherever a row has a live key."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.standard_normal((2, 40, 2, 32)).astype(np.float32) for _ in range(4))
    kv = torch.tensor(lens, dtype=torch.int32)
    qs = [_t(a, True) for a in (q, k, v)]
    out = attention.attention(*qs, causal=causal, kv_lens=kv, impl="flash")
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    g1 = torch.autograd.grad((out * _t(w)).sum(), qs)
    ref = attention.attention_xla(*qs, causal=causal, kv_lens=kv)
    g2 = torch.autograd.grad((ref * _t(w)).sum(), qs)
    for a, b in zip(g1, g2):
        _close(a, b.numpy(), 2e-4)
    with torch.no_grad():
        assert attention.attention(*qs, causal=causal, kv_lens=kv, impl="flash").grad_fn is None


def test_llama_training_layer_matches_jax():
    """One LLaMA layer at head dim 128, remat on, under autograd (the flash
    and RMSNorm Functions, plain versions on the CPU) against jax.grad
    with `attn_impl="flash_interpret"` (the JAX custom VJP over the Pallas
    forward and backward kernels in interpret mode)."""
    jcfg = jllama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_heads=2,
                                   num_kv_heads=2, num_layers=1, remat=True,
                                   attn_impl="flash_interpret")
    cfg = llama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_heads=2,
                                 num_kv_heads=2, num_layers=1, remat=True)
    jparams = random_params(jllama.init_params, jcfg, seed=2)
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 128, 256)).astype(np.float32)
    proj = rng.standard_normal((2, 128, 256)).astype(np.float32)
    lens = np.asarray([128, 100], np.int32)

    def jloss(p, e):
        h = jllama.forward(p, jcfg, inputs_embeds=e, kv_lens=jnp.asarray(lens),
                           compute_logits=False)["hidden_states"]
        return (h * proj).sum()

    loss_ref, (gp_ref, ge_ref) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(emb))
    params = params_from_jax(jparams, device="cpu")
    layer = params["layers"][0]
    leaves = [layer["q_proj"], layer["input_norm"], layer["down_proj"], params["norm"]]
    for t in leaves:
        t.requires_grad_(True)
    e = _t(emb, True)
    h = llama.forward(params, cfg, inputs_embeds=e, kv_lens=torch.as_tensor(lens),
                      compute_logits=False)["hidden_states"]
    loss = (h * _t(proj)).sum()
    grads = torch.autograd.grad(loss, [e] + leaves)
    _close(loss, loss_ref, 1e-2, 1e-5)
    refs = [ge_ref, gp_ref["layers"]["q_proj"][0], gp_ref["layers"]["input_norm"][0],
            gp_ref["layers"]["down_proj"][0], gp_ref["norm"]]
    for g, r in zip(grads, refs):
        r = np.asarray(r)
        _close(g, r, 1e-4 * np.abs(r).max(), 1e-3)


# ---------------------------------------------------------------- the model


def _core_batch(cfg, rng, lens, video=False, text_only_row=False):
    """Right-padded stage-1 batch (numpy): the image span after
    `<img_beg>` (and a video span after `<vid_beg>`), labels
    IGNORE_INDEX over the spans; optionally a last row without markers."""
    P, S, T = cfg.vision.num_patches, max(lens), 2
    ids = rng.integers(5, 140, size=(len(lens), S))
    labels = ids.copy()
    for b in range(len(lens)):
        if text_only_row and b == len(lens) - 1:
            continue
        ids[b, 1], ids[b, 2:2 + P], ids[b, 2 + P] = cfg.img_start_id, 3, cfg.img_end_id
        end = 3 + P
        if video:
            ids[b, end], ids[b, end + 1:end + 1 + T + P] = cfg.vid_start_id, 4
            ids[b, end + 1 + T + P] = cfg.vid_end_id
            end += T + P + 2
        labels[b, :end] = -100
    for b, n in enumerate(lens):
        labels[b, n:] = -100
    side = cfg.vision.image_size
    batch = {"input_ids": ids, "labels": labels, "attn_lens": np.asarray(lens, np.int32),
             "images": rng.standard_normal((len(lens), side, side, 3)).astype(np.float32)}
    if video:
        batch["videos"] = rng.standard_normal((len(lens), T, side, side, 3)).astype(np.float32)
    return batch


@pytest.mark.parametrize("fused_ce", [True, False])
@pytest.mark.parametrize("video", [False, True])
def test_stage1_loss_matches_jax(fused_ce, video):
    jcfg = jcore.UllavaCoreConfig.tiny(fused_ce=fused_ce)
    cfg = ullava_core.UllavaCoreConfig.tiny(fused_ce=fused_ce)
    jparams = random_params(jcore.init_params, jcfg, seed=0)
    params = params_from_jax(jparams, device="cpu")
    batch = _core_batch(cfg, np.random.default_rng(0), [28, 21], video=video)
    ref = jcore.forward(jparams, jcfg, **{k: jnp.asarray(v) for k, v in batch.items()})["loss"]
    out = ullava_core.forward(params, cfg, **{k: torch.as_tensor(v) for k, v in batch.items()})
    _close(out["loss"], ref, 1e-5, 1e-5)


@pytest.mark.parametrize("from_scratch", [True, False])
def test_embedding_gradients_match_jax(from_scratch):
    """The gradient of the loss in the embedding table: with
    `projector_from_scratch` only the marker spans' rows (and every row of
    a text-only sample) receive one, as under the JAX `stop_gradient`."""
    jcfg = jcore.UllavaCoreConfig.tiny(projector_from_scratch=from_scratch)
    cfg = ullava_core.UllavaCoreConfig.tiny(projector_from_scratch=from_scratch)
    jparams = random_params(jcore.init_params, jcfg, seed=1)
    batch = _core_batch(cfg, np.random.default_rng(1), [20, 20, 16], text_only_row=True)

    def jloss(emb):
        p = {**jparams, "llm": {**jparams["llm"], "embed_tokens": emb}}
        return jcore.forward(p, jcfg, **{k: jnp.asarray(v) for k, v in batch.items()})["loss"]

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(jparams["llm"]["embed_tokens"])))
    params = params_from_jax(jparams, device="cpu")
    emb = params["llm"]["embed_tokens"].requires_grad_(True)
    loss = ullava_core.forward(params, cfg, **{k: torch.as_tensor(v) for k, v in batch.items()})["loss"]
    got = torch.autograd.grad(loss, emb)[0].numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    _close(torch.as_tensor(got), ref, 1e-6, 1e-4)
    # Tokens that occur only as text outside the marker spans of the image
    # rows (which end at column 2 + P).
    after_span = batch["input_ids"][:2, 3 + cfg.vision.num_patches:].ravel().tolist()
    text_rows = set(after_span) - set(batch["input_ids"][2].tolist())
    assert (ref[sorted(text_rows)] == 0).all() == from_scratch


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_lr_schedule_matches_optax(schedule):
    ref = joptim.make_lr_schedule(3e-3, 20, warmup_ratio=0.1, schedule=schedule)
    got = optim.make_lr_schedule(3e-3, 20, warmup_ratio=0.1, schedule=schedule)
    for step in range(21):  # optax computes in float32, the port in float64
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=0, atol=1e-6 * 3e-3)


@pytest.mark.parametrize("gscale", [0.1, 10.0])
def test_clip_and_adamw_update_match_optax(gscale):
    """Three updates on fixed gradients, with the clip idle (0.1) and
    active (10): the parameters and both moments against optax."""
    rng = np.random.default_rng(4)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [gscale * rng.standard_normal(p.shape).astype(np.float32) for p in params]
    sched = joptim.make_lr_schedule(1e-2, 10, warmup_ratio=0.2)
    tx = joptim.make_optimizer(sched, weight_decay=0.01)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    ours = optim.make_optimizer(optim.make_lr_schedule(1e-2, 10, warmup_ratio=0.2),
                                weight_decay=0.01)
    tp = [_t(p) for p in params]
    ostate = ours.init(tp)
    for _ in range(3):
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        ostate = ours.update([_t(g) for g in grads], ostate, tp)
    for a, b in zip(tp, jp):
        _close(a, b, 1e-7, 1e-6)
    adam = state[1][0]
    for a, b in zip(ostate["mu"] + ostate["nu"], list(adam.mu) + list(adam.nu)):
        _close(a, b, 1e-9, 1e-6)
    assert ostate["count"] == int(adam.count) == 3


@pytest.mark.parametrize("gscale", [0.1, 10.0])
def test_clip_and_adamw_update_match_optax_bf16(gscale):
    """Five updates of bf16 leaves on fixed gradients, with the clip idle
    (0.1) and active (10): the parameters and both moments bit for bit
    against optax, which rounds every op and every scalar to bf16 (3372
    elements: moments formed in fp32 and rounded once differ in a few of
    them per step)."""
    rng = np.random.default_rng(5)
    bf = jnp.bfloat16
    params = [rng.standard_normal(s).astype(np.float32) for s in ((64, 48), (300,))]
    grads = [gscale * rng.standard_normal(p.shape).astype(np.float32) for p in params]
    sched = joptim.make_lr_schedule(1e-2, 10, warmup_ratio=0.2)
    tx = joptim.make_optimizer(sched, weight_decay=0.01)
    jp = [jnp.asarray(p, bf) for p in params]
    jg = [jnp.asarray(g, bf) for g in grads]
    state = tx.init(jp)
    ours = optim.make_optimizer(optim.make_lr_schedule(1e-2, 10, warmup_ratio=0.2),
                                weight_decay=0.01)
    tp = [torch.tensor(p).to(torch.bfloat16) for p in params]
    tg = [torch.tensor(g).to(torch.bfloat16) for g in grads]
    ostate = ours.init(tp)
    for _ in range(5):
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        ostate = ours.update(tg, ostate, tp)
    adam = state[1][0]
    for a, b in zip(tp + ostate["mu"] + ostate["nu"], jp + list(adam.mu) + list(adam.nu)):
        assert a.dtype == torch.bfloat16 and b.dtype == bf
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


# ---------------------------------------------------------------- train step


@pytest.mark.parametrize("patterns", ["pretrain", "finetune"])
def test_stage1_steps_match_jax(patterns):
    """Three stage-1 steps (remat on) against the JAX step: the loss and
    the gradient norm of each step within 1e-5 (fp32, sums in another
    order); the trainable leaves after step 3: 99.9% within 1e-4 of lr
    (plus 1e-5 relative), all within the 2 lr per step by which Adam can
    move an element whose gradient is near its eps of 1e-8, where fp32
    noise decides the normalised step; the frozen leaves bit-unchanged."""
    pat = {"pretrain": (optim.STAGE1_PRETRAIN, joptim.STAGE1_PRETRAIN),
           "finetune": (optim.STAGE1_FINETUNE, joptim.STAGE1_FINETUNE)}[patterns]
    jcfg = jcore.UllavaCoreConfig.tiny(llm=jllama.LlamaConfig.tiny(vocab_size=160, remat=True),
                                       projector_from_scratch=patterns == "pretrain")
    cfg = ullava_core.UllavaCoreConfig.tiny(llm=llama.LlamaConfig.tiny(vocab_size=160, remat=True),
                                            projector_from_scratch=patterns == "pretrain")
    jparams = {"core": random_params(jcore.init_params, jcfg, seed=3)}
    batch = _core_batch(cfg, np.random.default_rng(3), [20, 15])
    lr = 1e-3

    tx = joptim.make_optimizer(lr)
    jstate, jlabels = jstep.make_train_state(
        jax.tree_util.tree_map(jnp.asarray, jparams), tx, pat[1])
    jfn = jstep.jit_step(jstep.make_stage1_step(jcfg, tx, jlabels))
    params = params_from_jax(jparams, device="cpu")
    before = [(n, t.clone()) for n, t in optim.named_leaves(params)]
    state, labels = make_train_state(params, optim.make_optimizer(lr), pat[0])
    fn = make_stage1_step(cfg, optim.make_optimizer(lr), labels)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = fn(state, tbatch)
        _close(m["loss"], jm["loss"], 1e-5, 1e-5)
        _close(m["grad_norm"], jm["grad_norm"], 1e-5, 1e-5)
    assert state.step == int(jstate.step) == 3
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu")
    n_train = 0
    for (name, t0), (_, t), (_, r), (_, lab) in zip(
            before, optim.named_leaves(state.params), optim.named_leaves(after),
            optim.named_leaves(labels)):
        if lab == "train":
            n_train += 1
            assert not torch.equal(t, t0), name
            diff = (t - r).abs()
            assert (diff <= 1e-4 * lr + 1e-5 * r.abs()).float().mean() >= 0.999, name
            assert diff.max() <= 3 * 2 * lr, name
        else:
            assert torch.equal(t, t0), name
    # Projector (w, b) and embed_tokens; or the projector, embed_tokens,
    # norm, lm_head and the nine leaves of each of the two layers.
    assert n_train == (3 if patterns == "pretrain" else 2 + 3 + 2 * 9)


# ---------------------------------------------------------------- trainer


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}
    out = str(tmp_path / "exp")
    for step in (10, 20, 30):
        ckpt.save_checkpoint(out, step, tree, save_total_limit=2)
    assert ckpt.list_checkpoints(out) == [20, 30]
    assert ckpt.latest_checkpoint(out).endswith("checkpoint-30")
    target = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    restored = ckpt.restore_checkpoint(ckpt.latest_checkpoint(out), target)
    assert restored["a"] is target["a"] and torch.equal(target["a"], tree["a"])
    assert torch.equal(target["b"]["c"], tree["b"]["c"])


def test_trainer_loop_and_resume(tmp_path, caplog):
    """The JAX package's `tests/test_training_infra.py:125-157`: two epochs
    of four batches with checkpoints every three steps (two kept), then a
    fresh trainer that resumes from checkpoint-8 and has nothing to do."""
    cfg = ullava_core.UllavaCoreConfig.tiny()
    params = {"core": ullava_core.init_params(cfg, torch.Generator().manual_seed(0), "cpu")}
    tx = optim.make_optimizer(5e-3)
    state, labels = make_train_state(params, tx, optim.STAGE1_FINETUNE)
    step = make_stage1_step(cfg, tx, labels)
    ids = torch.as_tensor(np.random.default_rng(0).integers(5, 100, size=(2, 12)))
    batch = {"input_ids": ids, "labels": ids, "attn_lens": torch.full((2,), 12, dtype=torch.int32)}
    loader = train.SyntheticLoader([dict(batch)] * 4)
    out_dir = str(tmp_path / "exp")
    training_cfg = {"num_train_epochs": 2, "save_steps": 3, "save_total_limit": 2,
                    "logging_steps": 2, "output_dir": out_dir}
    with caplog.at_level(logging.INFO):
        final = Trainer(state=state, step_fn=step, train_loader=loader,
                        training_cfg=training_cfg).train(resume=False)
    assert final.step == 8
    assert ckpt.list_checkpoints(out_dir) == [6, 8]
    assert "samples/s" in caplog.text
    trained = [t.clone() for _, t in optim.named_leaves(final.params)]

    state2, _ = make_train_state(
        {"core": ullava_core.init_params(cfg, torch.Generator().manual_seed(9), "cpu")},
        tx, optim.STAGE1_FINETUNE)
    resumed = Trainer(state=state2, step_fn=step, train_loader=loader,
                      training_cfg=training_cfg).train(resume=True)
    assert resumed.step == 8  # nothing left to do
    for a, (_, b) in zip(trained, optim.named_leaves(resumed.params)):
        assert torch.equal(a, b)


def test_train_stage1_entry_point(tmp_path):
    """`train.train_stage1` on the CPU: the synthetic batch of `make_batch`,
    the freeze policy from `projector_from_scratch` (CLIP and the LLM stay
    as they were), a falling loss, and the remat policies: 'dots' gives
    'full''s hidden states, any other raises ValueError."""
    cfg = ullava_core.UllavaCoreConfig.tiny(
        llm=llama.LlamaConfig.tiny(vocab_size=160, remat=True))
    params = ullava_core.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    frozen = [t.clone() for _, t in optim.named_leaves({"v": params["vision"], "l": params["llm"]["layers"]})]
    batch = train.make_batch(cfg, 2, 16, device="cpu")
    assert int((batch["labels"] != -100).sum()) == 2 * (16 - 3 - cfg.vision.num_patches)
    state = train.train_stage1(cfg, params, train.SyntheticLoader([batch] * 3),
                               {"learning_rate": 1e-2, "output_dir": str(tmp_path)}, device="cpu")
    assert state.step == 3 and ckpt.list_checkpoints(str(tmp_path)) == [3]
    now = [t for _, t in optim.named_leaves({"v": params["vision"], "l": params["llm"]["layers"]})]
    assert all(torch.equal(a, b) for a, b in zip(frozen, now))
    hidden = {policy: llama.forward(
        params["llm"], dataclasses.replace(cfg.llm, remat_policy=policy),
        input_ids=batch["input_ids"], compute_logits=False)["hidden_states"]
        for policy in ("full", "dots")}
    assert torch.equal(hidden["full"], hidden["dots"])
    with pytest.raises(ValueError):
        other = dataclasses.replace(cfg.llm, remat_policy="offload")
        llama.forward(params["llm"], other, input_ids=batch["input_ids"],
                      compute_logits=False)["hidden_states"].sum()
