"""Parity of the port's stage-2 training path with the JAX package at tiny
fp32 sizes: the segmentation and grounding losses, the [SEG]/[LOC]
readout, the multi-task forward and its gradients, LoRA (zero init, the
adapter branch, merge on a bf16 and an int8 base), the entry point, and
the port's two departures
from the JAX package: the LoRA freeze pattern that names the adapters,
and weight-only int8 linears under autograd. Weights go through
`bridge.params_from_jax`; inputs are drawn with numpy. Three train steps
against the jitted JAX step are in `test_torch_stage2_steps.py`.

Tolerances: fp32 on both sides, so losses and predictions agree to
summation-order noise (1e-5 relative); gradients of the deep stack to
1e-4 of each tensor's largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_batch, random_params, stage2_batch, stage2_cfgs, torch_batch
from ullava_tpu.models import llama as jllama
from ullava_tpu.models import loss as jloss
from ullava_tpu.models import ullava as jullava
from ullava_tpu.models import ullava_core as jcore
from ullava_tpu.ops import quant as jquant
from ullava_tpu.training import optim as joptim
from ullava_tpu_torch import train
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import llama, loss, ullava, ullava_core
from ullava_tpu_torch.ops import quant
from ullava_tpu_torch.training import checkpoint as ckpt
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import make_stage2_step, make_train_state

def setup_module():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------- losses


def _loss_case(name, rng):
    """(port value, JAX value, reference value or None) of one case of
    `tests/test_ullava_stage2.py:16-97`, and random boxes for IoU/GIoU."""
    if name in ("dice", "sigmoid_ce"):
        fn = {"dice": (loss.dice_loss, jloss.dice_loss),
              "sigmoid_ce": (loss.sigmoid_ce_loss, jloss.sigmoid_ce_loss)}[name]
        p = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
        g = (rng.random((1, 4, 8, 8)) > 0.5).astype(np.float32)
        v = np.array([[True, True, False, True]])
        if name == "dice":
            sp = torch.sigmoid(_t(p[0, v[0]])).flatten(1)
            tt = _t(g[0, v[0]]).flatten(1)
            num, den = 2 * (sp / 1000 * tt).sum(-1), (sp / 1000).sum(-1) + (tt / 1000).sum(-1)
            ref = ((1 - (num + 1e-6) / (den + 1e-6)).sum() / (3 + 1e-8)).item()
        else:
            ref = (torch.nn.functional.binary_cross_entropy_with_logits(
                _t(p[0, v[0]]), _t(g[0, v[0]]), reduction="none").flatten(1).mean(1).sum()
                / (3 + 1e-8)).item()
        return fn[0](_t(p), _t(g), _t(v)), fn[1](jnp.asarray(p), jnp.asarray(g), jnp.asarray(v)), ref
    if name in ("dice_pixel_valid", "sigmoid_ce_pixel_valid"):
        fn = (loss.dice_loss, jloss.dice_loss) if name.startswith("dice") else (
            loss.sigmoid_ce_loss, jloss.sigmoid_ce_loss)
        p = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
        g = (rng.random((2, 2, 8, 8)) > 0.5).astype(np.float32)
        v = np.array([[True, True], [False, True]])
        pv = np.zeros((2, 8, 8), bool)
        pv[0, :4, :4] = pv[1, :8, :5] = True
        crop = fn[0](_t(p[:1, :, :4, :4]), _t(g[:1, :, :4, :4]), _t(v[:1]))
        whole = fn[0](_t(p), _t(g), _t(v), _t(pv))
        assert abs(whole.item() - crop.item()) > 1e-6  # the region changes the loss
        return whole, fn[1](*(jnp.asarray(a) for a in (p, g, v, pv))), None
    if name == "giou_reference_values":
        b1 = np.array([[[2, 3.1, 7, 5], [3, 4, 8, 4.8], [4, 4, 5.6, 7]]], np.float32)
        b2 = np.array([[[2, 4, 7, 9], [3, 4, 8, 4.8], [4, 4, 5.6, 7]]], np.float32)
        v = np.ones((1, 3), bool)
        giou0 = 5.0 / 29.5 - (5 * 5.9 - 29.5) / (5 * 5.9)
        ref = (1 - giou0) / (3 + 1e-8) / (3 + 1e-8)  # normalised twice
        return (loss.bbox_giou_loss(_t(b1), _t(b2), _t(v)),
                jloss.bbox_giou_loss(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(v)), ref)
    if name == "giou_degenerate":
        pred = np.array([[[0, 0, 1, 1], [2, 2, 1, 1]]], np.float32)  # the second degenerate
        gt = np.array([[[0, 0, 1, 1], [0, 0, 1, 1]]], np.float32)
        v = np.ones((1, 2), bool)
        return (loss.bbox_giou_loss(_t(pred), _t(gt), _t(v)),
                jloss.bbox_giou_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(v)), 0.0)
    if name == "l1":
        pred, gt, v = np.zeros((1, 2, 4), np.float32), np.ones((1, 2, 4), np.float32), np.ones((1, 2), bool)
        return (loss.bbox_l1_loss(_t(pred), _t(gt), _t(v)),
                jloss.bbox_l1_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(v)), 8.0 / 2 / 2)
    if name == "boxes_random":
        lo = rng.random((3, 5, 2)).astype(np.float32)
        b1 = np.concatenate([lo, lo + rng.random((3, 5, 2)).astype(np.float32)], -1)
        b2 = np.concatenate([lo + 0.3, lo + 0.3 + rng.random((3, 5, 2)).astype(np.float32)], -1)
        b1[0, 0, 2] = b1[0, 0, 0] - 0.1  # one degenerate prediction
        v = rng.random((3, 5)) > 0.3
        got = torch.stack([loss.generalized_box_iou(_t(b1), _t(b2)).flatten().mean(),
                           loss.box_iou(_t(b1), _t(b2))[0].flatten().mean(),
                           loss.bbox_giou_loss(_t(b1), _t(b2), _t(v)),
                           loss.bbox_l1_loss(_t(b1), _t(b2), _t(v))])
        j1, j2, jv = jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(v)
        ref = jnp.stack([jloss.generalized_box_iou(j1, j2).mean(), jloss.box_iou(j1, j2)[0].mean(),
                         jloss.bbox_giou_loss(j1, j2, jv), jloss.bbox_l1_loss(j1, j2, jv)])
        return got, ref, None
    raise KeyError(name)


@pytest.mark.parametrize("name", ["dice", "sigmoid_ce", "dice_pixel_valid", "sigmoid_ce_pixel_valid",
                                  "giou_reference_values", "giou_degenerate", "l1", "boxes_random"])
def test_losses_match_jax_and_the_reference_formulas(name):
    got, ref, expected = _loss_case(name, np.random.default_rng(len(name)))
    _close(got, ref)
    if expected is not None:
        assert abs(got.item() - expected) < 1e-5


def test_token_readout_matches_jax():
    """Four [SEG] in row 0 (three slots: the last is cut), one at position
    0 (never read) and one past the row's length in row 1, none in row 2;
    the token at position p reads hidden[p - 1]."""
    rng = np.random.default_rng(7)
    ids = rng.integers(5, 100, size=(3, 16))
    ids[0, [3, 6, 9, 12]] = 154
    ids[1, [0, 4, 14]] = 154
    lens = np.array([16, 12, 16], np.int32)
    hidden = rng.standard_normal((3, 16, 8)).astype(np.float32)
    h, valid = ullava._token_readout(_t(ids), _t(hidden), _t(lens), 154, 3)
    jh, jvalid = jullava._token_readout(jnp.asarray(ids), jnp.asarray(hidden), jnp.asarray(lens), 154, 3)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(valid.numpy(), [[1, 1, 1], [1, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(h[0].numpy(), hidden[0, [2, 5, 8]])


# ---------------------------------------------------------------- forward


@pytest.fixture(scope="module")
def tiny_stage2():
    jcfg, cfg = stage2_cfgs()
    jparams = random_params(jullava.init_params, jcfg, seed=3)
    return jcfg, cfg, jparams


def test_forward_losses_and_gradients_match_jax(tiny_stage2):
    """`forward` with labels: every loss and prediction against the JAX
    forward; the gradients of the heads, the mask decoder, the embeddings
    and lm_head against `jax.grad` (1e-4 of each tensor's largest value,
    plus 1e-9 for leaves the loss barely reaches);
    none reaches the SAM image encoder or CLIP (`no_grad` there, JAX
    `stop_gradient`), as `tests/test_ullava_stage2.py:148-192` holds."""
    jcfg, cfg, jparams = tiny_stage2
    batch = stage2_batch(cfg, np.random.default_rng(4))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)

    def jloss_fn(p):
        out = jullava.forward(p, jcfg, **jax_batch(batch))
        return out["loss"], out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jp)
    params = params_from_jax(jparams, device="cpu")
    leaves = [(n, t) for n, t in optim.named_leaves(params)]
    for _, t in leaves:
        t.requires_grad_(True)
    out = ullava.forward(params, cfg, **torch_batch(batch))
    for key in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "mask_loss", "bbox_loss"):
        _close(out[key], jout[key])
    for key in ("pred_masks", "low_res_masks", "pred_boxes", "iou_pred"):
        _close(out[key], jout[key], rtol=1e-4, atol=1e-4 * float(np.abs(jout[key]).max()))
    np.testing.assert_array_equal(out["seg_valid"].numpy(), np.asarray(jout["seg_valid"]))
    np.testing.assert_array_equal(out["seg_valid"].sum(1).numpy(), [2, 1])
    np.testing.assert_array_equal(out["loc_valid"].sum(1).numpy(), [1, 1])
    assert out["pred_masks"].shape == (2, cfg.max_masks, 64, 64)

    grads = torch.autograd.grad(out["loss"], [t for _, t in leaves], allow_unused=True)
    ours = _grouped((n, g) for (n, _), g in zip(leaves, grads))
    theirs = _grouped(optim.named_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    for name in ("seg_projector/fc0/w", "det_projector/fc1/w", "det_decoder/fc0/w",
                 "sam/mask_decoder/layers/self_attn/q/w"):
        assert all(float(g.abs().sum()) > 0 for g in ours[name]), name
    for name, gs in ours.items():
        if name.startswith(("sam/image_encoder", "core/vision")):
            assert all(g is None for g in gs), name  # under no_grad
            assert not any(np.abs(j).any() for j in theirs[name]), name
        elif name.startswith(("seg_projector", "det_projector", "det_decoder", "sam/",
                              "core/llm/embed_tokens", "core/llm/lm_head")):
            assert len(gs) == len(theirs[name]), name
            for g, j in zip(gs, theirs[name]):
                # A leaf the loss does not reach has no gradient here, zeros there.
                g = torch.zeros(j.shape) if g is None else g
                _close(g, j, rtol=0, atol=1e-4 * float(np.abs(j).max()) + 1e-9)


def _grouped(pairs):
    """{path: [leaves]}: list elements (the mask decoder's layers) share a
    path, and both packages walk them in the same order."""
    out = {}
    for name, leaf in pairs:
        out.setdefault(name, []).append(leaf)
    return out


# ---------------------------------------------------------------- LoRA


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_lora_zero_init_branch_and_merge_match_jax(base):
    """`tests/test_training_infra.py:73-100`, on both packages: adapters
    leave the logits as they were; with a nonzero B the port's LoRA branch
    gives the JAX logits (the adapters carried by the bridge), and
    `merge_lora` gives JAX's merged weights (an int8 base dequantized,
    folded and requantized: >= 99.9% of the int8 values equal, the rest
    within 1) and the adapted logits (bf16 base: 1e-4; int8 base: within
    the requantization, 2e-2 of the largest logit)."""
    jcfg, cfg = jllama.LlamaConfig.tiny(), llama.LlamaConfig.tiny()
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jllama.init_params, jcfg, seed=5))
    if base == "int8":
        jp = jquant.quantize_tree(jp, jquant.LLAMA_QUANT_KEYS)
    ids = np.arange(8, dtype=np.int64)[None]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    base_out = llama.forward(params, cfg, input_ids=_t(ids))["logits"]
    lora = llama.add_lora(params, cfg, torch.Generator().manual_seed(1), r=4)
    assert lora["layers"][0]["q_proj_lora_a"].shape == (64, 4)
    assert not lora["layers"][0]["v_proj_lora_b"].any()
    _close(llama.forward(lora, cfg, input_ids=_t(ids))["logits"], base_out, rtol=0, atol=1e-6)

    jl = jllama.add_lora(jp, jcfg, jax.random.PRNGKey(1), r=4)
    jl["layers"]["q_proj_lora_b"] = jl["layers"]["q_proj_lora_b"] + 0.01
    jl["layers"]["v_proj_lora_b"] = jl["layers"]["v_proj_lora_b"] - 0.02
    bumped = params_from_jax(jax.tree_util.tree_map(np.asarray, jl), device="cpu")
    ref = jllama.forward(jl, jcfg, input_ids=jnp.asarray(ids, jnp.int32))["logits"]
    adapted = llama.forward(bumped, cfg, input_ids=_t(ids))["logits"]
    _close(adapted, ref, rtol=1e-5, atol=1e-5)
    assert float((adapted - base_out).abs().max()) > 1e-4

    merged = llama.merge_lora(bumped, cfg)
    jmerged = jllama.merge_lora(jl, jcfg)
    assert "q_proj_lora_a" not in merged["layers"][0] and "q_proj_lora_a" in bumped["layers"][0]
    for i, lp in enumerate(merged["layers"]):
        for name in ("q_proj", "v_proj"):
            w, jw = lp[name], jax.tree_util.tree_map(lambda a: np.asarray(a[i]), jmerged["layers"][name])
            if base == "int8":
                diff = np.abs(w["q"].numpy().astype(np.int32) - jw["q"].astype(np.int32))
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
                _close(w["scale"], jw["scale"], rtol=1e-6)
            else:
                _close(w, jw, rtol=1e-6, atol=1e-7)
    out = llama.forward(merged, cfg, input_ids=_t(ids))["logits"]
    tol = 1e-4 if base == "bf16" else 2e-2 * float(adapted.abs().max())
    _close(out, adapted, rtol=0, atol=tol)
    # LoRA layers never take the fused norm + quantize prefill.
    serve = dataclasses.replace(cfg, a8_prefill=True)
    assert llama._use_fused_norm_quant(serve, merged["layers"][0], 8) == (base == "int8")
    assert not llama._use_fused_norm_quant(serve, bumped["layers"][0], 8)


# ---------------------------------------------------------------- departures


def test_lora_policy_names_and_trains_the_adapters():
    """The port's `STAGE2_LORA` labels all four adapters of every layer
    "train" and two steps move them (B in the first, A in the second, as B
    starts at zero). The JAX package's pattern names none of them."""
    jcfg, cfg = stage2_cfgs()
    params = ullava.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cfg, params = train.build_stage2(cfg, params, lora_r=4, device="cpu")
    labels = dict((n, lab) for n, lab in optim.named_leaves(optim.trainable_labels(
        params, optim.STAGE2_LORA)) if "lora" in n)
    assert labels == {f"core/llm/layers/{p}_proj_lora_{ab}": "train" for p in "qv" for ab in "ab"}
    jlabels = [lab for n, lab in optim.named_leaves(optim.trainable_labels(
        params, joptim.STAGE2_LORA)) if "lora" in n]
    assert jlabels and set(jlabels) == {"freeze"}
    adapters = [lp[k] for lp in params["core"]["llm"]["layers"] for k in lp if "lora" in k]
    start = [a.clone() for a in adapters]
    state, labs = make_train_state(params, optim.make_optimizer(1e-2), optim.STAGE2_LORA)
    step = make_stage2_step(cfg, optim.make_optimizer(1e-2), labs)
    batch = train.make_stage2_batch(cfg, 2, 24, device="cpu")
    for _ in range(2):
        state, _ = step(state, batch)
    assert all(not torch.equal(a, s) for a, s in zip(adapters, start))


def test_int8_linears_under_autograd_take_the_weight_only_gradient():
    """With `a8_prefill` an int8 LLM linear is W8A8 when nothing needs its
    gradient (serving: the logits differ from weight-only), and weight-only
    under autograd: the gradients to the adapters and the input embeddings
    equal those of `a8_prefill=False` exactly, and match the JAX weight-
    only gradient, where the JAX package's W8A8 gradient does not."""
    cfg = llama.LlamaConfig.tiny(a8_prefill=True)
    jcfg = jllama.LlamaConfig.tiny(a8_prefill=True)
    jp = jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, random_params(
        jllama.init_params, jcfg, seed=9)), jquant.LLAMA_QUANT_KEYS)
    jp = jllama.add_lora(jp, jcfg, jax.random.PRNGKey(4), r=4)
    jp["layers"]["q_proj_lora_b"] = jp["layers"]["q_proj_lora_b"] + 0.05
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(9).standard_normal((2, 12, 64)).astype(np.float32)
    proj = np.random.default_rng(10).standard_normal((64,)).astype(np.float32)

    def port_grads(c):
        emb = _t(x).requires_grad_(True)
        adapters = [lp["q_proj_lora_a"].requires_grad_(True) for lp in params["layers"]]
        h = llama.forward(params, c, inputs_embeds=emb, compute_logits=False)["hidden_states"]
        return torch.autograd.grad((h @ _t(proj)).square().sum(), [emb, *adapters])

    w8a8, weight_only = port_grads(cfg), port_grads(dataclasses.replace(cfg, a8_prefill=False))
    for a, b in zip(w8a8, weight_only):
        assert torch.equal(a, b)
    with torch.no_grad():
        served = llama.forward(params, cfg, inputs_embeds=_t(x), compute_logits=False)["hidden_states"]
        plain = llama.forward(params, dataclasses.replace(cfg, a8_prefill=False), inputs_embeds=_t(x),
                              compute_logits=False)["hidden_states"]
    assert float((served - plain).abs().max()) > 1e-5

    def jax_grad(c):
        def f(e):
            h = jllama.forward(jp, c, inputs_embeds=e, compute_logits=False)["hidden_states"]
            return jnp.square(h @ jnp.asarray(proj)).sum()
        return np.asarray(jax.grad(f)(jnp.asarray(x)))

    ref = jax_grad(dataclasses.replace(jcfg, a8_prefill=False))
    _close(weight_only[0], ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    a8 = jax_grad(jcfg).ravel()
    cos = float(a8 @ ref.ravel() / (np.linalg.norm(a8) * np.linalg.norm(ref) + 1e-30))
    assert cos < 0.9  # the W8A8 gradient is another gradient


# ---------------------------------------------------------------- entry point


def test_train_stage2_entry_point(tmp_path):
    """`train.train_stage2` on the CPU over `build_stage2`'s model (int8
    towers, LoRA r=8, `lora_scale` = 16 / 8) and `make_stage2_batch`'s
    batch (bench.py's layout: [SEG] and [LOC] after the image span, one
    valid slot of three): three steps, a checkpoint, a finite loss, and
    the frozen towers, projector and LLM base weights as they were. With
    `quantize="int8"` the LLM is int8 as well and still trains its
    adapters."""
    _, cfg = stage2_cfgs()
    params = ullava.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    cfg, params = train.build_stage2(cfg, params, device="cpu")
    assert cfg.core.llm.lora_scale == 2.0
    assert quant.is_quantized(params["sam"]["image_encoder"]["global_blocks"][0]["qkv"])
    assert quant.is_quantized(params["core"]["vision"]["layers"][0]["q_proj"])
    batch = train.make_stage2_batch(cfg, 2, 24, seed=1, device="cpu")
    P = cfg.core.vision.num_patches
    assert (batch["input_ids"][:, 2 + P + 2] == cfg.seg_token_idx).all()
    assert batch["mask_valid"].tolist() == [[True, False, False]] * 2
    def frozen():
        return [t for n, t in optim.named_leaves(params)
                if n.startswith(("sam/image_encoder", "core/vision", "core/projector"))
                or n in ("core/llm/layers/q_proj", "core/llm/layers/o_proj")]

    before = [t.clone() for t in frozen()]
    state = train.train_stage2(cfg, params, train.SyntheticLoader([batch] * 3),
                               {"learning_rate": 1e-2, "output_dir": str(tmp_path)}, device="cpu")
    assert state.step == 3 and ckpt.list_checkpoints(str(tmp_path)) == [3]
    assert all(torch.equal(a, b) for a, b in zip(before, frozen()))

    params8 = ullava.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    cfg8, params8 = train.build_stage2(stage2_cfgs()[1], params8, quantize="int8", lora_r=4, device="cpu")
    assert cfg8.core.llm.lora_scale == 4.0
    assert quant.is_quantized(params8["core"]["llm"]["layers"][0]["q_proj"])
    state8, step8, _ = train.build_stage2_step(cfg8, params8, {"lr_scheduler_type": "constant"}, 2)
    state8, m = step8(state8, batch)
    assert np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0
    with pytest.raises(ValueError):
        train.build_stage2(cfg, params, quantize="int4", device="cpu")
    assert ullava_core.UllavaCoreConfig.tiny().fused_ce and jcore.UllavaCoreConfig.tiny().fused_ce
