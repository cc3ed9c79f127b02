"""Per-step gradient readings of a small stage-2 model, leaf by leaf.

The model is the one `chip_smoke.py`'s stage-2 check holds to the CPU
(`build`): LLaMA 2 x 256 wide at head_dim 128, a tiny CLIP, a SAM
encoder of depth 2 at the widths the SAM kernels are built for, int8
weight-only towers and LoRA r=8. The card follows its own trajectory
for three steps; before each step its parameters are copied to the CPU,
and the step's gradients on the card (bf16, through the kernels) are
read against the same step in fp32 on the CPU (plain versions), leaf by
leaf (`step_reading`). Beside them stand four witnesses of the same step
from the same parameters, each read against fp32 the same way: the CPU
in the card's dtypes (bf16 through the plain versions), and the card
with K15, with every LLM kernel (K9, K15-K18) and with every kernel of
the step swapped for its plain version. A witness that reads the card's
error on a leaf shows that error is bf16's, not a kernel's.

`read_draw` prints one JSON line a step (the card's five worst leaves
that carry 1e-3 of the gradient norm, each with every witness's error and
its distance from the card's gradient); `python3 chip_smoke.py
--check-draws SEED ...` runs it on the draw of each seed's stage-2 check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Dict, List, Tuple

import torch

from ullava_tpu_torch import kernels, train
from ullava_tpu_torch.models import clip_vit, llama, ullava, ullava_core
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import (attention, decode_attention, mlp_kernel, norms, rope,
                                  sam_attention)
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import stage2_loss, trainable_grads

TCFG = {"learning_rate": 1e-3, "lr_scheduler_type": "constant"}


def build(gen: torch.Generator):
    """(cfg, cfg32, params on the card, batch on the card, batch on the
    CPU): the widths the SAM kernels are built for (img 1024, grid 64,
    window 14, 8 heads of 80 so that a head slab is 128-aligned, F 2560;
    one window and one global block) and LLaMA at hd 128 (2 x 256 wide, 2
    heads; tiny CLIP), through `train.build_stage2` (int8 towers, LoRA
    r=8) with random rel-pos tables; B=2, S=200 with a short second row,
    masks scored at the 256 frame."""
    cfg = ullava.UllavaConfig(
        core=ullava_core.UllavaCoreConfig(
            llm=llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                  num_layers=2, num_heads=2, num_kv_heads=2, remat=True,
                                  attn_impl="flash"),
            vision=clip_vit.CLIPVisionConfig.tiny(dtype=torch.bfloat16),
            img_start_id=500, img_end_id=501, vid_start_id=502, vid_end_id=503,
            projector_from_scratch=False),
        sam=sam_build.SamConfig(vision=image_encoder.SamVisionConfig(
            embed_dim=640, depth=2, num_heads=8, global_attn_indexes=(1,), out_chans=256)),
        seg_token_idx=504, loc_token_idx=505, mask_loss_frame=256,
    )
    params = ullava.init_params(cfg, gen, "cuda")
    enc = params["sam"]["image_encoder"]
    for blk in enc["window_blocks"] + enc["global_blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk[key].normal_(0, 0.5, generator=gen)
    cfg, params = train.build_stage2(cfg, params)
    f32 = torch.float32
    cfg32 = dataclasses.replace(
        cfg, core=dataclasses.replace(
            cfg.core, llm=dataclasses.replace(cfg.core.llm, dtype=f32),
            vision=dataclasses.replace(cfg.core.vision, dtype=f32)),
        sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(cfg.sam.vision, dtype=f32)))
    batch = train.make_stage2_batch(cfg, 2, 200, seed=2, device="cuda")
    batch["attn_lens"] = torch.tensor([200, 131], dtype=torch.int32, device="cuda")
    return cfg, cfg32, params, batch, {k: v.cpu() for k, v in batch.items()}


def cpu_copy(tree: Any, fp32: bool = True, device: str = "cpu") -> Any:
    """A copy of a parameter tree on `device` (the CPU unless given),
    floating leaves in fp32 (or in their own dtype); int8 weights stay
    int8."""
    if isinstance(tree, dict):
        return {k: cpu_copy(v, fp32, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cpu_copy(v, fp32, device) for v in tree]
    t = tree.detach().to(device)
    return t.float() if fp32 and t.is_floating_point() else t


def leaf_names(params: Any, labels: Any) -> List[str]:
    """Names of the leaves `labels` trains, in the order of their
    gradients, each with its index among them."""
    names = [n for (n, leaf), (_, lab) in zip(optim.named_leaves(params), optim.named_leaves(labels))
             if isinstance(leaf, torch.Tensor) and lab == "train"]
    return [f"{n}#{i}" for i, n in enumerate(names)]


def step_reading(names, grads, grads32) -> Tuple[Dict, Dict]:
    """One step's gradients against the CPU's fp32 ones from the same
    parameters: (summary, {leaf: reading}), each leaf's reading its
    relative error ||g - g32|| / ||g32||, the share of its elements whose
    sign agrees (over those nonzero in g32) and its share of the norm; the
    summary names the worst leaf over all and over the leaves that carry
    at least 1e-3 of the norm (a key bias of an attention has a gradient of
    zero but for rounding, whose error and signs are noise on both sides)."""
    leaves, total = {}, sum(r.float().norm().item() ** 2 for r in grads32) ** 0.5
    for name, g, r in zip(names, grads, grads32):
        g, r = g.float().cpu(), r.float()
        ref = r.norm().item()
        live = r != 0
        leaves[name] = {
            "rel_err": (g - r).norm().item() / ref if ref > 0 else (g.norm().item() > 0) * 1.0,
            "sign_agree": (torch.sign(g[live]) == torch.sign(r[live])).float().mean().item()
            if bool(live.any()) else 1.0,
            "share": ref / total,
        }
    out = {"leaves": len(leaves)}
    for tag, keep in (("all", list(leaves)),
                      ("carrying", [n for n in leaves if leaves[n]["share"] >= 1e-3])):
        worst = max(keep, key=lambda n: leaves[n]["rel_err"])
        signs = min(keep, key=lambda n: leaves[n]["sign_agree"])
        out[tag] = {"leaves": len(keep), "worst_leaf": worst, **leaves[worst],
                    "least_sign_leaf": signs, "least_sign_agree": leaves[signs]["sign_agree"]}
    return out, leaves


def _plain_patches(scope: str):
    """(module, name, plain stand-in) for the wrappers of `scope` ('k15',
    'llm', 'int8_llm' or 'all'), each as the wrapper's own CPU branch calls
    it. 'int8_llm' adds the serving LLM's kernels (K1, K5-K8) at their call
    sites in `models/llama.py`; 'all' adds the SAM encoder's."""
    A, N, M, S, E = attention, norms, mlp_kernel, sam_attention, image_encoder
    D, L, R = decode_attention, llama, rope
    out = [(A, "flash_attention_fwd", A.flash_attention_fwd_plain)]
    if scope == "k15":
        return out
    out += [(A, "flash_attention_fwd_bsh", A.flash_attention_fwd_bsh_plain),
            (A, "flash_attention_bwd", A.flash_attention_bwd_plain),
            (N, "_rms_norm_fwd", N.rms_norm_plain),
            (N, "rms_norm_bwd", N.rms_norm_bwd_plain)]
    if scope == "llm":
        return out
    out += [(L, "fused_rotary", R.fused_rotary_plain),
            (L, "rms_norm_residual_quant", N.rms_norm_residual_quant_plain),
            (L, "silu_mul_quant", M.silu_mul_quant_plain),
            (L, "prefill_quantize_write", D.prefill_quantize_write_plain),
            (L, "decode_attention_int8_fused_write", D.decode_attention_int8_fused_write_plain)]
    if scope == "int8_llm":
        return out

    # Each with its wrapper's parameter names: the encoder passes some by name.
    def linear(x, w_q, w_scale, bias, residual=None, w8a8=True):
        return M.fused_ln_linear_plain(x, None, None, w_q, w_scale, bias, 0.0, w8a8, residual)

    def mlp(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2, eps, f_chunk=0,
            w8a8=False):
        f_chunk = f_chunk or M.default_f_chunk(w1_q.shape[1])
        return M.fused_mlp_block_plain(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale,
                                       b2, eps, f_chunk, w8a8)

    def grid(y, bias_a, bias_b, num_heads, head_dim, window, scale, total_rows=0, dots_i8=False):
        return S.fused_window_attention_grid_plain(y, bias_a, bias_b, num_heads, head_dim, window,
                                                   scale, dots_i8)

    def rect(y, bias_a, bias_b, oh, pad_k, pad_v, num_heads, head_dim, window, scale,
             dots_i8=False, geometry=None):
        return S.fused_window_attention_rect_plain(y, bias_a, bias_b, oh, pad_k, pad_v, num_heads,
                                                   head_dim, window, scale, dots_i8)

    def global_y(y, bias_a, bias_b, num_heads, head_dim, window, scale, head_group=0,
                 exp_bf16=False, dots_i8=False):
        return S.fused_global_attention_y_plain(y, bias_a, bias_b, num_heads, head_dim, window,
                                                scale, exp_bf16=exp_bf16, dots_i8=dots_i8)

    return out + [(E, "fused_ln_linear", M.fused_ln_linear_plain), (E, "fused_linear", linear),
                  (E, "fused_ln_linear_dual", M.fused_ln_linear_dual_plain),
                  (E, "fused_mlp_block", mlp), (E, "fused_window_attention_grid", grid),
                  (E, "fused_window_attention_rect", rect),
                  (E, "fused_global_attention_y", global_y),
                  (E, "fused_global_attention", S.fused_global_attention_plain),
                  (E, "fused_window_attention_packed", S.fused_window_attention_packed_plain),
                  (E, "fused_global_attention_packed", S.fused_global_attention_packed_plain)]


@contextlib.contextmanager
def plain_on_card(scope: str):
    """Within the block, the wrappers of `scope` run their plain versions
    on the card's tensors."""
    patches = _plain_patches(scope)
    saved = [getattr(mod, name) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name, _), fn in zip(patches, saved):
            setattr(mod, name, fn)


# What each scope's witness must not launch (`all`: nothing at all).
_SCOPE_KERNELS = {
    "k15": {"flash_attention_fwd_lse"},
    "llm": {"flash_attention_fwd_lse", "flash_attention_fwd_bsh", "flash_attention_bwd_delta",
            "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "rms_norm_fwd", "rms_norm_bwd"},
}
_SCOPE_KERNELS["int8_llm"] = _SCOPE_KERNELS["llm"] | {
    "fused_rotary", "rms_norm_residual_quant", "silu_mul_quant", "prefill_quantize_write",
    "decode_attention_int8_fused_write"}


def _launched(fn):
    """(fn(), the kernels it launched with their counts)."""
    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}


def read_draw(gen: torch.Generator, seed: int) -> None:
    """The readings of one draw: `build(gen)`, then three steps along the
    card's trajectory, one JSON line each."""
    cfg, cfg32, params, batch, batch32 = build(gen)
    state, step, _ = train.build_stage2_step(cfg, params, TCFG, 4)
    labels = optim.trainable_labels(params, optim.STAGE2_LORA)
    names = leaf_names(params, labels)
    loss_fn, loss_fn32 = stage2_loss(cfg), stage2_loss(cfg32)
    for i in range(3):
        p32, pbf = cpu_copy(state.params), cpu_copy(state.params, fp32=False)
        grads32 = trainable_grads(loss_fn32, p32, labels, batch32)[2]
        grads, launched = _launched(lambda: trainable_grads(loss_fn, state.params, labels, batch)[2])
        card, leaves = step_reading(names, grads, grads32)
        norm32 = optim.global_norm(grads32).item()
        card["grad_norm_rel_err"] = abs(optim.global_norm(grads).float().item() - norm32) / norm32
        card["launched"] = launched
        worst = sorted((n for n in leaves if leaves[n]["share"] >= 1e-3),
                       key=lambda n: -leaves[n]["rel_err"])[:5]
        rows = {n: {"share": leaves[n]["share"], "card": leaves[n]["rel_err"]} for n in worst}
        witnesses = {"cpu_bf16": lambda: (trainable_grads(loss_fn, pbf, labels, batch32)[2], {})}
        for scope in ("k15", "llm", "all"):
            def on_card(scope=scope):
                with plain_on_card(scope):
                    g, ran = _launched(
                        lambda: trainable_grads(loss_fn, state.params, labels, batch)[2])
                if set(ran) & _SCOPE_KERNELS.get(scope, set(ran)):
                    raise AssertionError(f"the plain witness '{scope}' launched {ran}")
                return g, ran
            witnesses[f"card_plain_{scope}"] = on_card
        read = {}
        for key, fn in witnesses.items():
            g, ran = fn()
            summary, lv = step_reading(names, g, grads32)
            read[key] = {"grad_norm_rel_err":
                         abs(optim.global_norm(g).float().item() - norm32) / norm32,
                         "carrying": summary["carrying"], "launched": ran}
            for n in worst:
                a, b, r = (t.float().cpu() for t in
                           (g[names.index(n)], grads[names.index(n)], grads32[names.index(n)]))
                rows[n][key] = [lv[n]["rel_err"], ((a - b).norm() / r.norm()).item()]
            del g
        print(json.dumps({"phase": "stage2_grads", "seed": seed, "step": i, "card": card,
                          "witnesses": read, "worst_leaves": rows,
                          "worst_leaves_note": "each witness: [error against fp32, "
                                               "distance from the card's gradient]"}),
              flush=True)
        del grads, grads32
        state, _ = step(state, batch)
