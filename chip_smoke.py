#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`ullava_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on any error:
  1. build   - compiles every CUDA kernel of the port from `kernels/csrc`
               (one nvcc per source, in parallel) and prints the build time;
  2. kernels - runs each kernel and its plain PyTorch version on the same
               inputs at the serving shapes (bf16, B=4), holds the kernel to
               the plain version within a stated tolerance, and times the
               kernel, the plain version and, where one exists, a single
               PyTorch library call computing the same function (L2
               flushed before each timed call); a mutated run of each
               kernel must fail the same gate;
  3. serve   - builds the full-width bf16 RES model (LLaMA-7B, CLIP
               ViT-L/14, SAM ViT-H) from a seeded generator on the card,
               serves B=4 requests (320-token prompts: 256 image tokens + 64
               text, 32 greedy new tokens, one mask each) through
               `serve.serve`, checks shapes, finiteness and that every
               kernel was launched, then times three more serves
               (median), each phase alone, and one serve under the
               profiler;
  4. check   - runs a small model on the card and on the CPU (plain
               versions, fp32) from the same weights and holds the card's
               masks and readout to the CPU reference;
  5. summary - prints the serve numbers again, the card's name and power
               limit, one JSON line with every kernel's numbers, and last
               the device line.

Exits non-zero with no result when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores

B = 4  # requests per batch
PROMPT = 320  # 256 image tokens + 64 text tokens
NEW_TOKENS = 32


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` calls, each timed alone with
    CUDA events after a 256 MB write that evicts the 50 MB L2, so that
    its inputs come from HBM as on the main path."""
    import torch

    for _ in range(warmup):
        fn()
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in ev) / iters


def row_rel_err(got, ref) -> float:
    """max over output rows of max|got - ref| / max|ref| on that row: an
    error in units of each row's own scale (all-zero rows count 0)."""
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    err = (got - ref).abs().amax(-1)
    return (err / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_phases(gen) -> dict:
    """Each kernel against its plain version at the serving shapes.

    The gate is `row_rel_err` within `tol` = 1e-2: one bf16 ulp of a
    row's largest value is at most 2^-7 = 0.0078 of it, so the gate admits
    one ulp of disagreement there and not two. It must also reject a wrong
    kernel: each kernel is run once more on a mutated input that stands
    for a typical bug (rotation sign, causal mask, bias dropped or its two
    terms swapped), and that output, held to the same reference, must
    fail the gate."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import attention, rope, sam_attention

    dev = "cuda"
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}

    def record(name, got, ref, mutants, tol, kern, plain, library, in_out, flops, iters=20):
        err = row_rel_err(got, ref)
        if not err <= tol:
            raise AssertionError(f"{name}: row_rel_err {err} > tol {tol}")
        caught = {m: row_rel_err(out, ref) for m, out in mutants.items()}
        missed = {m: e for m, e in caught.items() if not e > tol}
        if missed:
            raise AssertionError(f"{name}: the gate does not catch {missed}")
        b_ms, b_by = bound_ms(in_out, flops)
        spec = kernels.KERNELS[name]
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": f"ullava_tpu_torch/kernels/csrc/{spec.source}",
            "replaces": spec.replaces,
            "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "row_rel_err": err,
            "tol": tol,
            "mutant_row_rel_err": caught,
            "ms": time_ms(kern, iters),
            "plain_ms": time_ms(plain, max(3, iters // 4), warmup=1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if library is None else time_ms(library, iters),
        }
        log(f"[kernel] {json.dumps(results[name])}")

    # K1: rotary on the q (or k) rows of one 7B prefill layer. Both round
    # one fp32 result to bf16: one ulp is 2^-8 of the value.
    R, hd, width = B * PROMPT, 128, 4096
    x = randn(R, width)
    pos = torch.arange(PROMPT, device=dev).repeat(B)
    cos, sin = rope.rope_cos_sin(pos, hd)
    record("fused_rotary", rope.fused_rotary(x, cos, sin, hd),
           rope.fused_rotary_plain(x, cos, sin, hd),
           {"sin_negated": rope.fused_rotary(x, cos, -sin, hd)}, 1e-2,
           lambda: rope.fused_rotary(x, cos, sin, hd),
           lambda: rope.fused_rotary_plain(x, cos, sin, hd), None,
           2 * nbytes(x) + nbytes(cos, sin), 6.0 * x.numel())

    # K2: causal prefill attention of one 7B layer, ragged kv_lens. p is
    # rounded to bf16 against a running (kernel) or global (plain) max,
    # and the output to bf16: a few 2^-9 of each row's scale.
    H = 32
    q, k, v = (randn(B, PROMPT, H, hd) for _ in range(3))
    lens = torch.tensor([PROMPT, PROMPT - 3, PROMPT - 30, 257], device=dev, dtype=torch.int32)
    sc = hd**-0.5
    run = lambda: attention.flash_attention_fwd_bsh(q, k, v, lens, causal=True, scale=sc)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kp = torch.arange(PROMPT, device=dev)
    mask = (kp[None, :] <= kp[:, None])[None, None] & (kp[None, :] < lens[:, None])[:, None, None, :]
    live = sum(min(i + 1, int(n)) for n in lens.tolist() for i in range(PROMPT)) * H
    record("flash_attention_fwd_bsh", run(),
           attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=sc),
           {"not_causal": attention.flash_attention_fwd_bsh(q, k, v, lens, causal=False, scale=sc)},
           1e-2, run,
           lambda: attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=sc),
           lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sc),
           nbytes(q, k, v, lens) + nbytes(q), 4.0 * hd * live)
    del qt, kt, vt, mask

    # K3: one ViT-H window block at B=4: 100 windows of 14x14, 16 heads.
    # The encoder's bias terms are q.rel_pos with an unscaled q: a few
    # units (std 2 here), handed to K3 pre-scaled by 1/scale.
    N, S, Hs, hds, W = B * 25, 196, 16, 80, 14
    sc = hds**-0.5
    y = randn(N, S, 3 * Hs * hds)
    a = randn(N, S, Hs * W, scale=2.0 / sc)
    bb = randn(N, S, Hs * W, scale=2.0 / sc)
    zero = torch.zeros_like(a)
    run = lambda: sam_attention.fused_window_attention_grid(y, a, bb, Hs, hds, W, sc)  # noqa: E731
    y5 = y.reshape(N, S, 3, Hs, hds).permute(2, 0, 3, 1, 4).contiguous()
    A = a.reshape(N, S, Hs, W).flip(-1).permute(0, 2, 1, 3).float()
    Bm = bb.reshape(N, S, Hs, W).flip(-1).permute(0, 2, 1, 3).float()
    wmask = ((A[..., :, None] + Bm[..., None, :]).reshape(N, Hs, S, S) * sc).to(bf)
    record("fused_window_attention_grid", run(),
           sam_attention.fused_window_attention_grid_plain(y, a, bb, Hs, hds, W, sc),
           {"bias_dropped": sam_attention.fused_window_attention_grid(y, zero, zero, Hs, hds, W, sc),
            "bias_swapped": sam_attention.fused_window_attention_grid(y, bb, a, Hs, hds, W, sc)},
           1e-2, run,
           lambda: sam_attention.fused_window_attention_grid_plain(y, a, bb, Hs, hds, W, sc),
           lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=wmask, scale=sc),
           nbytes(y, a, bb) + nbytes(y) // 3, 4.0 * N * Hs * S * S * hds)
    del y5, A, Bm, wmask, y, zero

    # K4: one ViT-H global block at B=4: 64 (image, head) pairs over 4096.
    # The bias terms come from `decomposed_bias_terms` as in the encoder:
    # unscaled q against rel_pos tables of std 0.25 (std about 2.2).
    N, S, W = B * Hs, 4096, 64
    q, k, v = (randn(N, S, hds) for _ in range(3))
    rel_h, rel_w = (randn(2 * W - 1, hds, scale=0.25) for _ in range(2))
    a, bb = (t.reshape(N, S, W).to(bf) for t in sam_attention.decomposed_bias_terms(
        q.reshape(B, Hs, W, W, hds), rel_h, rel_w, W))
    zero = torch.zeros_like(a)
    run = lambda: sam_attention.fused_global_attention(q, k, v, a, bb, W, sc)  # noqa: E731
    gmask = (a.float()[:, :, :, None] + bb.float()[:, :, None, :]).reshape(N, S, S).to(bf)
    record("fused_global_attention", run(),
           sam_attention.fused_global_attention_plain(q, k, v, a, bb, W, sc),
           {"bias_dropped": sam_attention.fused_global_attention(q, k, v, zero, zero, W, sc),
            "bias_swapped": sam_attention.fused_global_attention(q, k, v, bb, a, W, sc)},
           1e-2, run,
           lambda: sam_attention.fused_global_attention_plain(q, k, v, a, bb, W, sc),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=gmask, scale=sc),
           nbytes(q, k, v, a, bb) + nbytes(q), 4.0 * N * S * S * hds, iters=5)
    del gmask
    torch.cuda.empty_cache()
    return results


def full_config():
    """LLaMA-7B + CLIP ViT-L/14 + SAM ViT-H in bf16 at full width; the
    vocabulary is LLaMA's 32000 + [PAD] + 6 multimodal + 4 stage-2 tokens."""
    import torch

    from ullava_tpu_torch.models import clip_vit, llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import build as sam_build

    core = ullava_core.UllavaCoreConfig(
        llm=llama.LlamaConfig(vocab_size=32011, attn_impl="flash"),
        vision=clip_vit.CLIPVisionConfig(),
        vision_hidden_layer=-2, img_start_id=32001, img_end_id=32002,
    )
    return ullava.UllavaConfig(
        core=core, sam=sam_build.sam_vit_h(torch.bfloat16),
        seg_token_idx=32007, loc_token_idx=32008, max_masks=1,
    )


def requests(cfg, n: int, prompt: int, rng):
    """`n` RES requests: `prompt` token ids with the image span after
    `<img_beg>`, a CLIP image and a SAM image (already normalized)."""
    import numpy as np

    P = cfg.core.vision.num_patches
    out = []
    for _ in range(n):
        ids = rng.integers(5, 1000, size=prompt)
        ids[1] = cfg.core.img_start_id
        ids[2:2 + P] = 3
        ids[2 + P] = cfg.core.img_end_id
        out.append(dict(
            input_ids=ids,
            image=rng.standard_normal((224, 224, 3)).astype(np.float32),
            image_sam=rng.standard_normal((1024, 1024, 3)).astype(np.float32),
        ))
    return out


def serve_phase(gen) -> dict:
    """The main path: B full-width RES requests through `serve.serve`.
    Returns the serve line, which holds the launch count of every kernel
    during the first call, and the profile line."""
    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models import generate, llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import build as sam_build
    from ullava_tpu_torch.serve import collate, serve

    cfg = full_config()
    t0 = time.perf_counter()
    params = ullava.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = requests(cfg, B, PROMPT, np.random.default_rng(0))
    gc = generate.GenerateConfig(max_new_tokens=NEW_TOKENS)
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve((cfg, params), reqs, "cuda", gc)
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()

    seqs, masks, boxes = out["sequences"], out["low_res_masks"], out["pred_boxes"]
    if len(seqs) != B or any(not PROMPT < len(s) <= PROMPT + NEW_TOKENS for s in seqs):
        raise AssertionError(f"bad sequence lengths {[len(s) for s in seqs]}")
    if any(not 0 <= t < cfg.core.llm.vocab_size for s in seqs for t in s):
        raise AssertionError("token id out of the vocabulary")
    for s, r in zip(seqs, reqs):
        if s[:PROMPT] != r["input_ids"].tolist():
            raise AssertionError("the prompt is not the prefix of its sequence")
    if tuple(masks.shape) != (B, 1, 256, 256) or tuple(boxes.shape) != (B, 3, 4):
        raise AssertionError(f"bad shapes {tuple(masks.shape)} {tuple(boxes.shape)}")
    if not (torch.isfinite(masks).all() and torch.isfinite(boxes).all()):
        raise AssertionError("non-finite masks or boxes")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # Steady-state serve, then each phase alone (host clock, synchronized).
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    serve_runs = [timed(lambda: serve((cfg, params), reqs, "cuda", gc))[1] for _ in range(3)]
    serve_s = sorted(serve_runs)[1]
    batch = collate(reqs, "cuda")
    core = params["core"]
    with torch.no_grad():
        _, gen_s = timed(lambda: generate.generate(
            core, cfg.core, gc, input_ids=batch["input_ids"],
            prompt_lens=batch["prompt_lens"], images=batch["images"]))
        embeds, embed_s = timed(lambda: ullava_core.embed_multimodal(
            core, cfg.core, batch["input_ids"], batch["images"]))
        cache = llama.init_kv_cache(cfg.core.llm, B, PROMPT + NEW_TOKENS, device="cuda")
        _, prefill_s = timed(lambda: llama.forward(
            core["llm"], cfg.core.llm, inputs_embeds=embeds, kv_lens=batch["prompt_lens"],
            kv_cache=cache, compute_logits=False))
        emb, sam_s = timed(lambda: ullava.get_visual_embs(params, cfg, batch["images_sam"]))
        seg = torch.zeros((B, 1, 256), device="cuda")
        _, dec_s = timed(lambda: sam_build.forward_masks(params["sam"], cfg.sam, emb, seg))
    profile_line = profile_serve(lambda: timed(lambda: serve((cfg, params), reqs, "cuda", gc)))
    line = {
        "phase": "serve", "batch": B, "prompt_tokens": PROMPT, "new_tokens": NEW_TOKENS,
        "init_s": init_s, "first_serve_s": first_s, "serve_s": serve_s,
        "serve_runs_s": serve_runs,
        "images_per_s": B / serve_s, "clip_embed_s": embed_s, "prefill_s": prefill_s,
        "decode_s": gen_s - embed_s - prefill_s, "sam_encode_s": sam_s,
        "mask_decode_s": dec_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "generated": [len(s) - PROMPT for s in seqs], "launches": launches,
    }
    print(json.dumps(line), flush=True)
    print(json.dumps(profile_line), flush=True)
    del params, cache, emb, embeds, batch, out
    torch.cuda.empty_cache()
    return line, profile_line


def profile_serve(run) -> dict:
    """One serve under torch.profiler: device kernel time by name and the
    device's busy share of the wall time (the profiler's own overhead
    lengthens the wall time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = run()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # Device-side entries only (kernels, copies): an aten op's entry
    # repeats the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", "")) and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    return {
        "phase": "profile", "wall_s": wall_s,
        "device_busy_s": busy_s if events else "not measured",
        "device_idle_share": 1 - busy_s / wall_s if events else "not measured",
        "top_device_ms": {e.key[:80]: dev_us(e) / 1e3 for e in top},
        "top_device_calls": {e.key[:80]: e.count for e in top},
    }


def check_phase(gen) -> None:
    """A small model through the kernels on the card against the plain
    versions on the CPU in fp32, from the same bf16 weights: LLaMA prefill
    (rotary + flash), the SAM encoder at W 14 / global 64 (window + global
    kernels), and the masks decoded from both embeddings."""
    import numpy as np
    import torch

    from ullava_tpu_torch.models import llama
    from ullava_tpu_torch.models.sam import build as sam_build
    from ullava_tpu_torch.models.sam import image_encoder

    def to_cpu32(tree):
        if isinstance(tree, dict):
            return {k: to_cpu32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu32(v) for v in tree]
        return tree.detach().float().cpu()

    def rel_err(got, ref):
        return ((got.float().cpu() - ref).abs().max() / ref.abs().max()).item()

    rng = np.random.default_rng(1)
    errs = {}
    lcfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_layers=2, num_heads=2, num_kv_heads=2)
    lp = llama.init_params(lcfg, gen, "cuda")
    ids = torch.as_tensor(rng.integers(0, 512, size=(2, 200)))
    lens = torch.tensor([200, 131], dtype=torch.int32)
    c32 = dataclasses.replace(lcfg, dtype=torch.float32)
    with torch.no_grad():
        got = llama.forward(lp, lcfg, input_ids=ids.cuda(), kv_lens=lens.cuda(),
                            kv_cache=llama.init_kv_cache(lcfg, 2, 200, device="cuda"))
        ref = llama.forward(to_cpu32(lp), c32, input_ids=ids, kv_lens=lens,
                            kv_cache=llama.init_kv_cache(c32, 2, 200, device="cpu"))
    errs["llama_prefill_hidden"] = max(
        rel_err(got["hidden_states"][b, :n], ref["hidden_states"][b, :n])
        for b, n in enumerate(lens.tolist()))

    scfg = sam_build.SamConfig(vision=image_encoder.SamVisionConfig(
        embed_dim=160, depth=2, num_heads=2, global_attn_indexes=(1,), out_chans=256))
    sp = sam_build.init_sam_params(scfg, gen, "cuda")
    for blk in sp["image_encoder"]["window_blocks"] + sp["image_encoder"]["global_blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk[key].normal_(0, 0.5, generator=gen)
    s32 = dataclasses.replace(scfg, vision=dataclasses.replace(scfg.vision, dtype=torch.float32))
    img = torch.as_tensor(rng.standard_normal((1, 1024, 1024, 3)).astype(np.float32))
    text = torch.as_tensor(rng.standard_normal((1, 1, 256)).astype(np.float32))
    with torch.no_grad():
        emb = image_encoder.encode(sp["image_encoder"], scfg.vision, img.cuda())
        sp32 = to_cpu32(sp)
        emb_ref = image_encoder.encode(sp32["image_encoder"], s32.vision, img)
        masks, _ = sam_build.forward_masks(sp, scfg, emb, text.cuda())
        masks_ref, _ = sam_build.forward_masks(sp32, s32, emb_ref, text)
    errs["sam_image_embeddings"] = rel_err(emb, emb_ref)
    errs["sam_low_res_masks"] = rel_err(masks, masks_ref)
    tol = 5e-2  # bf16 weights/activations on the card against fp32 on the CPU
    print(json.dumps({"phase": "check", "rel_err": errs, "tol": tol}), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference: {bad}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
        return 2
    from ullava_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = kernels.build_all(verbose=True)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "sources": sorted(built)}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = kernel_phases(gen)
    serve_line, profile_line = serve_phase(gen)
    for name, n in serve_line["launches"].items():
        results[name]["launches"] = n
    for r in results.values():
        print(json.dumps({"phase": "kernel", "name": r["name"], "max_abs_err": r["max_abs_err"],
                          "row_rel_err": r["row_rel_err"], "tol": r["tol"],
                          "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"], "launches": r["launches"]}), flush=True)
    check_phase(gen)
    # The serve and profile numbers again, short, next to the result.
    serve_line.pop("launches")
    top = sorted(profile_line["top_device_ms"].items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({**serve_line, "phase": "serve_summary",
                      "device_busy_s": profile_line["device_busy_s"],
                      "profiled_wall_s": profile_line["wall_s"],
                      "top_device_ms_calls": [[name[:60], ms, profile_line["top_device_calls"][name]]
                                              for name, ms in top]}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
