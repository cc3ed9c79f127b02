#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`ullava_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on any error:
  1. build   - compiles every CUDA kernel of the port from `kernels/csrc`
               (one nvcc per source, in parallel) and prints the build time;
  2. kernels - runs each kernel and its plain PyTorch version on the same
               inputs at the serving shapes (the bf16 path's four at B=4,
               the int8 LLM path's five and the int8 SAM encoder's three
               at B=16), holds the kernel to the
               plain version within a stated tolerance, and times the
               kernel, the plain version and, where one exists, a single
               PyTorch library call computing the same function (L2
               flushed before each timed call); a mutated run of each
               kernel must fail the same gate;
  3. serve   - builds the full-width bf16 RES model (LLaMA-7B, CLIP
               ViT-L/14, SAM ViT-H) from a seeded generator on the card,
               serves B=4 requests (320-token prompts: 256 image tokens + 64
               text, 32 greedy new tokens, one mask each) through
               `serve.serve`, checks shapes, finiteness and that the bf16
               path's kernels were launched exactly as often as its layers
               and steps say, then times three more serves
               (median), each phase alone, and one serve under the
               profiler;
  4. int8_serve - quantizes the same model's LLM to int8 (`quantize_llm`)
               and serves B=16 such requests with W8A8 prefill, the fused
               norm + quantize and the int8 KV cache, with the same checks
               and timings; every kernel of the int8 LLM path must be
               launched exactly as often as its layers and steps say;
  5. sam_int8_serve - quantizes the SAM image encoder and CLIP as well
               (`quantize_towers`) and serves B=16 requests with the int8
               SAM encoder in the block window layout (`mlp_w8a8`): every
               block's MLP through the fused int8 MLP kernel, the global
               blocks through fused LN+qkv, lane-sliced global attention
               and fused proj+residual; same checks and timings, every
               kernel launched exactly as often as its layers say;
  6. check   - runs small models (bf16, then int8 LLM, then an int8 SAM
               encoder) on the card and on the CPU (plain versions, fp32)
               from the same weights and holds the card's outputs to the
               CPU reference;
  7. summary - prints the serve numbers again, the card's name and power
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
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores

B = 4  # requests per batch of the bf16 serve
B_INT8 = 16  # requests per batch of the int8 serve
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


def bound_ms(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_line(name, max_abs_err, gate, kern, plain, library, in_out, flops, iters=20,
                flops_per_s=BF16_FLOPS_PER_S) -> dict:
    """Time a checked kernel, its plain version and its library call, and
    put the numbers beside its bound and what its gate measured."""
    from ullava_tpu_torch import kernels

    b_ms, b_by = bound_ms(in_out, flops, flops_per_s)
    spec = kernels.KERNELS[name]
    line = {
        "name": name,
        "route": "cuda",
        "source": f"ullava_tpu_torch/kernels/csrc/{spec.source}",
        "replaces": spec.replaces,
        "max_abs_err": max_abs_err,
        **gate,
        "ms": time_ms(kern, iters),
        "plain_ms": time_ms(plain, max(3, iters // 4), warmup=1),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None if library is None else time_ms(library, iters),
    }
    log(f"[kernel] {json.dumps(line)}")
    return line


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
        results[name] = kernel_line(
            name, (got.float() - ref.float()).abs().max().item(),
            {"row_rel_err": err, "tol": tol, "mutant_row_rel_err": caught},
            kern, plain, library, in_out, flops, iters)

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
    # K4's serving form (bf16 exponentials), which a global block outside
    # the lane-sliced route takes under `mlp_w8a8`: its rounding depends on
    # the running maximum, so on the key tiling, hence the 2e-2.
    run16 = lambda a_=a, b_=bb: sam_attention.fused_global_attention(  # noqa: E731
        q, k, v, a_, b_, W, sc, exp_bf16=True)
    ref16 = sam_attention.fused_global_attention_plain(q, k, v, a, bb, W, sc, exp_bf16=True)
    err16, bad16 = row_rel_err(run16(), ref16), row_rel_err(run16(bb, a), ref16)
    if not err16 <= 2e-2 or not bad16 > 2e-2:
        raise AssertionError(f"fused_global_attention exp_bf16: {err16}, bias swapped {bad16}")
    results["fused_global_attention"]["exp_bf16_form"] = {
        "row_rel_err": err16, "tol": 2e-2, "mutant_row_rel_err": {"bias_swapped": bad16},
        "ms": time_ms(run16, 5)}
    torch.cuda.empty_cache()
    return results


def int8_gate(got, ref):
    """(passes, share of int8 values that agree exactly, largest
    difference): at least 99.9% exact and the rest within 1."""
    diff = (got.int() - ref.int()).abs()
    exact, worst = (diff == 0).float().mean().item(), int(diff.max())
    return worst <= 1 and exact >= 0.999, exact, worst


def max_rel_err(got, ref) -> float:
    return ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()


def must(name, ok, info):
    if not ok:
        raise AssertionError(f"{name}: gate failed: {info}")


def must_not(name, mutant, ok, info):
    if ok:
        raise AssertionError(f"{name}: the gate does not catch {mutant}: {info}")
    return info


def int8_kernel_phases(gen) -> dict:
    """The five kernels of the int8 LLM path against their plain versions
    at the shapes of a B=16 serve (5120 prefill rows; a [32, 16, 352,
    4096] int8 cache).

    Gates: int8 outputs at least 99.9% exact and the rest within 1 (a
    value within fp32 summation-order noise of .5 may round the other
    way); abs-max and scales within rtol 1e-6; the residual stream `h`
    bit-exact; bf16 outputs by `row_rel_err` within 1e-2 (the decode
    kernel's two limits are stated where it is checked); for the two
    cache kernels every byte outside the rows they write unchanged. Each
    gate must reject a mutated run that stands for a typical bug."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch.ops import decode_attention, mlp_kernel, norms

    dev = "cuda"
    bf = torch.bfloat16
    tol = 1e-2
    rows, D, Fw = B_INT8 * PROMPT, 4096, 11008
    results = {}

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K5: residual add + RMSNorm + per-row int8 quantize of one norm site.
    x, res = randn(rows, D), randn(rows, D)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf)
    h_ref, q_ref, a_ref = norms.rms_norm_residual_quant_plain(x, res, w, 1e-6)

    def judge_rows(out, q_ref, a_ref, h_ref=None):
        h, q, a = out
        ok, exact, worst = int8_gate(q, q_ref)
        a_err = max_rel_err(a, a_ref)
        info = {"int8_exact_share": exact, "int8_max_diff": worst, "amax_rel_err": a_err}
        if h_ref is not None:
            info["h_exact"] = torch.equal(h, h_ref)
            ok = ok and info["h_exact"]
        return ok and a_err <= 1e-6, info

    ok, info = judge_rows(norms.rms_norm_residual_quant(x, res, w, 1e-6), q_ref, a_ref, h_ref)
    must("rms_norm_residual_quant", ok, info)
    _, q0_ref, a0_ref = norms.rms_norm_residual_quant_plain(x, None, w, 1e-6)
    ok0, info0 = judge_rows((None,) + norms.rms_norm_quant(x, w, 1e-6), q0_ref, a0_ref)
    must("rms_norm_quant", ok0, info0)
    bad = judge_rows(norms.rms_norm_residual_quant(x, torch.zeros_like(res), w, 1e-6), q_ref, a_ref, h_ref)
    info["no_residual_form"] = info0
    info["mutants"] = {"residual_dropped": must_not("rms_norm_residual_quant", "residual_dropped", *bad)}
    results["rms_norm_residual_quant"] = kernel_line(
        "rms_norm_residual_quant", float(info["int8_max_diff"]), info,
        lambda: norms.rms_norm_residual_quant(x, res, w, 1e-6),
        lambda: norms.rms_norm_residual_quant_plain(x, res, w, 1e-6), None,
        nbytes(x, res, w, h_ref, q_ref, a_ref), 10.0 * x.numel(), flops_per_s=FP32_FLOPS_PER_S)

    # K9: the RMSNorm forward at the 5120 rows of a prefill's norms, and
    # at the 16 rows of a decode step's (checked and timed the same way).
    x9, x9d = randn(rows, D, scale=2.0), randn(B_INT8, 1, D, scale=2.0)
    y_ref, yd_ref = norms.rms_norm_plain(x9, w, 1e-6), norms.rms_norm_plain(x9d, w, 1e-6)
    y = norms.rms_norm(x9, w, 1e-6)
    err, err_d = row_rel_err(y, y_ref), row_rel_err(norms.rms_norm(x9d, w, 1e-6), yd_ref)
    must("rms_norm_fwd", err <= tol and err_d <= tol, (err, err_d))
    bad = row_rel_err(norms.rms_norm(x9, torch.ones_like(w), 1e-6), y_ref)
    bad_d = row_rel_err(norms.rms_norm(x9d, torch.ones_like(w), 1e-6), yd_ref)
    must_not("rms_norm_fwd", "weight_dropped", bad <= tol or bad_d <= tol, (bad, bad_d))
    decode_rows = {
        "rows": B_INT8, "row_rel_err": err_d, "mutant_row_rel_err": {"weight_dropped": bad_d},
        "ms": time_ms(lambda: norms.rms_norm(x9d, w, 1e-6), 20),
        "plain_ms": time_ms(lambda: norms.rms_norm_plain(x9d, w, 1e-6), 20),
        "library_ms": time_ms(lambda: F.rms_norm(x9d, (D,), w, 1e-6), 20),
        "bound_ms": bound_ms(nbytes(x9d, w, yd_ref), 6.0 * x9d.numel(), FP32_FLOPS_PER_S)[0],
    }
    results["rms_norm_fwd"] = kernel_line(
        "rms_norm_fwd", (y.float() - y_ref.float()).abs().max().item(),
        {"row_rel_err": err, "tol": tol, "mutant_row_rel_err": {"weight_dropped": bad},
         "decode_rows": decode_rows},
        lambda: norms.rms_norm(x9, w, 1e-6), lambda: norms.rms_norm_plain(x9, w, 1e-6),
        lambda: F.rms_norm(x9, (D,), w, 1e-6),
        nbytes(x9, w, y), 6.0 * x9.numel(), flops_per_s=FP32_FLOPS_PER_S)
    del x, res, h_ref, q_ref, a_ref, q0_ref, a0_ref, x9, y, y_ref

    # K6: silu(gate) * up + per-row int8 quantize of one layer's MLP.
    g, u = randn(rows, Fw, scale=2.0), randn(rows, Fw)
    q_ref, a_ref = mlp_kernel.silu_mul_quant_plain(g, u)
    ok, info = judge_rows((None,) + mlp_kernel.silu_mul_quant(g, u), q_ref, a_ref)
    must("silu_mul_quant", ok, info)
    bad = judge_rows((None,) + mlp_kernel.silu_mul_quant(g, torch.ones_like(u)), q_ref, a_ref)
    info["mutants"] = {"up_dropped": must_not("silu_mul_quant", "up_dropped", *bad)}
    results["silu_mul_quant"] = kernel_line(
        "silu_mul_quant", float(info["int8_max_diff"]), info,
        lambda: mlp_kernel.silu_mul_quant(g, u), lambda: mlp_kernel.silu_mul_quant_plain(g, u),
        None, nbytes(g, u, q_ref, a_ref), 8.0 * g.numel(), flops_per_s=FP32_FLOPS_PER_S)
    del g, u, q_ref, a_ref

    # K7: quantize one layer's prefill K/V into the stacked cache. The
    # cache starts as noise, so a byte written out of place shows.
    L, H, hd, maxS, layer = 32, 32, 128, PROMPT + NEW_TOKENS, 17
    cache = [torch.randint(-127, 128, (L, B_INT8, maxS, H * hd), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    cache += [torch.rand((L, B_INT8, maxS, H), generator=gen, device=dev) * 0.02 + 1e-3
              for _ in range(2)]
    k, v = randn(B_INT8, PROMPT, H, hd), randn(B_INT8, PROMPT, H, hd, scale=3.0)
    expect = decode_attention.prefill_quantize_write_plain(
        k, v, *(c.clone() for c in cache), layer)

    def judge_cache(got):
        info, ok = {}, True
        for name, g_, e_ in zip(("k", "v", "k_scale", "v_scale"), got, expect):
            new_g, new_e = g_[layer, :, :PROMPT], e_[layer, :, :PROMPT]
            if g_.dtype == torch.int8:
                good, exact, worst = int8_gate(new_g, new_e)
                info[name] = {"int8_exact_share": exact, "int8_max_diff": worst}
            else:
                rel = max_rel_err(new_g, new_e)
                good = rel <= 1e-6
                info[name] = {"scale_rel_err": rel}
            rest = g_.clone()
            rest[layer, :, :PROMPT] = new_e
            info[name]["rest_untouched"] = torch.equal(rest, e_)
            ok = ok and good and info[name]["rest_untouched"]
        return ok, info

    ok, info = judge_cache(decode_attention.prefill_quantize_write(k, v, *cache, layer))
    must("prefill_quantize_write", ok, info)
    # Mutant: one scale per row in place of one per (row, head).
    qrow, srow = decode_attention.quantize_kv_rows(k.reshape(B_INT8, PROMPT, 1, H * hd))
    mutant = [expect[0].clone(), expect[1], expect[2].clone(), expect[3]]
    mutant[0][layer, :, :PROMPT] = qrow.reshape(B_INT8, PROMPT, H * hd)
    mutant[2][layer, :, :PROMPT] = srow.expand(B_INT8, PROMPT, H)
    info["mutants"] = {"one_scale_per_row": must_not(
        "prefill_quantize_write", "one_scale_per_row", *judge_cache(mutant))["k"]}
    del mutant, qrow, srow
    results["prefill_quantize_write"] = kernel_line(
        "prefill_quantize_write", float(max(info["k"]["int8_max_diff"], info["v"]["int8_max_diff"])),
        info, lambda: decode_attention.prefill_quantize_write(k, v, *cache, layer),
        lambda: decode_attention.prefill_quantize_write_plain(k, v, *cache, layer), None,
        nbytes(k, v) + k.numel() * 2 + 2 * 4 * B_INT8 * PROMPT * H, 6.0 * k.numel(),
        flops_per_s=FP32_FLOPS_PER_S)

    # K8: one decode step of that layer over the cache K7 filled, ragged
    # write positions past the prompt. Rows at and after write_pos hold
    # noise that the kernel must not attend to.
    q = randn(B_INT8, 1, H, hd)
    kq, ks = decode_attention.quantize_kv_rows(randn(B_INT8, H, hd).float() + 0.25 * q[:, 0].float())
    vq, vs = decode_attention.quantize_kv_rows(randn(B_INT8, H, hd, scale=3.0))
    kq, vq = kq.reshape(B_INT8, H * hd), vq.reshape(B_INT8, H * hd)
    wp = PROMPT + (torch.arange(B_INT8, device=dev) * 5) % NEW_TOKENS
    sc = hd**-0.5
    expect = decode_attention.decode_attention_int8_fused_write_plain(
        q, kq, ks, vq, vs, *(c.clone() for c in cache), wp, layer, scale=sc)
    run = lambda: decode_attention.decode_attention_int8_fused_write(  # noqa: E731
        q, kq, ks, vq, vs, *cache, wp, layer, scale=sc)
    got = run()
    torch.cuda.synchronize()
    # Two gates, both of which must hold. The kernel keeps its
    # probabilities, their value scales and the dequantized rows in fp32;
    # the plain version in bf16 (what a CPU tensor takes) rounds each of
    # them to bf16, which moves an output by up to two bf16 ulps: the
    # kernel is held to it within two ulps of a row's largest value,
    # 2^-6. Fed the same q as fp32 and rounded to bf16 once, as the
    # kernel's result is, the plain version and a correct kernel round two
    # nearly equal fp32 values, which can land one ulp apart and no more:
    # 2^-7.
    tol_bf16, tol_f32 = 2.0**-6, 2.0**-7
    ref = decode_attention.decode_attention_int8_fused_write_plain(
        q.float(), kq, ks, vq, vs, *expect[1:], wp, layer, scale=sc)[0].to(bf)
    err, err_bf16 = row_rel_err(got[0], ref), row_rel_err(got[0], expect[0])
    untouched = all(torch.equal(g_, e_) for g_, e_ in zip(got[1:], expect[1:]))
    info = {"row_rel_err": err, "tol": tol_f32, "row_rel_err_to_bf16_plain": err_bf16,
            "tol_to_bf16_plain": tol_bf16, "cache_equals_scatter": untouched}
    must("decode_attention_int8_fused_write",
         err <= tol_f32 and err_bf16 <= tol_bf16 and untouched, info)
    hist = float(wp.sum())
    step_bytes = (hist * (2 * H * hd + 2 * 4 * H) + 2 * nbytes(q) + 2 * nbytes(kq, ks, vq, vs)
                  + nbytes(wp.int()))
    results["decode_attention_int8_fused_write"] = kernel_line(
        "decode_attention_int8_fused_write", (got[0].float() - ref.float()).abs().max().item(),
        info, run,
        lambda: decode_attention.decode_attention_int8_fused_write_plain(
            q, kq, ks, vq, vs, *cache, wp, layer, scale=sc),
        None, step_bytes, 4.0 * hist * H * hd, flops_per_s=FP32_FLOPS_PER_S)
    # Mutants, run through the kernel on the same (now disposable) cache.
    # New row left out of the softmax: write_pos - 1 with the cached row
    # write_pos - 1 as "new" row attends rows [0, write_pos) only.
    b_idx = torch.arange(B_INT8, device=dev)
    prev = [c[layer, b_idx, wp - 1] for c in cache]
    left_out = decode_attention.decode_attention_int8_fused_write(
        q, prev[0], prev[2], prev[1], prev[3], *cache, wp - 1, layer, scale=sc)[0]
    # Staleness mask off: write_pos at the cache's last row attends the
    # noise rows between the true position and the end as well.
    unmasked = decode_attention.decode_attention_int8_fused_write(
        q, kq, ks, vq, vs, *cache, torch.full_like(wp, maxS - 1), layer, scale=sc)[0]
    # Each mutant must fail both gates (tol_bf16 is the looser one).
    caught = {"new_row_left_out": min(row_rel_err(left_out, ref), row_rel_err(left_out, expect[0])),
              "staleness_mask_off": min(row_rel_err(unmasked, ref), row_rel_err(unmasked, expect[0]))}
    for m, e in caught.items():
        must_not("decode_attention_int8_fused_write", m, e <= tol_bf16, e)
    results["decode_attention_int8_fused_write"]["mutant_row_rel_err"] = caught
    log(f"[kernel] decode_attention_int8_fused_write mutants {json.dumps(caught)}")
    del cache, expect, got, ref
    torch.cuda.empty_cache()
    return results


def sam_int8_kernel_phases(gen) -> dict:
    """The three kernels of the int8 SAM encoder path against their plain
    versions at the shapes of one B=16 ViT-H encode: 65536 token rows, C
    1280, F 5120, 256 (image, head) pairs over 4096 keys.

    Gates: bf16 outputs by `row_rel_err` within 1e-2 (one bf16 ulp of a
    row's largest value, plus what a flipped int8 step moves); the
    attention with bf16 exponentials within 2e-2, because its rounding
    depends on the running maximum and so on the key tiling; int8
    intermediates (the LN'd rows, the re-quantized GELU output) at least
    99.9% exact and the rest within 1, their scales within rtol 1e-3 (a
    chunk's abs-max comes through the polynomial GELU of an fp32 product).
    Each gate must reject mutated runs that stand for typical bugs."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch.ops import mlp_kernel, quant, sam_attention

    dev, bf = "cuda", torch.bfloat16
    tol = 1e-2
    T, C, Fw, H, hd, W = B_INT8 * 4096, 1280, 5120, 16, 80, 64
    eps = 1e-6
    results = {}

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(bf)

    def weight(K, N, col_gain=None):
        w = torch.randn((K, N), generator=gen, device=dev) * 0.05
        if col_gain is not None:
            w = w * col_gain
        leaf = quant.quantize_int8(w)
        return leaf["q"], leaf["scale"]

    def stage_ms(run, bits, iters=10):
        return {name: time_ms(lambda b=b: run(b), iters) for name, b in bits.items()}

    # The shared int8 GEMM core at shapes that are no multiple of its
    # 128 x 128 x 64 tile (ragged rows, columns and depth), through
    # `fused_linear`, against an integer product spelled out on the CPU.
    # Without a LayerNorm the int8 rows must be bit-equal.
    odd = {}
    for rows, K, N in ((200, 96, 72), (129, 1280, 136), (1, 16, 8)):
        xo, (wq, ws), bias = randn(rows, K), weight(K, N), randn(N)
        got, xq, xs = mlp_kernel._ln_linear_cuda(xo, None, None, wq, ws, bias, 0.0, None)
        xq_ref, xs_ref = mlp_kernel._row_quant(xo)
        acc = (xq_ref.cpu().int() @ wq.cpu().int()).to(dev).float()
        ref = (acc * (xs_ref * ws) + bias.float()).to(bf)
        err = row_rel_err(got, ref)
        must(f"int8 GEMM core at {rows}x{K}x{N}", torch.equal(xq, xq_ref) and err <= tol, err)
        odd[f"{rows}x{K}x{N}"] = err
    log(f"[kernel] int8_gemm_core odd shapes row_rel_err {json.dumps(odd)}")

    x = randn(T, C, scale=2.0, shift=0.3)
    g, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)

    # K10, both forms: LN1 + qkv, and proj + residual.
    forms = {}
    for form, N, ln in (("ln_qkv", 3 * C, True), ("proj_residual", C, False)):
        wq, ws = weight(C, N)
        bias = randn(N, scale=0.5)
        res = None if ln else randn(T, N)
        lg, lb = (g, b) if ln else (None, None)
        args = (x, lg, lb, wq, ws, bias, eps)
        ref, xq_ref, xs_ref = mlp_kernel._ln_linear_parts_plain(*args, True, res)
        got, xq, xs = mlp_kernel._ln_linear_cuda(*args, res)
        torch.cuda.synchronize()
        ok, exact, worst = int8_gate(xq, xq_ref)
        err, s_err = row_rel_err(got, ref), max_rel_err(xs, xs_ref)
        info = {"row_rel_err": err, "tol": tol, "int8_exact_share": exact, "int8_max_diff": worst,
                "scale_rel_err": s_err}
        must(f"fused_ln_linear {form}", ok and err <= tol and s_err <= 1e-5, info)
        mutants = {"per_tensor_scale": mlp_kernel._ln_linear_cuda(
            x, lg, lb, wq, ws.mean().expand_as(ws).contiguous(), bias, eps, res)[0]}
        if ln:
            mutants["ln_bias_dropped"] = mlp_kernel._ln_linear_cuda(
                x, lg, torch.zeros_like(lb), wq, ws, bias, eps, res)[0]
        else:
            mutants["residual_dropped"] = mlp_kernel._ln_linear_cuda(*args, None)[0]
        info["mutant_row_rel_err"] = {
            m: must_not(f"fused_ln_linear {form}", m, row_rel_err(out, ref) <= tol,
                        row_rel_err(out, ref)) for m, out in mutants.items()}
        del mutants

        def library(x=x, lg=lg, lb=lb, wq=wq, ws=ws, bias=bias, res=res):
            xf = (F.layer_norm(x, (C,), lg, lb, eps) if lg is not None else x).float()
            amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
            xq_ = torch.round(xf * (127.0 / amax)).to(torch.int8)
            y = torch._int_mm(xq_, wq).float() * (amax * (1.0 / 127.0) * ws) + bias.float()
            return (y if res is None else y + res.float()).to(bf)

        in_out = nbytes(x, wq, ws, bias, got) + (nbytes(g, b) if ln else nbytes(res))
        line = kernel_line(
            "fused_ln_linear", (got.float() - ref.float()).abs().max().item(), info,
            lambda a=args, r=res: mlp_kernel._ln_linear_cuda(*a, r),
            lambda a=args, r=res: mlp_kernel._ln_linear_parts_plain(*a, True, r),
            library, in_out, 2.0 * T * C * N, iters=10, flops_per_s=INT8_OPS_PER_S)
        line["stage_ms"] = stage_ms(
            lambda bits, a=args, r=res, sc=(xq, xs): mlp_kernel._ln_linear_cuda(
                *a, r, stages=bits, scratch=sc), {"row_pass": 1, "gemm": 2})
        forms[form] = line
        del ref, got, xq, xs, xq_ref, xs_ref, res
    # The kernels line carries the LN+qkv form; the proj form rides in it.
    results["fused_ln_linear"] = {**forms["ln_qkv"], "shape": [T, C, 3 * C],
                                  "gemm_core_odd_shapes_row_rel_err": odd, "proj_residual_form": {
        k: v for k, v in forms["proj_residual"].items()
        if k not in ("name", "route", "source", "replaces")}}
    log(f"[kernel] fused_ln_linear stages {json.dumps({k: v['stage_ms'] for k, v in forms.items()})}")

    # K12: one block's MLP. The columns of fc1 grow by chunk, so the five
    # 1024-wide chunks of a row have abs-maxima that differ severalfold.
    gain = (1 + torch.arange(Fw, device=dev) // 1024).float()
    w1, s1 = weight(C, Fw, col_gain=gain)
    w2, s2 = weight(Fw, C)
    b1, b2 = randn(Fw, scale=0.5), randn(C, scale=0.5)
    args = (x, g, b, w1, s1, b1, w2, s2, b2, eps)
    ref, xq_ref, xs_ref, hq_ref, hs_ref = mlp_kernel._mlp_block_parts_plain(*args, 1024, True)
    got, xq, xs, hq, hs = mlp_kernel._mlp_block_cuda(*args, 1024)
    torch.cuda.synchronize()

    def judge_mlp(out, hq_, hs_):
        ok_h, exact_h, worst_h = int8_gate(hq_, hq_ref)
        err, hs_err = row_rel_err(out, ref), max_rel_err(hs_, hs_ref)
        info = {"row_rel_err": err, "tol": tol, "h_int8_exact_share": exact_h,
                "h_int8_max_diff": worst_h, "h_scale_rel_err": hs_err}
        return ok_h and err <= tol and hs_err <= 1e-3, info

    ok, info = judge_mlp(got, hq, hs)
    ok_x, exact_x, worst_x = int8_gate(xq, xq_ref)
    info.update({"x_int8_exact_share": exact_x, "x_int8_max_diff": worst_x,
                 "chunk_amax_spread": (hs_ref.amax(1) / hs_ref.amin(1)).median().item()})
    must("fused_mlp_block", ok and ok_x, info)
    # Mutants. One scale per whole row in place of one per chunk (through
    # the plain version: the kernel cannot be told to), and fc1's bias
    # dropped (through the kernel).
    one = mlp_kernel._mlp_block_parts_plain(*args, Fw, True)
    nob = mlp_kernel._mlp_block_cuda(x, g, b, w1, s1, torch.zeros_like(b1), w2, s2, b2, eps, 1024)
    info["mutants"] = {
        "one_scale_per_row": must_not("fused_mlp_block", "one_scale_per_row", *judge_mlp(
            one[0], one[3], one[4].expand(-1, Fw // 1024))),
        "fc1_bias_dropped": must_not("fused_mlp_block", "fc1_bias_dropped",
                                     *judge_mlp(nob[0], nob[3], nob[4])),
    }
    del one, nob

    def library_mlp():
        xf = F.layer_norm(x, (C,), g, b, eps).float()
        amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
        xq_ = torch.round(xf * (127.0 / amax)).to(torch.int8)
        h = F.gelu(torch._int_mm(xq_, w1).float() * (amax * (1.0 / 127.0) * s1) + b1.float())
        h = h.reshape(T, Fw // 1024, 1024)
        hmax = h.abs().amax(-1, keepdim=True).clamp_min(1e-12)
        hq_ = torch.round(h * (127.0 / hmax)).to(torch.int8)
        acc = torch.zeros((T, C), dtype=torch.float32, device=dev)
        for k in range(Fw // 1024):
            acc += torch._int_mm(hq_[:, k].contiguous(), w2[k * 1024:(k + 1) * 1024]).float() * (
                hmax[:, k] * (1.0 / 127.0) * s2)
        return (acc + b2.float() + x.float()).to(bf)

    results["fused_mlp_block"] = kernel_line(
        "fused_mlp_block", (got.float() - ref.float()).abs().max().item(), info,
        lambda: mlp_kernel._mlp_block_cuda(*args, 1024),
        lambda: mlp_kernel._mlp_block_parts_plain(*args, 1024, True), library_mlp,
        nbytes(x, g, b, w1, s1, b1, w2, s2, b2, got), 4.0 * T * C * Fw, iters=10,
        flops_per_s=INT8_OPS_PER_S)
    results["fused_mlp_block"]["stage_ms"] = stage_ms(
        lambda bits: mlp_kernel._mlp_block_cuda(*args, 1024, stages=bits, scratch=(xq, xs, hq, hs)),
        {"row_pass": 1, "fc1": 2, "fc2": 4})
    results["fused_mlp_block"]["shape"] = [T, C, Fw]
    log(f"[kernel] fused_mlp_block stages {json.dumps(results['fused_mlp_block']['stage_ms'])}")
    del ref, got, xq, xs, hq, hs, xq_ref, xs_ref, hq_ref, hs_ref, x, w1, w2
    torch.cuda.empty_cache()

    # K11: one global block's attention, both exponential forms. The bias
    # terms are a few units (std 2), handed over pre-scaled by 1/scale in
    # natural column order, [B, S, H, W].
    S, sc = W * W, hd**-0.5
    y = randn(B_INT8, S, 3 * H * hd)
    a = randn(B_INT8, S, H, W, scale=2.0 / sc)
    bb = randn(B_INT8, S, H, W, scale=2.0 / sc)
    zero = torch.zeros_like(a)
    kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc)
    att = {}
    for exp_bf16 in (True, False):
        lim = 2e-2 if exp_bf16 else tol
        name = "exp_bf16" if exp_bf16 else "exp_fp32"
        run = lambda e=exp_bf16: sam_attention.fused_global_attention_y(y, a, bb, **kw, exp_bf16=e)  # noqa: E731
        got = run()
        ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw, exp_bf16=exp_bf16)
        torch.cuda.synchronize()
        err = row_rel_err(got, ref)
        must(f"fused_global_attention_y {name}", err <= lim, err)
        caught = {
            "bias_dropped": row_rel_err(sam_attention.fused_global_attention_y(
                y, zero, zero, **kw, exp_bf16=exp_bf16), ref),
            "bias_swapped": row_rel_err(sam_attention.fused_global_attention_y(
                y, bb, a, **kw, exp_bf16=exp_bf16), ref),
        }
        for m, e in caught.items():
            must_not(f"fused_global_attention_y {name}", m, e <= lim, e)
        att[name] = {"row_rel_err": err, "tol": lim, "mutant_row_rel_err": caught,
                     "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                     "ms": time_ms(run, 5)}
        del got, ref
    del zero
    # The library yardstick: SDPA on head-major copies with the bias
    # materialised as a [B*H, S, S] bf16 mask (8.6 GB), built per image.
    y5 = y.reshape(B_INT8, S, 3, H, hd).permute(2, 0, 3, 1, 4).contiguous()
    mask = torch.empty((B_INT8, H, S, S), dtype=bf, device=dev)
    for i in range(B_INT8):
        am, bm = a[i].float().permute(1, 0, 2), bb[i].float().permute(1, 0, 2)  # [H, S, W]
        mask[i] = ((am[:, :, :, None] + bm[:, :, None, :]).reshape(H, S, S) * sc).to(bf)
    line = kernel_line(
        "fused_global_attention_y", att["exp_bf16"]["max_abs_err"],
        {k: v for k, v in att["exp_bf16"].items() if k not in ("ms", "max_abs_err")},
        lambda: sam_attention.fused_global_attention_y(y, a, bb, **kw, exp_bf16=True),
        lambda: sam_attention.fused_global_attention_y_plain(y, a, bb, **kw, exp_bf16=True),
        lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=mask, scale=sc),
        nbytes(y, a, bb) + nbytes(y) // 3, 4.0 * B_INT8 * H * S * S * hd, iters=5)
    line["exp_fp32_form"] = att["exp_fp32"]
    line["shape"] = [B_INT8, S, 3 * H * hd]
    results["fused_global_attention_y"] = line
    log(f"[kernel] fused_global_attention_y exp_fp32 {json.dumps(att['exp_fp32'])}")
    del y5, mask, y, a, bb
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


# Launches of one serve: 32 LLM layers (rotary on q and k, one flash
# prefill), 28 window and 4 global SAM blocks, and 65 RMSNorms (two per
# layer and the final one) in the prefill and in each decode step. On the
# int8 path the prefill's 64 layer norms are the fused norm + quantize
# instead, with one gate and one cache write per layer, and each decode
# step runs one write-and-attend per layer.
SAM_LAUNCHES = {"fused_window_attention_grid": 28, "fused_global_attention": 4,
                "fused_ln_linear": 0, "fused_global_attention_y": 0, "fused_mlp_block": 0}
BF16_LAUNCHES = {"fused_rotary": 64, "flash_attention_fwd_bsh": 32, **SAM_LAUNCHES,
                 "rms_norm_fwd": 65 * (1 + NEW_TOKENS),
                 "rms_norm_residual_quant": 0, "silu_mul_quant": 0,
                 "prefill_quantize_write": 0, "decode_attention_int8_fused_write": 0}
INT8_LAUNCHES = {"fused_rotary": 64, "flash_attention_fwd_bsh": 32, **SAM_LAUNCHES,
                 "rms_norm_residual_quant": 64, "silu_mul_quant": 32,
                 "prefill_quantize_write": 32, "rms_norm_fwd": 1 + 65 * NEW_TOKENS,
                 "decode_attention_int8_fused_write": 32 * NEW_TOKENS}
# The int8 SAM encoder in the block layout: the fused MLP in all 32 blocks;
# in each of the 4 global blocks LN1+qkv and proj+residual (one fused
# linear each) around the lane-sliced attention; the window kernel in the
# 28 window blocks; the transpose-staged global kernel never.
SAM_INT8_LAUNCHES = {**INT8_LAUNCHES, "fused_global_attention": 0, "fused_ln_linear": 8,
                     "fused_global_attention_y": 4, "fused_mlp_block": 32}


def serve_phase(phase: str, cfg, params, n_req: int, expect: dict):
    """One main path: `n_req` full-width RES requests through
    `serve.serve`. The launch counts are set to 0 just before the first
    serve and read just after it; every kernel in `expect` must have been
    launched exactly that often. Returns the serve line (which holds those
    counts) and the profile line."""
    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models import generate, llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import build as sam_build
    from ullava_tpu_torch.serve import collate, serve

    reqs = requests(cfg, n_req, PROMPT, np.random.default_rng(0))
    gc = generate.GenerateConfig(max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve((cfg, params), reqs, "cuda", gc)
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()

    seqs, masks, boxes = out["sequences"], out["low_res_masks"], out["pred_boxes"]
    if len(seqs) != n_req or any(not PROMPT < len(s) <= PROMPT + NEW_TOKENS for s in seqs):
        raise AssertionError(f"bad sequence lengths {[len(s) for s in seqs]}")
    if any(not 0 <= t < cfg.core.llm.vocab_size for s in seqs for t in s):
        raise AssertionError("token id out of the vocabulary")
    for s, r in zip(seqs, reqs):
        if s[:PROMPT] != r["input_ids"].tolist():
            raise AssertionError("the prompt is not the prefix of its sequence")
    if tuple(masks.shape) != (n_req, 1, 256, 256) or tuple(boxes.shape) != (n_req, 3, 4):
        raise AssertionError(f"bad shapes {tuple(masks.shape)} {tuple(boxes.shape)}")
    if not (torch.isfinite(masks).all() and torch.isfinite(boxes).all()):
        raise AssertionError("non-finite masks or boxes")
    if out["launches"] != launches:
        raise AssertionError(f"serve reports {out['launches']}, the counters {launches}")
    wrong = {k: (launches[k], n) for k, n in expect.items() if launches[k] != n}
    if wrong or set(expect) != set(launches):
        raise AssertionError(f"{phase}: launches (got, expected) {wrong}")

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
    lens = batch["prompt_lens"]
    tok = torch.full((n_req, 1), 5, device="cuda")
    steps = 4

    with torch.no_grad():
        _, gen_s = timed(lambda: generate.generate(
            core, cfg.core, gc, input_ids=batch["input_ids"],
            prompt_lens=lens, images=batch["images"]))
        embeds, embed_s = timed(lambda: ullava_core.embed_multimodal(
            core, cfg.core, batch["input_ids"], batch["images"]))
        cache = llama.init_kv_cache(cfg.core.llm, n_req, PROMPT + NEW_TOKENS, device="cuda")
        _, prefill_s = timed(lambda: llama.forward(
            core["llm"], cfg.core.llm, inputs_embeds=embeds, kv_lens=lens,
            kv_cache=cache, compute_logits=False))

        def decode_steps():  # a few decode steps on the cache the prefill filled
            for i in range(steps):
                llama.forward(core["llm"], cfg.core.llm, input_ids=tok,
                              positions=(lens + i)[:, None], kv_lens=lens + i + 1,
                              kv_cache=cache, write_pos=(lens + i).long())

        step_profile = profile_serve(lambda: timed(decode_steps))
        _, steps_s = timed(decode_steps)
        emb, sam_s = timed(lambda: ullava.get_visual_embs(params, cfg, batch["images_sam"]))
        seg = torch.zeros((n_req, 1, 256), device="cuda")
        _, dec_s = timed(lambda: sam_build.forward_masks(params["sam"], cfg.sam, emb, seg))
    profile_line = {**profile_serve(lambda: timed(lambda: serve((cfg, params), reqs, "cuda", gc))),
                    "phase": f"{phase}_profile"}
    busy = step_profile["device_busy_s"]
    line = {
        "phase": phase, "batch": n_req, "prompt_tokens": PROMPT, "new_tokens": NEW_TOKENS,
        "first_serve_s": first_s, "serve_s": serve_s, "serve_runs_s": serve_runs,
        "images_per_s": n_req / serve_s, "clip_embed_s": embed_s, "prefill_s": prefill_s,
        "decode_s": gen_s - embed_s - prefill_s, "sam_encode_s": sam_s,
        "mask_decode_s": dec_s,
        "decode_step_wall_ms": steps_s / steps * 1e3,
        "decode_step_device_ms": busy / steps * 1e3 if isinstance(busy, float) else busy,
        "decode_step_top_device_ms": {k: v / steps for k, v in
                                      list(step_profile["top_device_ms"].items())[:6]},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "generated": [len(s) - PROMPT for s in seqs], "launches": launches,
    }
    print(json.dumps(line), flush=True)
    print(json.dumps(profile_line), flush=True)
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
    # Names are cut to 80 characters; kernels that then share a name
    # (elementwise kernels of different functors) are summed.
    ms, calls = {}, {}
    for e in events:
        ms[e.key[:80]] = ms.get(e.key[:80], 0.0) + dev_us(e) / 1e3
        calls[e.key[:80]] = calls.get(e.key[:80], 0) + e.count
    top = sorted(ms, key=ms.get, reverse=True)[:12]
    return {
        "phase": "profile", "wall_s": wall_s,
        "device_busy_s": busy_s if events else "not measured",
        "device_idle_share": 1 - busy_s / wall_s if events else "not measured",
        "top_device_ms": {k: ms[k] for k in top},
        "top_device_calls": {k: calls[k] for k in top},
    }


def check_phase(gen) -> None:
    """Small models through the kernels on the card against the plain
    versions on the CPU in fp32, from the same weights: LLaMA prefill in
    bf16 (rotary + flash) and in int8 with two decode steps (the five
    int8-path kernels), the SAM encoder at W 14 / global 64 (window +
    global kernels), the masks decoded from both embeddings, and an int8
    SAM encoder (the fused int8 linear, MLP and lane-sliced attention
    kernels)."""
    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models import llama
    from ullava_tpu_torch.models.sam import build as sam_build
    from ullava_tpu_torch.models.sam import image_encoder
    from ullava_tpu_torch.ops import quant

    def to_cpu32(tree):
        if isinstance(tree, dict):
            return {k: to_cpu32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu32(v) for v in tree]
        t = tree.detach().cpu()
        return t.float() if t.is_floating_point() else t  # int8 weights stay int8

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

    # The int8 LLM: W8A8 prefill through the fused norm, gate and cache
    # kernels, then two teacher-forced decode steps through the
    # write-and-attend kernel, against fp32 activations on the CPU from
    # the same int8 weights. Sample 1's prompt is shorter than the batch's,
    # so its cache holds stale rows past its length.
    qcfg = dataclasses.replace(lcfg, a8_prefill=True, kv_quant=True)
    q32 = dataclasses.replace(qcfg, dtype=torch.float32)
    qp = quant.quantize_tree(lp, quant.LLAMA_QUANT_KEYS)
    qp32 = to_cpu32(qp)
    toks = torch.as_tensor(rng.integers(0, 512, size=(2, 2, 1)))
    with torch.no_grad():
        cache = llama.init_kv_cache(qcfg, 2, 202, device="cuda")
        cache32 = llama.init_kv_cache(q32, 2, 202, device="cpu")
        got = llama.forward(qp, qcfg, input_ids=ids.cuda(), kv_lens=lens.cuda(), kv_cache=cache)
        ref = llama.forward(qp32, q32, input_ids=ids, kv_lens=lens, kv_cache=cache32)
        errs["int8_llama_prefill_hidden"] = max(
            rel_err(got["hidden_states"][b, :n], ref["hidden_states"][b, :n])
            for b, n in enumerate(lens.tolist()))
        for i in range(2):
            pos = lens + i
            got = llama.forward(qp, qcfg, input_ids=toks[i].cuda(), positions=pos[:, None].cuda(),
                                kv_lens=(pos + 1).cuda(), kv_cache=cache, write_pos=pos.cuda())
            ref = llama.forward(qp32, q32, input_ids=toks[i], positions=pos[:, None],
                                kv_lens=pos + 1, kv_cache=cache32, write_pos=pos)
            errs[f"int8_llama_decode_{i}_logits"] = rel_err(got["logits"], ref["logits"])
    torch.cuda.synchronize()

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
    del sp, sp32, emb, emb_ref

    # The int8 SAM encoder at the widths its kernels are built for (hd 80,
    # W 14, grid 64; 8 heads so that a head slab is 128-aligned; F 2560,
    # so the MLP's chunks are 512 wide): one window and one global block
    # through the fused int8 kernels on the card, against their plain
    # versions in fp32 on the CPU from the same int8 weights.
    v8 = image_encoder.SamVisionConfig(embed_dim=640, depth=2, num_heads=8, global_attn_indexes=(1,),
                                       out_chans=256, mlp_w8a8=True)
    ep = image_encoder.init_params(v8, gen, "cuda")
    for blk in ep["window_blocks"] + ep["global_blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk[key].normal_(0, 0.5, generator=gen)
        for key in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "ln1_bias", "ln2_bias"):
            blk[key].normal_(0, 0.1, generator=gen)
    ep = quant.quantize_tree(ep, quant.SAM_ENCODER_QUANT_KEYS)
    before = kernels.launch_counts()
    with torch.no_grad():
        emb = image_encoder.encode(ep, v8, img.cuda())
        emb_ref = image_encoder.encode(
            to_cpu32(ep), dataclasses.replace(v8, dtype=torch.float32), img)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    if ran != {"fused_window_attention_grid": 1, "fused_ln_linear": 2,
               "fused_global_attention_y": 1, "fused_mlp_block": 2}:
        raise AssertionError(f"the small int8 SAM encoder launched {ran}")
    errs["int8_sam_image_embeddings"] = rel_err(emb, emb_ref)
    # bf16 activations on the card against fp32 on the CPU; on the int8
    # path they also quantize to neighbouring int8 steps here and there.
    tol = 5e-2
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
    bf16_results = kernel_phases(gen)
    int8_results = int8_kernel_phases(gen)
    sam_int8_results = sam_int8_kernel_phases(gen)
    results = {**bf16_results, **int8_results, **sam_int8_results}

    from ullava_tpu_torch.models import ullava

    cfg = full_config()
    t0 = time.perf_counter()
    params = ullava.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve_line, profile_line = serve_phase("serve", cfg, params, B, BF16_LAUNCHES)

    # The int8 LLM of the same model: int8 weights, W8A8 prefill with the
    # fused norm + quantize, int8 KV cache. CLIP and SAM stay bf16.
    t0 = time.perf_counter()
    ullava.quantize_llm(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    llm8 = dataclasses.replace(cfg.core.llm, a8_prefill=True, kv_quant=True, fused_norm_quant=True)
    cfg8 = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, llm=llm8))
    int8_line, int8_profile = serve_phase("int8_serve", cfg8, params, B_INT8, INT8_LAUNCHES)

    # The fully int8 model: the SAM image encoder and CLIP quantized as
    # well, the encoder served with int8 activations in its fused kernels.
    t0 = time.perf_counter()
    ullava.quantize_towers(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quantize_towers_s = time.perf_counter() - t0
    sam8 = dataclasses.replace(cfg8.sam, vision=dataclasses.replace(cfg8.sam.vision, mlp_w8a8=True))
    cfg88 = dataclasses.replace(cfg8, sam=sam8)
    sam_int8_line, sam_int8_profile = serve_phase(
        "sam_int8_serve", cfg88, params, B_INT8, SAM_INT8_LAUNCHES)
    del params
    torch.cuda.empty_cache()

    # Each kernel's count on the main path that it was written for: the
    # bf16 serve for the bf16 path's four, the int8 serve for the int8
    # LLM's five, the fully int8 serve for the int8 SAM encoder's three.
    for name, r in results.items():
        own = (serve_line if name in bf16_results else
               int8_line if name in int8_results else sam_int8_line)
        r["launches"] = own["launches"][name]
        r["launches_bf16_serve"] = serve_line["launches"][name]
        r["launches_int8_serve"] = int8_line["launches"][name]
        r["launches_sam_int8_serve"] = sam_int8_line["launches"][name]
    for r in results.values():
        print(json.dumps({"phase": "kernel", **{k: v for k, v in r.items()
                                                if k not in ("route", "source", "replaces")}}),
              flush=True)
    check_phase(gen)
    # The serve and profile numbers again, short, next to the result.
    for line, prof in ((serve_line, profile_line), (int8_line, int8_profile),
                       (sam_int8_line, sam_int8_profile)):
        line = {k: v for k, v in line.items() if k != "launches"}
        top = sorted(prof["top_device_ms"].items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({**line, "phase": line["phase"] + "_summary",
                          "init_s": init_s, "quantize_s": quantize_s,
                          "quantize_towers_s": quantize_towers_s,
                          "device_busy_s": prof["device_busy_s"],
                          "profiled_wall_s": prof["wall_s"],
                          "top_device_ms_calls": [[name[:60], ms, prof["top_device_calls"][name]]
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
