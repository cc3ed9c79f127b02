#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`ullava_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on any error:
  1. build   - compiles every CUDA kernel of the port from `kernels/csrc`
               (one nvcc per source, in parallel) and prints the build time;
  2. kernels - runs each kernel and its plain PyTorch version on the same
               inputs at the serving shapes (the bf16 path's four at B=4,
               the int8 LLM path's five, the int8 SAM encoder's three and
               the resident window layout's three at B=16) and at the
               stage-1 step's shapes (the training path's four: flash
               forward with lse, flash backward dkv and dq, RMSNorm
               backward), at a B=4 ViT-H encode's shapes (the
               weight-only forms of K10, K13 and K12, all on the wgmma +
               TMA bf16 x int8-weight core (K13 both weights in one
               launch), with their SASS counts, registers, stages, K10's
               and K12's times at the stage-2 encode's class rows and
               `torch.matmul` on the pre-widened weight, and the widening
               checked bit for bit over all 256 int8 codes), at the all-int8
               serve's (the int8 score forms of K3, K11 and K14, K2 at
               CLIP's head_dim 64) and at a B=4 packed encode's (the
               packed window and global kernels; the per-(window, head)
               window kernel, beside K3 on the same windows, and the
               decode attention that does not write, also over a long
               cache split over a cluster of blocks, which no path
               calls), holds the kernel to the
               plain version within a stated tolerance, and times the
               kernel, the plain version and, where one exists, a single
               PyTorch library call computing the same function (L2
               flushed before each timed call); a mutated run of each
               kernel must fail the same gate (for the training path's
               four, the weight-only, the int8 score forms, K3 and K14 on
               the whole-window core (each also with its registers,
               shared bytes and blocks an SM), the three
               global attention kernels on the wgmma + TMA core (K4 in
               both exponential forms, K11 in its four, K20, each with
               its SASS counts; K4 also with its registers), K2 on the
               wgmma + TMA flash forward
               at both head dims, K10, K12 and K13 (both products in one
               launch) on the wgmma + TMA int8 GEMM core (each with its
               SASS counts and registers; K2 also at B=16, K10, K12 and
               K13 also per stage and beside `torch._int_mm` per
               product), K9 in both of its forms by row count (with the
               timer's floor), K8
               (the median
               and spread of five batches beside K22's, also
               over a 2048-row cache at B=16 and at B=4, where it splits a
               sample's rows over blocks), the packed and the two
               uncalled kernels, K1 (also at the int8 serves' 5120 rows)
               and K7 (also against its plain version run on the CPU, and
               its division against IEEE division over every bf16 pair),
               also a copy of the source rebuilt with a deliberate bug);
     mlp_v2  - the chunk-pipelined W8A8 MLP (`fused_mlp_block_v2`, on
               wgmma + TMA with its int8 GELU output exchanged in the
               cluster's shared memory) against its plain version at the
               int8 SAM encoder's shape, at 1000 rows and at the MLP
               microbenchmark's shape, each at f_chunk 512 and 1024, its
               bf16 outputs bit-equal to `fused_mlp_block`'s, four mutant
               copies of its source that must fail the gate, its SASS
               counts and registers, then its main path:
               `microbench.mlp_variants.main()` once, with exact launch
               counts per variant;
  3. serve   - builds the full-width bf16 RES model (LLaMA-7B, CLIP
               ViT-L/14, SAM ViT-H) from a seeded generator on the card,
               serves B=4 requests (320-token prompts: 256 image tokens + 64
               text, 32 greedy new tokens, one mask each) through
               `serve.serve`, checks shapes, finiteness and that the bf16
               path's kernels were launched exactly as often as its layers
               and steps say, then times three more serves
               (median), each phase alone, and one serve under the
               profiler;
     packed_serve - the same, on the same weights with the SAM image
               encoder packed head-major (`pack_sam_attention`, 128 lanes
               a head): the packed window kernel in the 28 window blocks,
               the packed global kernel in the 4 global blocks, exact
               launch counts, its SAM encode beside the bf16 serve's;
  4. int8_serve - quantizes the same model's LLM to int8 (`quantize_llm`)
               and serves B=16 such requests with W8A8 prefill, the fused
               norm + quantize and the int8 KV cache, with the same checks
               and timings; every kernel of the int8 LLM path must be
               launched exactly as often as its layers and steps say;
     video_serve - on the same int8-LLM model, B=16 GIFs written by the
               phase, read through `video_eval`'s pipeline (8 frames, 224
               center crop), greedy `generate(videos=)` for 32 tokens (128
               CLIP frames, 8 + 256 video tokens a prompt): exact launches,
               `make_generate_fn`'s tokens equal, the first position's
               logits against the plain versions on the card, the host's
               decode + crop seconds apart; then one profiled call whose
               Chrome trace `tools/trace_summary` reads (trace_summary:
               its total against the profiler's busy sum);
  5. sam_int8_serve - quantizes the SAM image encoder and CLIP as well
               (`quantize_towers`) and serves B=16 requests with the int8
               SAM encoder in the block window layout (`mlp_w8a8`): every
               block's MLP through the fused int8 MLP kernel, the global
               blocks through fused LN+qkv, lane-sliced global attention
               and fused proj+residual; same checks and timings, every
               kernel launched exactly as often as its layers say;
  6. sam_resident_serve - gives the window blocks their composite rel-pos
               bias weights (`precompute_window_bias_weights`) and serves
               B=16 requests with the default window layout, which is the
               resident one: per window block the dual LN1+qkv, the window
               kernel on full windows stored as 200 rows, the boundary
               kernel on the merged right and bottom classes and on the
               corner, fused proj+residual and the fused MLP on each class;
               same checks and timings, exact launch counts;
  7. all_int8_serve - on the same weights, serves B=16 requests with the
               three knobs of `bench.py`'s all-int8 serve: int8 scores in
               the SAM attention kernels (`attn_dots_i8`), CLIP's linears
               W8A8 (`a8`) and its attention through the flash kernel at
               head_dim 64 (`attn_impl="flash"`); same checks and timings,
               exact launch counts, and CLIP's time under each combination
               of its two knobs;
  8. stage1_train - frees the serving model, builds the full-width bf16
               stage-1 model (CLIP ViT-L/14 frozen, projector, LLaMA-7B
               with remat) from the seeded generator and trains it with
               `train.build_stage1` (pretraining policy, AdamW, clip 1.0)
               on one B=4, S=1024 batch: one warm step with exact launch
               counts, five timed steps (falling loss, frozen weights
               bit-unchanged, every trainable leaf moved), one profiled;
     video_stage1_step - on those weights, one B=4 batch of 2 GIF rows
               and 2 image rows from files the phase writes, through the
               `tgif` and `llava_cc3m` builders, `image_video_collator` and
               the loader: one warm step with exact launches, three timed
               (finite losses, the projector moved, frozen leaves
               bit-unchanged), the first loss against the plain versions
               on the card;
  9. stage2_train - frees that model, builds the full-width stage-2 model
               (`train.build_stage2`: CLIP and the SAM image encoder int8
               weight-only and frozen, LLaMA-7B in bf16 with LoRA r=8 on
               q_proj and v_proj and remat, the SAM mask decoder and the
               [SEG]/[LOC] heads trained) and trains it under `STAGE2_LORA`
               on one B=4, S=512 batch of `train.make_stage2_batch`: one warm
               step with exact launch counts (the weight-only K10 and K12
               on every SAM encode, no int8-activation kernel), three timed,
               one profiled (falling loss, frozen weights bit-unchanged,
               adapters and heads moved); then one resident encode of its
               SAM encoder with composite bias weights and `mlp_w8a8` off,
               the path of K13's weight-only form, with exact counts;
 10. inference - writes a full-width checkpoint set into a temporary
               directory (LLaMA at Vicuna-7B's widths cut to 4 layers and
               CLIP ViT-L/14 as bf16 safetensors, SAM ViT-H with Meta's key
               names as an fp32 `.pth`), loads and converts it (one linear of
               each tower held to its transposed source exactly), then runs
               `inference_ullava.run_once` with `quantize: int8`,
               `kv_cache: int8` on a seeded 480 x 640 image with the toy
               tokenizer, temperature 0.2, top-p 0.9 and 32 new tokens:
               finite outputs, three masks at 480 x 640 and three boxes,
               exact launch counts; then the sampler on the card against
               the CPU nucleus (support and a chi-square test over 4096
               draws a row); prints the write, load, convert, build and run
               seconds and the peak memory beside the card's name and power
               limit, and keeps the directory for the next phase;
     chat    - `webui.gradio_chat.Chat` over those files: `seg` at
               temperature 0 on both preprocess routes, exact launches,
               against `run_once` at temperature 0; then xla_route: one
               SAM encode with `attn_kernel="xla"` on the card's tensors
               (no kernel launched) against the kernels' route;
 11. train_clis - the training and eval CLIs from files: writes 8 RES
               images of 480 x 640 as PNG (every scanline filter), COCO
               polygons, a 4-item val set, a one-question SEG.json and an
               8-item chat set and a 4-item TGIF set (GIFs), asserts the
               native host library loaded, then
               runs `train_ullava` from a YAML (int8 towers, LoRA r=8, B=2,
               one epoch of 4 steps, the epoch eval, `save_steps: 2`), again
               with two epochs (it resumes at step 4), `eval_ullava` on the
               last checkpoint and `train_ullava_core` on the chat and
               TGIF sets (B=2, 6 steps), all on
               the previous phase's checkpoint files: exact launches of a
               stage-2 step, a stage-1 step and an eval batch, the first
               stage-2 loss bit-equal to `train.make_stage2_step` run
               directly and the third within 1e-3, frozen leaves unchanged
               and trained ones moved, the resume and the eval gates, then
               the kernels at the CLIs' B=2 and B=8 shapes against their
               plain versions, with their mutants; deletes both
               directories;
 12. sam_predictor - the public SAM surface at full width on the card:
               writes Meta-named ViT-L and ViT-B checkpoints (fp32 `.pth`),
               converts them and, for ViT-L in bf16, ViT-L with int8 towers
               and composite bias weights (`mlp_w8a8`) and ViT-B in bf16,
               builds `SamPredictor`: `set_image` on one 480 x 640 image
               with exact launch counts (the hd 64 forms of K3, K14 and K4,
               or K3, K14, K11 with K10, K12, K13 at ViT-L's widths) and
               the embedding against the port's plain path on the card,
               `predict` with one point, two points and a box, and a box
               alone for one mask, each against the CPU from the same
               embedding, `SamAutomaticMaskGenerator.generate` at 16 points
               a side (its kept set equal to the CPU's) and the decoder
               exported with `export_sam_decoder`, loaded and run with a
               mask input (against `make_decoder_fn`); each step's time on
               a line of its own; then the hd 64 forms and the W8A8 kernels
               at ViT-L's and ViT-B's B=1 shapes against their plain
               versions, with their mutants, and the hd 64 forms' kernel
               lines;
 13. check   - runs small models (bf16, its SAM encoder also packed, then
               int8 LLM, also on a one-sample 12-token prompt, then an int8 SAM
               encoder in the block and in the resident layout, the latter
               also with int8 scores beside a W8A8 flash CLIP tower, then
               three stage-1 steps under each freeze policy, then three
               stage-2 steps over int8 towers with LoRA, each stage-2 step
               read from parameters shared with the CPU) on the card and on
               the CPU (plain versions, fp32) from the same weights and
               holds the card's outputs to the CPU reference, and the
               resident encoder's to the block layout's; then
               `train.train_stage1` end to end with checkpoints and resume;
 14. summary - prints the serve and training numbers again, the wall
               seconds of each phase (`timeline`), the card's name and
               power limit, one JSON line with every kernel's numbers, and
               last the device line.

Exits non-zero with no result when CUDA is unavailable.

    python3 chip_smoke.py --check-draws SEED ...

runs only the training checks of phase 13 on the draws of the given seeds
(each its own generator), then reads each draw's stage-2 steps again leaf
by leaf beside the witnesses of `ullava_tpu_torch/microbench/stage2_grads.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
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


def time_ms(fn, iters: int, warmup: int = 2, read_flush: bool = False) -> float:
    """Mean device time of `fn` over `iters` calls, each timed alone with
    CUDA events after a 256 MB write that evicts the 50 MB L2, so that
    its inputs come from HBM as on the main path. The write leaves the L2
    full of dirty lines, whose write-back then shares HBM with the timed
    call; `read_flush` evicts by a 256 MB read instead, which leaves clean
    lines (what a decode step's kernels find after its weight reads)."""
    import torch

    for _ in range(warmup):
        fn()
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, end in ev:
        if read_flush:
            flush.amax()
        else:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in ev) / iters


def stage_ms(run, bits: dict, iters: int = 10) -> dict:
    """{stage: ms} of `run(bits)` for each stage's bit mask of a kernel
    entry that runs its stages alone on an earlier call's scratch."""
    return {name: time_ms(lambda b=b: run(b), iters) for name, b in bits.items()}


def row_rel_err(got, ref) -> float:
    """max over output rows of max|got - ref| / max|ref| on that row: an
    error in units of each row's own scale (all-zero rows count 0)."""
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    err = (got - ref).abs().amax(-1)
    return (err / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def grad_rel_err(got, ref) -> float:
    """`row_rel_err` with each row's scale floored at 2^-8 of the tensor's
    largest value: a gradient row can be zero by cancellation (dq of the
    first query: one live key, dP = delta), where fp32 sums in another
    order leave noise of 1e-7 that its own scale would blow up."""
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    scale = ref.abs().amax(-1).clamp_min(ref.abs().max().item() * 2.0**-8 + 1e-30)
    return ((got - ref).abs().amax(-1) / scale).max().item()


def bound_ms(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def live_bytes(lens, *ts) -> int:
    """Bytes of the rows of each [B, S, ...] tensor in `ts` below its
    batch row's length in `lens`: what a kernel that stops at kv_lens
    reads of its keys and values."""
    return sum(min(int(n), t.shape[1]) * t[0, 0].numel() * t.element_size()
               for t in ts for n in lens)


def sass_counts(source: str, function: str, ops=("HGMMA", "UTMALDG", "HMMA")):
    """How many of each instruction in `ops` the SASS of the built
    library's kernels whose name holds `function` contains, read with
    `cuobjdump -sass`; "not measured" where the toolkit has no cuobjdump."""
    import re
    from pathlib import Path

    from ullava_tpu_torch import kernels

    tool = Path(kernels.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return "not measured"
    sass = subprocess.run([str(tool), "-sass", str(kernels.lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    counts = dict.fromkeys(ops, 0)
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            for op in ops:
                counts[op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def bound_i8_ms(nbytes: float, flops: float):
    """The bound of an int8-score attention: its `flops` (4 a score and
    head element) half in the qk product at the int8 peak and half in P V
    at the bf16 peak, against the bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / 2 / INT8_OPS_PER_S + flops / 2 / BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_line(name, max_abs_err, gate, kern, plain, library, in_out, flops, iters=20,
                flops_per_s=BF16_FLOPS_PER_S, bound=None) -> dict:
    """Time a checked kernel, its plain version and its library call, and
    put the numbers beside its bound (`bound` = (ms, by), or from the
    bytes and `flops` at `flops_per_s`) and what its gate measured."""
    from ullava_tpu_torch import kernels

    b_ms, b_by = bound or bound_ms(in_out, flops, flops_per_s)
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


# The deliberate bugs of K2's wgmma + TMA forward (`flash_fwd_sm90.cuh`,
# which K15 shares) that its gates must catch, each built into a copy of
# K2's source: a kv_len-edge tile masked at the tile's end instead of at
# kv_len (both head dims), and K15's causal bound one key late (the causal
# hd 128 gate).
K2_MUTANTS = {
    "kv_edge_at_tile_end": ("flash_attention.cu", "ULLAVA_MUTANT_KV_EDGE_TILE_END"),
    "causal_mask_shifted": ("flash_attention.cu", "ULLAVA_MUTANT_CAUSAL_SHIFT"),
}
K2_ATTRS = ("flash_attention.cu", "ullava_flash_attention_fwd_bsh_attrs")


def k2_sass() -> dict:
    """K2's `HGMMA` / `UTMALDG` / `HMMA` counts in the built library's SASS,
    for each head dim's kernel (the template's mangled name holds it)."""
    return {f"hd{hd}": sass_counts("flash_attention.cu", f"flash_fwd_sm90_kernelILi{hd}E")
            for hd in (128, 64)}


def k2_b16_line(gen, H, hd) -> dict:
    """K2 at the int8 serves' prefill, [16, 320, 32, 128], causal, kv_lens
    320 down to 257: its gate, time, bound and SDPA + mask."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch.ops import attention

    q, k, v = ((torch.randn((B_INT8, PROMPT, H, hd), generator=gen, device="cuda")).to(
        torch.bfloat16) for _ in range(3))
    lens = torch.tensor([PROMPT - (i * 63) // (B_INT8 - 1) for i in range(B_INT8)],
                        device="cuda", dtype=torch.int32)
    sc = hd**-0.5
    run = lambda: attention.flash_attention_fwd_bsh(q, k, v, lens, causal=True, scale=sc)  # noqa: E731
    got = run()
    ref = attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=sc)
    err = row_rel_err(got, ref)
    must("flash_attention_fwd_bsh B=16", err <= 1e-2, err)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kp = torch.arange(PROMPT, device="cuda")
    mask = (kp[None, :] <= kp[:, None])[None, None] & (kp[None, :] < lens[:, None])[:, None, None, :]
    live = sum(min(i + 1, int(n)) for n in lens.tolist() for i in range(PROMPT)) * H
    b_ms, b_by = bound_ms(2 * nbytes(q) + nbytes(lens) + live_bytes(lens.tolist(), k, v),
                          4.0 * hd * live)
    return {"shape": [B_INT8, PROMPT, H, hd], "row_rel_err": err, "tol": 1e-2,
            "ms": time_ms(run, 20), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sc), 20)}


# The deliberate bugs of K1's redesign (`rope.cu`), each built into a copy
# of the source: the block's first row's table used for every row the
# block walks, and the rotation partner taken with the wrong sign.
K1_MUTANTS = {
    "first_row_table": ("rope.cu", "ULLAVA_MUTANT_ROPE_FIRST_ROW_TABLE"),
    "partner_sign": ("rope.cu", "ULLAVA_MUTANT_ROPE_PARTNER_SIGN"),
}
K1_ATTRS = ("rope.cu", "ullava_fused_rotary_attrs")


def k1_rows_line(gen, R, width, hd) -> dict:
    """K1 at the int8 serves' prefill, R = 5120 rows of [R, width]: its
    gate, both source mutants (a block walks several rows here, so the
    first-row-table copy shows), time, plain time and bound."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import rope

    x = torch.randn((R, width), generator=gen, device="cuda").to(torch.bfloat16)
    cos, sin = rope.rope_cos_sin(torch.arange(PROMPT, device="cuda").repeat(R // PROMPT), hd)
    run = lambda: rope.fused_rotary(x, cos, sin, hd)  # noqa: E731
    ref = rope.fused_rotary_plain(x, cos, sin, hd)
    err = row_rel_err(run(), ref)
    must(f"fused_rotary {R} rows", err <= 1e-2, err)
    caught = {}
    for bug, src_define in K1_MUTANTS.items():
        with kernels.mutant(*src_define):
            e = row_rel_err(run(), ref)
        caught[bug] = must_not(f"fused_rotary {R} rows", bug, e <= 1e-2, e)
    b_ms, b_by = bound_ms(2 * nbytes(x) + nbytes(cos, sin), 6.0 * x.numel(), FP32_FLOPS_PER_S)
    return {"shape": [R, width], "row_rel_err": err, "tol": 1e-2, "mutant_row_rel_err": caught,
            "ms": time_ms(run, 20), "plain_ms": time_ms(lambda: rope.fused_rotary_plain(
                x, cos, sin, hd), 5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": device_ms_a_call(run, "rope_kernel")}


def kernel_phases(gen) -> dict:
    """Each kernel against its plain version at the serving shapes.

    The gate is `row_rel_err` within `tol` = 1e-2: one bf16 ulp of a
    row's largest value is at most 2^-7 = 0.0078 of it, so the gate admits
    one ulp of disagreement there and not two. It must also reject a wrong
    kernel: each kernel is run once more on a mutated input that stands
    for a typical bug (rotation sign, causal mask, bias dropped or its two
    terms swapped; K3 also a copy of its source built with
    `QUAD_MAX_MUTANTS`, K2 copies built with `K2_MUTANTS`), and that
    output, held to the same reference, must fail the gate."""
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
        results[name] = kernel_line(
            name, (got.float() - ref.float()).abs().max().item(),
            {"row_rel_err": err, "tol": tol, "mutant_row_rel_err": caught},
            kern, plain, library, in_out, flops, iters)

    # K1: rotary on the q (or k) rows of one 7B prefill layer. Both round
    # one fp32 result to bf16: one ulp is 2^-8 of the value. At the bf16
    # serve's 1280 rows, and at the int8 serves' 5120 (`k1_rows_line`).
    R, hd, width = B * PROMPT, 128, 4096
    x = randn(R, width)
    pos = torch.arange(PROMPT, device=dev).repeat(B)
    cos, sin = rope.rope_cos_sin(pos, hd)
    with kernels.mutant(*K1_MUTANTS["partner_sign"]):
        partner_sign = rope.fused_rotary(x, cos, sin, hd)
    record("fused_rotary", rope.fused_rotary(x, cos, sin, hd),
           rope.fused_rotary_plain(x, cos, sin, hd),
           {"sin_negated": rope.fused_rotary(x, cos, -sin, hd), "partner_sign": partner_sign}, 1e-2,
           lambda: rope.fused_rotary(x, cos, sin, hd),
           lambda: rope.fused_rotary_plain(x, cos, sin, hd), None,
           2 * nbytes(x) + nbytes(cos, sin), 6.0 * x.numel())
    results["fused_rotary"].update(
        shape=[R, width], kernel=kernels.kernel_attrs(*K1_ATTRS, width, hd),
        # Its own generator: the phases after it draw what they drew before.
        rows_5120=k1_rows_line(torch.Generator(device=dev).manual_seed(17), B_INT8 * PROMPT,
                               width, hd))
    del x, partner_sign

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
    k2_mutants = {"not_causal": attention.flash_attention_fwd_bsh(q, k, v, lens, causal=False, scale=sc)}
    for bug, src_define in K2_MUTANTS.items():
        with kernels.mutant(*src_define):
            k2_mutants[bug] = run()
    record("flash_attention_fwd_bsh", run(),
           attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=sc),
           k2_mutants, 1e-2, run,
           lambda: attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=sc),
           lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sc),
           2 * nbytes(q) + nbytes(lens) + live_bytes(lens.tolist(), k, v), 4.0 * hd * live)
    results["flash_attention_fwd_bsh"].update(
        shape=[B, PROMPT, H, hd], sass=k2_sass(),
        # Its own generator: the phases after it draw what they drew before.
        b16=k2_b16_line(torch.Generator(device=dev).manual_seed(13), H, hd),
        kernel=kernels.kernel_attrs(*K2_ATTRS, hd))
    del qt, kt, vt, mask, k2_mutants

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
    with kernels.mutant(*QUAD_MAX_MUTANTS["sam_window_attention.cu"]):
        quad_max_dropped = run()
    record("fused_window_attention_grid", run(),
           sam_attention.fused_window_attention_grid_plain(y, a, bb, Hs, hds, W, sc),
           {"bias_dropped": sam_attention.fused_window_attention_grid(y, zero, zero, Hs, hds, W, sc),
            "bias_swapped": sam_attention.fused_window_attention_grid(y, bb, a, Hs, hds, W, sc),
            "quad_max_dropped": quad_max_dropped},
           1e-2, run,
           lambda: sam_attention.fused_window_attention_grid_plain(y, a, bb, Hs, hds, W, sc),
           lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=wmask, scale=sc),
           nbytes(y, a, bb) + nbytes(y) // 3, 4.0 * N * Hs * S * S * hds)
    results["fused_window_attention_grid"]["kernel"] = kernels.kernel_attrs(*WINDOW_ATTRS["grid"], 0)
    del y5, A, Bm, wmask, y, zero, quad_max_dropped

    # K4: one ViT-H global block at B=4: 64 (image, head) pairs over 4096,
    # on the global core (`k4_line`).
    results["fused_global_attention"] = k4_line(gen, B * Hs, hds)
    torch.cuda.empty_cache()
    return results


# The deliberate bugs of K4 on the global core, each built into a copy of
# its source: the A term of a 128-key tile's first grid row used for both
# halves (the core's), and the raw bias terms read without their 1/scale
# pre-scale.
K4_MUTANTS = {
    "a_term_of_first_grid_row": ("sam_global_attention.cu", "ULLAVA_MUTANT_GLOBAL_A_ONE_ROW"),
    "bias_not_prescaled": ("sam_global_attention.cu", "ULLAVA_MUTANT_GLOBAL_BIAS_RAW"),
}
K4_ATTRS = ("sam_global_attention.cu", "ullava_fused_global_attention_attrs")


def k4_line(gen, N, hd, W=64, iters=5) -> dict:
    """K4 (`fused_global_attention`) on N (image, head) pairs over the
    64 x 64 grid, in both exponential forms: each against its plain
    version (row rel 1e-2 with fp32 exponentials; 2e-2 with bf16 ones,
    whose rounding follows the running maximum, so the key tiling), with
    the bias dropped and swapped and both `K4_MUTANTS` copies failing the
    same gate; its time, plain time, bound, SDPA + mask, TFLOP/s, SASS
    counts (`HGMMA`, `UTMALDG`, no `HMMA`) and registers. The bias terms
    come from `decomposed_bias_terms` as in the encoder: unscaled q against
    rel_pos tables of std 0.25 (std about 2.2)."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import sam_attention

    bf, S = torch.bfloat16, W * W
    sc = hd**-0.5
    q, k, v = (torch.randn((N, S, hd), generator=gen, device="cuda").to(bf) for _ in range(3))
    rel_h, rel_w = ((torch.randn((2 * W - 1, hd), generator=gen, device="cuda") * 0.25).to(bf)
                    for _ in range(2))
    a, bb = (t.reshape(N, S, W).to(bf) for t in sam_attention.decomposed_bias_terms(
        q.reshape(1, N, W, W, hd), rel_h, rel_w, W))
    zero = torch.zeros_like(a)
    flops = 4.0 * N * S * S * hd
    forms = {}
    for form, exp_bf16, tol in (("exp_fp32", False, 1e-2), ("exp_bf16", True, 2e-2)):
        run = lambda a_=a, b_=bb, e=exp_bf16: sam_attention.fused_global_attention(  # noqa: E731
            q, k, v, a_, b_, W, sc, exp_bf16=e)
        ref = sam_attention.fused_global_attention_plain(q, k, v, a, bb, W, sc, exp_bf16=exp_bf16)
        got = run()
        err = row_rel_err(got, ref)
        must(f"fused_global_attention {form}", err <= tol, err)
        caught = {"bias_dropped": row_rel_err(run(zero, zero), ref),
                  "bias_swapped": row_rel_err(run(bb, a), ref)}
        for bug, src_define in K4_MUTANTS.items():
            with kernels.mutant(*src_define):
                caught[bug] = row_rel_err(run(), ref)
        for m, e in caught.items():
            must_not(f"fused_global_attention {form}", m, e <= tol, e)
        forms[form] = {"row_rel_err": err, "tol": tol, "mutant_row_rel_err": caught,
                       "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                       "ms": time_ms(run, iters),
                       "kernel": kernels.kernel_attrs(*K4_ATTRS, int(exp_bf16))}
        forms[form]["tflops"] = flops / forms[form]["ms"] / 1e9
        del got, ref
    gmask = (a.float()[:, :, :, None] + bb.float()[:, :, None, :]).reshape(N, S, S).to(bf)
    fp32 = forms["exp_fp32"]
    line = kernel_line(
        "fused_global_attention", fp32.pop("max_abs_err"),
        {k_: fp32[k_] for k_ in ("row_rel_err", "tol", "mutant_row_rel_err")},
        lambda: sam_attention.fused_global_attention(q, k, v, a, bb, W, sc),
        lambda: sam_attention.fused_global_attention_plain(q, k, v, a, bb, W, sc),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=gmask, scale=sc),
        nbytes(q, k, v, a, bb) + nbytes(q), flops, iters=iters)
    del gmask
    counts = sass_counts("sam_global_attention.cu", "global_sm90_kernel")
    if counts != "not measured":
        must("fused_global_attention SASS",
             counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0, counts)
    forms["exp_bf16"].pop("max_abs_err")
    line.update(shape=[N, S, hd], tflops=flops / line["ms"] / 1e9, kernel=fp32["kernel"],
                sass=counts, exp_bf16_form=forms["exp_bf16"])
    return line


def global_sdpa_inputs(y, a, bb):
    """The library yardstick of the lane-sliced global kernel (K11):
    head-major q, k, v copies of y [B, S, 3C] ([3, B, H, S, hd]) and the
    bias terms [B, S, H, W] (natural column order, pre-scaled by 1/scale)
    materialised as a [B, H, S, S] bf16 mask (8.6 GB at B=16), built per
    image."""
    import torch

    B, S, _ = y.shape
    H, W = a.shape[2:]
    hd = y.shape[-1] // (3 * H)
    y5 = y.reshape(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).contiguous()
    mask = torch.empty((B, H, S, S), dtype=torch.bfloat16, device=y.device)
    for i in range(B):
        am, bm = a[i].float().permute(1, 0, 2), bb[i].float().permute(1, 0, 2)  # [H, S, W]
        mask[i] = ((am[:, :, :, None] + bm[:, :, None, :]).reshape(H, S, S) * hd**-0.5).to(
            torch.bfloat16)
    return y5, mask


def global_core_sass(source) -> dict:
    """The SASS counts of the global core's kernels in `source`'s library;
    each entry must hold wgmma (`HGMMA`) and TMA loads (`UTMALDG`)."""
    counts = sass_counts(source, "global_sm90_kernel")
    if counts != "not measured":
        must(f"{source} global core SASS", counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, counts)
    return counts


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


# The deliberate bugs of K8's redesign (`decode_attention_int8.cu`) that
# its gates must catch, each built into a copy of the source: the splits'
# partials merged without rescaling to their common max, and the last row
# tile of a split left out.
K8_MUTANTS = {
    "merge_without_rescale": ("decode_attention_int8.cu", "ULLAVA_MUTANT_DECODE_MERGE_NO_RESCALE"),
    "split_last_tile_left_out": ("decode_attention_int8.cu", "ULLAVA_MUTANT_DECODE_SPLIT_LAST_TILE"),
}
K8_ATTRS = ("decode_attention_int8.cu", "ullava_decode_attention_int8_fused_write_attrs")
# The deliberate bug of K9's few-row form (`rms_quant.cu`): the last warp's
# partial left out of the row's sum of squares.
K9_MUTANTS = {"warp_partial_left_out": ("rms_quant.cu", "ULLAVA_MUTANT_RMS_ROWS_PARTIAL")}


# The deliberate bugs of K7's redesign (`kv_quant_write.cu`), each built
# into a copy of the source: a head's abs-max taken over half its lanes,
# and the scales written one cache row late.
K7_MUTANTS = {
    "half_lanes_amax": ("kv_quant_write.cu", "ULLAVA_MUTANT_KV_HALF_LANES_AMAX"),
    "scales_one_row_late": ("kv_quant_write.cu", "ULLAVA_MUTANT_KV_SCALE_ROW_LATE"),
}
K7_ATTRS = ("kv_quant_write.cu", "ullava_prefill_quantize_write_attrs")


def k7_cpu_exact(k, v, cache, expect, layer) -> dict:
    """The share of K7's int8 values and scales equal to the plain version
    run on the CPU (fp32 there: every division IEEE), beside the same share
    of the plain version run on the card, and which of the two departs."""
    from ullava_tpu_torch.ops import decode_attention

    B_, S_, H_, hd_ = k.shape
    out, departs = {}, set()
    for i, (name, x) in enumerate((("k", k), ("v", v))):
        q_cpu, s_cpu = decode_attention.quantize_kv_rows(x.cpu())
        for side, got in (("kernel", cache), ("card_plain", expect)):
            q = got[i][layer, :, :S_].cpu().reshape(B_, S_, H_, hd_)
            s_ = got[i + 2][layer, :, :S_].cpu()
            share = {f"{name}_int8": (q == q_cpu).float().mean().item(),
                     f"{name}_scale": (s_ == s_cpu).float().mean().item()}
            out.setdefault(side, {}).update(share)
            if min(share.values()) < 1.0:
                departs.add(side)
    out["departs"] = sorted(departs) or "neither"
    log(f"[kernel] prefill_quantize_write exact_vs_cpu_plain {json.dumps(out)}")
    return out


def spread_ms(fn, batches: int = 5, iters: int = 20) -> dict:
    """`ms` the median of `batches` batches of `time_ms(fn, iters)`, with
    their least and largest: one number cannot show a change where runs
    of one code spread; and `ms_read_flush` the median of as many batches
    timed after an L2 eviction that leaves no dirty lines."""
    runs = sorted(time_ms(fn, iters) for _ in range(batches))
    clean = sorted(time_ms(fn, iters, read_flush=True) for _ in range(batches))
    return {"ms": runs[len(runs) // 2], "ms_min": runs[0], "ms_max": runs[-1], "batches": batches,
            "ms_read_flush": clean[len(clean) // 2]}


class K8Case:
    """One decode step's inputs over an int8 cache, the plain versions'
    answers on a copy, and K8's gates against them: 2^-7 of a row's
    largest value against the plain version fed q in fp32, 2^-6 against
    the bf16 plain version, every cache byte but the new rows untouched."""

    def __init__(self, q, kq, ks, vq, vs, cache, wp, layer, scale):
        from ullava_tpu_torch.ops import decode_attention

        self.args, self.cache = (q, kq, ks, vq, vs), cache
        self.wp, self.layer, self.scale = wp, layer, scale
        self.expect = decode_attention.decode_attention_int8_fused_write_plain(
            *self.args, *(c.clone() for c in cache), wp, layer, scale=scale)
        self.ref = decode_attention.decode_attention_int8_fused_write_plain(
            q.float(), *self.args[1:], *(c.clone() for c in self.expect[1:]), wp, layer,
            scale=scale)[0].to(q.dtype)

    def run(self, splits=None):
        """The public entry, or its CUDA form with `splits` blocks a
        (sample, head) forced; (attn, the four cache tensors)."""
        from ullava_tpu_torch.ops import decode_attention

        if splits is None:
            return decode_attention.decode_attention_int8_fused_write(
                *self.args, *self.cache, self.wp, self.layer, scale=self.scale)
        return (decode_attention._fused_write_cuda(
            *self.args, *self.cache, self.wp, self.layer, self.scale, splits), *self.cache)

    def err(self, got) -> float:
        """The smaller of the two gates' errors (a mutant must fail both)."""
        return min(row_rel_err(got, self.ref), row_rel_err(got, self.expect[0]))

    def gate(self, name, got) -> dict:
        import torch

        torch.cuda.synchronize()
        err, err_bf16 = row_rel_err(got[0], self.ref), row_rel_err(got[0], self.expect[0])
        untouched = all(torch.equal(g_, e_) for g_, e_ in zip(got[1:], self.expect[1:]))
        info = {"row_rel_err": err, "tol": 2.0**-7, "row_rel_err_to_bf16_plain": err_bf16,
                "tol_to_bf16_plain": 2.0**-6, "cache_equals_scatter": untouched,
                "max_abs_err": (got[0].float() - self.ref.float()).abs().max().item()}
        must(name, err <= 2.0**-7 and err_bf16 <= 2.0**-6 and untouched, info)
        return info

    def bytes(self) -> float:
        """What the step must move: the write_pos rows of K and V a sample
        and their scales, q and out, the new rows, write_pos."""
        q, kq, ks = self.args[:3]
        Hkv = ks.shape[-1]
        hist = float(self.wp.clamp(0, self.cache[0].shape[2]).sum())
        return (hist * (2 * kq.shape[-1] + 2 * 4 * Hkv) + 2 * nbytes(q)
                + 2 * nbytes(*self.args[1:]) + nbytes(self.wp.int()))

    def spread(self, splits=None) -> dict:
        return spread_ms(lambda: self.run(splits))

    def k22_spread(self) -> dict:
        """K22 over rows [0, write_pos] of the cache K8 has written."""
        from ullava_tpu_torch.ops import decode_attention

        kl = (self.wp + 1).int()
        return spread_ms(lambda: decode_attention.decode_attention_int8(
            self.args[0], *self.cache, kl, self.layer, scale=self.scale))


def k8_long_cache_line(gen, Bk: int, label: str) -> dict:
    """K8 over one layer of a [1, Bk, 2048, 4096] int8 cache (a 268 MB
    slice at Bk=16), write positions 1900-2047: its gates, its time (the
    chosen split and one block a (sample, head)) beside its bound, and
    K22's on the same rows."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import decode_attention

    dev, H, hd, S = "cuda", 32, 128, 2048
    cache = [torch.randint(-127, 128, (1, Bk, S, H * hd), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    cache += [torch.rand((1, Bk, S, H), generator=gen, device=dev) * 0.02 + 1e-3
              for _ in range(2)]
    q = (torch.randn((Bk, 1, H, hd), generator=gen, device=dev)).to(torch.bfloat16)
    kq, ks = decode_attention.quantize_kv_rows(
        torch.randn((Bk, H, hd), generator=gen, device=dev) + 0.25 * q[:, 0].float())
    vq, vs = decode_attention.quantize_kv_rows(torch.randn((Bk, H, hd), generator=gen, device=dev) * 3)
    wp = 1900 + (torch.arange(Bk, device=dev) * 37) % 148
    k8 = K8Case(q, kq.reshape(Bk, H * hd), ks, vq.reshape(Bk, H * hd), vs, cache, wp, 0, hd**-0.5)
    splits = decode_attention.fused_write_splits(
        Bk, H, S, torch.cuda.get_device_properties(0).multi_processor_count)
    info = k8.gate(f"decode_attention_int8_fused_write {label}", k8.run())
    caught = {}
    for bug, src_define in K8_MUTANTS.items():
        with kernels.mutant(*src_define):
            caught[bug] = k8.err(k8.run(splits=max(splits, 2) if bug == "merge_without_rescale"
                                        else None)[0])
        must_not(f"decode_attention_int8_fused_write {label}", bug, caught[bug] <= 2.0**-6,
                 caught[bug])
    hist = float(wp.sum())
    b_ms, b_by = bound_ms(k8.bytes(), 4.0 * hist * H * hd, FP32_FLOPS_PER_S)
    line = {"shape": [1, Bk, S, H * hd], "write_pos": [int(wp.min()), int(wp.max())],
            "slice_bytes": nbytes(*cache), **info, "mutant_row_rel_err": caught,
            "splits": splits, **k8.spread(), "bound_ms": b_ms, "bound_by": b_by,
            "k22": k8.k22_spread()}
    line["other_splits_ms"] = {str(n): k8.spread(n)["ms"] for n in (1, 2, 4) if n != splits}
    del k8, cache
    torch.cuda.empty_cache()
    return line


def int8_kernel_phases(gen) -> dict:
    """The five kernels of the int8 LLM path against their plain versions
    at the shapes of a B=16 serve (5120 prefill rows; a [32, 16, 352,
    4096] int8 cache; K8 also over a 2048-row cache at B=16 and B=4).

    Gates: int8 outputs at least 99.9% exact and the rest within 1 (a
    value within fp32 summation-order noise of .5 may round the other
    way); abs-max and scales within rtol 1e-6; the residual stream `h`
    bit-exact; bf16 outputs by `row_rel_err` within 1e-2 (the decode
    kernel's two limits are stated where it is checked); for the two
    cache kernels every byte outside the rows they write unchanged. Each
    gate must reject a mutated run that stands for a typical bug."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
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
    # at the 16 rows of a decode step's (checked and timed the same way),
    # which take its few-row form (x and w held in registers).
    x9, x9d = randn(rows, D, scale=2.0), randn(B_INT8, 1, D, scale=2.0)
    y_ref, yd_ref = norms.rms_norm_plain(x9, w, 1e-6), norms.rms_norm_plain(x9d, w, 1e-6)
    y = norms.rms_norm(x9, w, 1e-6)
    err, err_d = row_rel_err(y, y_ref), row_rel_err(norms.rms_norm(x9d, w, 1e-6), yd_ref)
    must("rms_norm_fwd", err <= tol and err_d <= tol, (err, err_d))
    bad = row_rel_err(norms.rms_norm(x9, torch.ones_like(w), 1e-6), y_ref)
    bad_d = row_rel_err(norms.rms_norm(x9d, torch.ones_like(w), 1e-6), yd_ref)
    must_not("rms_norm_fwd", "weight_dropped", bad <= tol or bad_d <= tol, (bad, bad_d))
    # The few-row form at 1 and 16 rows and at its crossover, the staged
    # form one row past it, and the few-row form at widths that are no
    # multiple of its 2048-element pass, up to the widest (with their own
    # weights), each gated, and the copy that leaves one warp's partial out
    # of the sum.
    cgen = torch.Generator(device=dev).manual_seed(16)  # the phases after draw as before
    cut = norms.RMS_FEW_ROWS
    edges = {}
    for r_, d_ in ((1, D), (B_INT8, D), (cut, D), (cut + 1, D), (B_INT8, D + 8), (3, 12256)):
        xe = (torch.randn((r_, d_), generator=cgen, device=dev) * 2.0).to(bf)
        we = (1 + 0.1 * torch.randn(d_, generator=cgen, device=dev)).to(bf)
        ref_e = norms.rms_norm_plain(xe, we, 1e-6)
        e_ = row_rel_err(norms.rms_norm(xe, we, 1e-6), ref_e)
        must(f"rms_norm_fwd {r_}x{d_}", e_ <= tol, e_)
        edges[f"{r_}x{d_}"] = {"form": "few_rows" if r_ <= cut else "staged",
                               "row_rel_err": e_}
        if r_ <= cut:
            with kernels.mutant(*K9_MUTANTS["warp_partial_left_out"]):
                m_ = row_rel_err(norms.rms_norm(xe, we, 1e-6), ref_e)
            edges[f"{r_}x{d_}"]["mutant_row_rel_err"] = {"warp_partial_left_out": must_not(
                f"rms_norm_fwd {r_}x{d_}", "warp_partial_left_out", m_ <= tol, m_)}
    # Both forms' kernel time by the profiler, by row count at D 4096:
    # where the few-row form stops paying.
    crossover = {}
    for r_ in (1, 16, 256, 512, 1024, 2048, 5120):
        xe = (torch.randn((r_, D), generator=cgen, device=dev) * 2.0).to(bf)
        crossover[str(r_)] = {
            f"{name}_device_ms": device_ms_a_call(
                lambda c=c, xe=xe: norms._rms_norm_fwd_cuda(xe, w, 1e-6, c), kern)
            for name, c, kern in (("few_rows", True, "rms_fwd_rows_kernel"),
                                  ("staged", False, "rms_row_kernel"))}
    decode_rows = {
        "rows": B_INT8, "form": "few_rows", "row_rel_err": err_d,
        "mutant_row_rel_err": {"weight_dropped": bad_d},
        "ms": time_ms(lambda: norms.rms_norm(x9d, w, 1e-6), 20),
        # The staged form on the same inputs, and the same timers around a
        # launch that does nothing: what a launch costs at least.
        "staged_ms": time_ms(lambda: norms._rms_norm_fwd_cuda(x9d, w, 1e-6, False), 20),
        "timer_floor_ms": time_ms(lambda: torch.cuda._sleep(0), 20),
        "plain_ms": time_ms(lambda: norms.rms_norm_plain(x9d, w, 1e-6), 20),
        "library_ms": time_ms(lambda: F.rms_norm(x9d, (D,), w, 1e-6), 20),
        "bound_ms": bound_ms(nbytes(x9d, w, yd_ref), 6.0 * x9d.numel(), FP32_FLOPS_PER_S)[0],
        "device_ms": crossover[str(B_INT8)]["few_rows_device_ms"],
        "staged_device_ms": crossover[str(B_INT8)]["staged_device_ms"],
        "timer_floor_device_ms": device_ms_a_call(lambda: torch.cuda._sleep(0), "spin"),
        "few_rows_max": cut, "edges": edges, "crossover_ms": crossover,
    }
    log(f"[kernel] rms_norm_fwd decode_rows {json.dumps(decode_rows)}")
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
    # The source's own bugs (`K7_MUTANTS`), each run on a copy of the
    # written cache.
    for bug, src_define in K7_MUTANTS.items():
        copy = [c.clone() for c in cache]
        with kernels.mutant(*src_define):
            decode_attention.prefill_quantize_write(k, v, *copy, layer)
        bad = judge_cache(copy)
        info["mutants"][bug] = must_not("prefill_quantize_write", bug, *bad)
        del copy
    info["exact_vs_cpu_plain"] = k7_cpu_exact(k, v, cache, expect, layer)
    # Its division (one reciprocal a head, one fma correction) against
    # IEEE division over every bf16 pair |x| <= amax: no code may differ.
    codes, quotients, pairs = decode_attention.kv_quant_division_check()
    info["division_check"] = {"codes_differ": codes, "quotients_differ": quotients, "pairs": pairs}
    must("prefill_quantize_write division", codes == 0, info["division_check"])
    results["prefill_quantize_write"] = kernel_line(
        "prefill_quantize_write", float(max(info["k"]["int8_max_diff"], info["v"]["int8_max_diff"])),
        info, lambda: decode_attention.prefill_quantize_write(k, v, *cache, layer),
        lambda: decode_attention.prefill_quantize_write_plain(k, v, *cache, layer), None,
        nbytes(k, v) + k.numel() * 2 + 2 * 4 * B_INT8 * PROMPT * H, 6.0 * k.numel(),
        flops_per_s=FP32_FLOPS_PER_S)
    results["prefill_quantize_write"].update(
        shape=[B_INT8, PROMPT, H, hd], kernel=kernels.kernel_attrs(*K7_ATTRS, 0),
        device_ms=device_ms_a_call(
            lambda: decode_attention.prefill_quantize_write(k, v, *cache, layer),
            "kv_quant_write_kernel"))

    # K8: one decode step of that layer over the cache K7 filled, ragged
    # write positions past the prompt. Rows at and after write_pos hold
    # noise that the kernel must not attend to.
    q = randn(B_INT8, 1, H, hd)
    kq, ks = decode_attention.quantize_kv_rows(randn(B_INT8, H, hd).float() + 0.25 * q[:, 0].float())
    vq, vs = decode_attention.quantize_kv_rows(randn(B_INT8, H, hd, scale=3.0))
    kq, vq = kq.reshape(B_INT8, H * hd), vq.reshape(B_INT8, H * hd)
    wp = PROMPT + (torch.arange(B_INT8, device=dev) * 5) % NEW_TOKENS
    sc = hd**-0.5
    # Two gates, both of which must hold. The kernel keeps its
    # probabilities, their value scales and the dequantized rows in fp32;
    # the plain version in bf16 (what a CPU tensor takes) rounds each of
    # them to bf16, which moves an output by up to two bf16 ulps: the
    # kernel is held to it within two ulps of a row's largest value,
    # 2^-6. Fed the same q as fp32 and rounded to bf16 once, as the
    # kernel's result is, the plain version and a correct kernel round two
    # nearly equal fp32 values, which can land one ulp apart and no more:
    # 2^-7 (`K8Case`).
    tol_bf16 = 2.0**-6
    k8 = K8Case(q, kq, ks, vq, vs, cache, wp, layer, sc)
    info = k8.gate("decode_attention_int8_fused_write", k8.run())
    # The split form (the last block of a (sample, head) merges the
    # others' partials) at the same shape, forced: its gates and its time.
    info["splits_2"] = k8.gate("decode_attention_int8_fused_write splits 2", k8.run(splits=2))
    hist = float(wp.sum())
    results["decode_attention_int8_fused_write"] = line = kernel_line(
        "decode_attention_int8_fused_write", info.pop("max_abs_err"), info, k8.run,
        lambda: decode_attention.decode_attention_int8_fused_write_plain(
            q, kq, ks, vq, vs, *cache, wp, layer, scale=sc),
        None, k8.bytes(), 4.0 * hist * H * hd, flops_per_s=FP32_FLOPS_PER_S)
    # The median and spread of five batches of timed launches, K8 and K22
    # (the read kernel, which attends the same rows once K8 has written
    # row write_pos) in turns on the same cache.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    line.update(k8.spread(), splits=decode_attention.fused_write_splits(B_INT8, H, maxS, sms),
                splits_2_ms=k8.spread(splits=2)["ms"],
                k22=k8.k22_spread(), shape=[L, B_INT8, maxS, H * hd],
                kernel=kernels.kernel_attrs(*K8_ATTRS, 0))
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
    # And the redesign's two riskiest places, each a copy of the source
    # built with the bug (`K8_MUTANTS`): the merge at two splits, the last
    # tile at the chosen one.
    caught = {"new_row_left_out": k8.err(left_out), "staleness_mask_off": k8.err(unmasked)}
    for bug, src_define in K8_MUTANTS.items():
        with kernels.mutant(*src_define):
            caught[bug] = k8.err(k8.run(splits=2 if bug == "merge_without_rescale" else None)[0])
    # Each mutant must fail both gates (tol_bf16 is the looser one).
    for m, e in caught.items():
        must_not("decode_attention_int8_fused_write", m, e <= tol_bf16, e)
    line["mutant_row_rel_err"] = caught
    log(f"[kernel] decode_attention_int8_fused_write mutants {json.dumps(caught)}")
    # The launch's fixed cost: the same grid with every write position 0,
    # one row (the new one) a sample.
    one_row = K8Case(q, kq, ks, vq, vs, cache, torch.zeros_like(wp), layer, sc)
    one_row.gate("decode_attention_int8_fused_write one row", one_row.run())
    line["one_row_a_sample"] = one_row.spread()
    del k8, one_row, cache, left_out, unmasked, prev
    torch.cuda.empty_cache()
    # The long caches draw from their own generator, so that the phases
    # after this one draw what they drew before these lines existed (K12's
    # chunk-scale gate is sensitive to its draw, PERF.md section 7).
    lgen = torch.Generator(device="cuda").manual_seed(14)
    line["maxS_2048"] = k8_long_cache_line(lgen, B_INT8, "maxS_2048")
    # A small batch over the same long cache, where the split fills the card.
    line["maxS_2048_b4"] = k8_long_cache_line(lgen, 4, "maxS_2048_b4")
    log(f"[kernel] decode_attention_int8_fused_write {json.dumps(line)}")
    return results


# The deliberate bugs of K12 on the wgmma + TMA int8 core
# (`int8_gemm_sm90.cuh`): fc1 quantizing by its own tile's row abs-max
# without the cluster's, and fc2 scaling a chunk by the next chunk's hs.
K12_MUTANTS = {
    "fc1_tile_amax": ("mlp_block_int8.cu", "ULLAVA_MUTANT_MLP_TILE_AMAX"),
    "fc2_next_chunk_scale": ("mlp_block_int8.cu", "ULLAVA_MUTANT_MLP_NEXT_CHUNK_SCALE"),
}
K12_ATTRS = ("mlp_block_int8.cu", "ullava_fused_mlp_block_int8_attrs")
# The deliberate bug of K10 on the wgmma + TMA int8 core: the residual pairs
# that a thread loads before its products taken from its other row.
K10_MUTANTS = {"residual_from_other_row": ("ln_linear_int8.cu", "ULLAVA_MUTANT_LINEAR_RESIDUAL_ROW")}
K10_ATTRS = ("ln_linear_int8.cu", "ullava_fused_ln_linear_int8_attrs")
# The GEMM kernels of `ln_linear_int8.cu` by the epilogue in their mangled
# names (K10's `LinearEpi`, K13's `DualLinearEpi`).
K10_GEMM, K13_GEMM = "9LinearEpi", "13DualLinearEpi"
# The rows of K12's three window-class launches a resident window block at
# B=16: 256 full windows of 200 rows, the edge pair, the corners.
RESIDENT_MLP_ROWS = (51200, 14336, 1024)


def sam_int8_kernel_phases(gen) -> dict:
    """The three kernels of the int8 SAM encoder path against their plain
    versions at the shapes of one B=16 ViT-H encode: 65536 token rows, C
    1280, F 5120, 256 (image, head) pairs over 4096 keys.

    Gates: bf16 outputs by `row_rel_err` within 1e-2 (one bf16 ulp of a
    row's largest value, plus what a flipped int8 step moves); the
    attention with bf16 exponentials within 2e-2, because its rounding
    depends on the running maximum and so on the key tiling; int8
    intermediates (the LN'd rows, the re-quantized GELU output) at least
    99.9% exact and the rest within 1; the LN'd rows' scales within rtol
    1e-5, the GELU output's chunk scales within rtol 1e-3 of those formed
    from the kernel's own int8 rows (a chunk's abs-max comes through the
    polynomial GELU of an fp32 product). Each gate must reject mutated runs
    that stand for typical bugs."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
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

    # K10's GEMM on the wgmma + TMA int8 core at shapes that are no
    # multiple of its 128 x 128 x 256 tile (ragged rows, columns and depth),
    # through `fused_linear` with a residual (the proj form's edge loads),
    # against an integer product spelled out on the CPU. Without a
    # LayerNorm the int8 rows must be bit-equal.
    odd = {}
    rgen = torch.Generator(device=dev).manual_seed(10)  # the draws after it stay as they were
    for rows, K, N in ((200, 96, 72), (129, 1280, 136), (1, 16, 8)):
        xo, (wq, ws), bias = randn(rows, K), weight(K, N), randn(N)
        res = torch.randn((rows, N), generator=rgen, device=dev).to(bf)
        got, xq, xs = mlp_kernel._ln_linear_cuda(xo, None, None, wq, ws, bias, 0.0, res)
        xq_ref, xs_ref = mlp_kernel._row_quant(xo)
        acc = (xq_ref.cpu().int() @ wq.cpu().int()).to(dev).float()
        ref = (acc * (xs_ref * ws) + bias.float() + res.float()).to(bf)
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
            for bug, src_define in K10_MUTANTS.items():
                with kernels.mutant(*src_define):
                    mutants[bug] = mlp_kernel._ln_linear_cuda(*args, res)[0]
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
        ops = 2.0 * T * C * N
        line.update(
            shape=[T, C, N], tops=ops / line["ms"] / 1e9,
            int8_peak_share=ops / line["ms"] / 1e9 / (INT8_OPS_PER_S / 1e12),
            gemm_int8_peak_share=ops / line["stage_ms"]["gemm"] / 1e9 / (INT8_OPS_PER_S / 1e12),
            # cuBLASLt's int8 GEMM alone on the product's operands (int32
            # out, no epilogue): a yardstick of the product, not of the function.
            int_mm_ms=time_ms(lambda xq=xq, wq=wq: torch._int_mm(xq, wq), 10))
        forms[form] = line
        del ref, got, xq, xs, xq_ref, xs_ref, res
    # The kernels line carries the LN+qkv form; the proj form rides in it.
    results["fused_ln_linear"] = {**forms["ln_qkv"],
                                  "gemm_core_odd_shapes_row_rel_err": odd, "proj_residual_form": {
        k: v for k, v in forms["proj_residual"].items()
        if k not in ("name", "route", "source", "replaces")}}
    results["fused_ln_linear"].update(
        sass=sass_counts("ln_linear_int8.cu", K10_GEMM, ("IGMMA", "UTMALDG", "IMMA")),
        kernel=kernels.kernel_attrs(*K10_ATTRS))
    log(f"[kernel] fused_ln_linear stages {json.dumps({k: v['stage_ms'] for k, v in forms.items()})} "
        f"int_mm {json.dumps({k: v['int_mm_ms'] for k, v in forms.items()})} "
        f"sass {json.dumps(results['fused_ln_linear']['sass'])} "
        f"kernel {json.dumps(results['fused_ln_linear']['kernel'])}")

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

    # The chunk scales' reference comes from the kernel's own int8 rows and
    # row scales, so that their 1e-3 limit measures the fc1 stage alone: an
    # xq code one step off (which the int8 gate allows) moves a chunk's
    # abs-max by up to about 2e-3.
    hs_own = fc1_chunk_scales(xq, xs, w1, s1, b1, 1024)

    def judge_mlp(out, hq_, hs_):
        ok_h, exact_h, worst_h = int8_gate(hq_, hq_ref)
        err, hs_err = row_rel_err(out, ref), max_rel_err(hs_, hs_own)
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
    # The new core's two riskiest places, each a copy of the source built
    # with the bug (`K12_MUTANTS`).
    for bug, src_define in K12_MUTANTS.items():
        with kernels.mutant(*src_define):
            bad = mlp_kernel._mlp_block_cuda(*args, 1024)
        torch.cuda.synchronize()
        info["mutants"][bug] = must_not("fused_mlp_block", bug, *judge_mlp(bad[0], bad[3], bad[4]))
        del bad

    results["fused_mlp_block"] = kernel_line(
        "fused_mlp_block", (got.float() - ref.float()).abs().max().item(), info,
        lambda: mlp_kernel._mlp_block_cuda(*args, 1024),
        lambda: mlp_kernel._mlp_block_parts_plain(*args, 1024, True),
        lambda: library_mlp(*args, 1024),
        nbytes(x, g, b, w1, s1, b1, w2, s2, b2, got), 4.0 * T * C * Fw, iters=10,
        flops_per_s=INT8_OPS_PER_S)
    results["fused_mlp_block"]["stage_ms"] = stage_ms(
        lambda bits: mlp_kernel._mlp_block_cuda(*args, 1024, stages=bits, scratch=(xq, xs, hq, hs)),
        {"row_pass": 1, "fc1": 2, "fc2": 4})
    results["fused_mlp_block"].update(
        shape=[T, C, Fw], sass=sass_counts("mlp_block_int8.cu", "gemm_sm90_kernel",
                                           ("IGMMA", "UTMALDG", "IMMA")),
        kernel={fc: kernels.kernel_attrs(*K12_ATTRS, i) for i, fc in ((1, "fc1"), (2, "fc2"))},
        # cuBLASLt's int8 GEMM alone on each product's operands (int32 out,
        # no epilogue): a yardstick of the products, not of the function.
        int_mm_ms={"fc1": time_ms(lambda: torch._int_mm(xq, w1), 10),
                   "fc2": time_ms(lambda: torch._int_mm(hq, w2), 10)},
        # The resident serve's window classes (a block's full windows, edge
        # pair and corners at B=16): the serve's K12 time by the kernel lines.
        resident_class_ms={str(n): time_ms(lambda n=n: mlp_kernel._mlp_block_cuda(
            x[:n], *args[1:], 1024), 10) for n in RESIDENT_MLP_ROWS})
    log(f"[kernel] fused_mlp_block stages {json.dumps(results['fused_mlp_block']['stage_ms'])} "
        f"int_mm {json.dumps(results['fused_mlp_block']['int_mm_ms'])}")
    del ref, got, xq, xs, hq, hs, xq_ref, xs_ref, hq_ref, hs_ref, hs_own, x, w1, w2
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
        for bug, src_define in GLOBAL_Y_MUTANTS.items():
            with kernels.mutant(*src_define):
                caught[bug] = row_rel_err(run(), ref)
        for m, e in caught.items():
            must_not(f"fused_global_attention_y {name}", m, e <= lim, e)
        flops = 4.0 * B_INT8 * H * S * S * hd
        ms = time_ms(run, 5)
        att[name] = {"row_rel_err": err, "tol": lim, "mutant_row_rel_err": caught,
                     "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                     "ms": ms, "tflops": flops / ms / 1e9}
        del got, ref
    del zero
    y5, mask = global_sdpa_inputs(y, a, bb)
    line = kernel_line(
        "fused_global_attention_y", att["exp_bf16"]["max_abs_err"],
        {k: v for k, v in att["exp_bf16"].items() if k not in ("ms", "max_abs_err", "tflops")},
        lambda: sam_attention.fused_global_attention_y(y, a, bb, **kw, exp_bf16=True),
        lambda: sam_attention.fused_global_attention_y_plain(y, a, bb, **kw, exp_bf16=True),
        lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=mask, scale=sc),
        nbytes(y, a, bb) + nbytes(y) // 3, flops, iters=5)
    line["tflops"] = flops / line["ms"] / 1e9
    line["exp_fp32_form"] = att["exp_fp32"]
    line["shape"] = [B_INT8, S, 3 * H * hd]
    line["sass"] = global_core_sass("sam_global_attention_y.cu")
    results["fused_global_attention_y"] = line
    log(f"[kernel] fused_global_attention_y exp_fp32 {json.dumps(att['exp_fp32'])}")
    del y5, mask, y, a, bb
    torch.cuda.empty_cache()
    return results


def fc1_chunk_scales(xq, xs, w1, s1, b1, f_chunk):
    """[rows, F / f_chunk] scales of fc1's GELU output by chunk, as
    `_mlp_block_parts_plain` forms them, but from the int8 rows `xq` and
    row scales `xs` given (a kernel's own), 8192 rows at a time."""
    import torch

    from ullava_tpu_torch.ops import mlp_kernel

    F = w1.shape[1]
    s1f = s1.reshape(1, F).float()
    out = []
    for r0 in range(0, xq.shape[0], 8192):
        h = mlp_kernel._fc1_gelu_plain(xq[r0:r0 + 8192], xs[r0:r0 + 8192], w1, s1f, b1)
        out.append(mlp_kernel._row_quant(h.reshape(-1, F // f_chunk, f_chunk))[1].reshape(
            -1, F // f_chunk))
    return torch.cat(out)


def library_mlp(x, g, b, w1, s1, b1, w2, s2, b2, eps, f_chunk):
    """The W8A8 MLP block as a chain of library calls (K12's and K23's
    yardstick): `F.layer_norm`, the row quantization, `torch._int_mm`,
    `F.gelu`, the per-chunk re-quantization and a `torch._int_mm` a chunk."""
    import torch
    import torch.nn.functional as F

    (T, C), Fw = x.shape, w1.shape[1]
    xf = F.layer_norm(x, (C,), g, b, eps).float()
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    xq_ = torch.round(xf * (127.0 / amax)).to(torch.int8)
    h = F.gelu(torch._int_mm(xq_, w1).float() * (amax * (1.0 / 127.0) * s1) + b1.float())
    h = h.reshape(T, Fw // f_chunk, f_chunk)
    hmax = h.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    hq_ = torch.round(h * (127.0 / hmax)).to(torch.int8)
    acc = torch.zeros((T, C), dtype=torch.float32, device=x.device)
    for k in range(Fw // f_chunk):
        acc += torch._int_mm(hq_[:, k].contiguous(), w2[k * f_chunk:(k + 1) * f_chunk]).float() * (
            hmax[:, k] * (1.0 / 127.0) * s2)
    return (acc + b2.float() + x.float()).to(x.dtype)


# The deliberate bugs the gate of the chunk-pipelined MLP (K23) must catch,
# each built into a copy of its source under the define: a block's chunk
# scale from its own partial row abs-max (without the cluster's), fc2
# folding a chunk by the previous chunk's hs, fc1's bias dropped, and a
# block's h slice written into each peer at that peer's column offset.
V2_MUTANTS = {
    "block_amax_only": ("mlp_block_v2_int8.cu", "ULLAVA_MUTANT_V2_BLOCK_AMAX"),
    "fc2_previous_chunk_scale": ("mlp_block_v2_int8.cu", "ULLAVA_MUTANT_V2_PREV_SCALE"),
    "fc1_bias_dropped": ("mlp_block_v2_int8.cu", "ULLAVA_MUTANT_V2_NO_FC1_BIAS"),
    "slice_at_peer_offset": ("mlp_block_v2_int8.cu", "ULLAVA_MUTANT_V2_PEER_OFFSET"),
}
V2_ATTRS = ("mlp_block_v2_int8.cu", "ullava_fused_mlp_block_v2_int8_attrs")
MICROBENCH_T = 150528  # `tools/microbench/mlp_variants.py`'s rows: half a B=48 interior tile


def bit_equal_share(a, b) -> float:
    """Share of the bf16 values of `a` and `b` whose bits agree (counted
    exactly: an fp32 mean of over 2^24 ones need not be 1)."""
    import torch

    return (a.view(torch.int16) == b.view(torch.int16)).sum().item() / a.numel()


def k12_phase_inputs(gen, T: int, C: int = 1280, Fw: int = 5120, eps: float = 1e-6) -> tuple:
    """The inputs of the W8A8 MLP's phase at T rows (`fused_mlp_block`'s
    arguments): fc1's int8 columns growing by chunk of 1024, x off-centre."""
    import torch

    from ullava_tpu_torch.ops import quant

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(
            torch.bfloat16)

    def weight(K, N, col_gain=None):
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
        leaf = quant.quantize_int8(w if col_gain is None else w * col_gain)
        return leaf["q"], leaf["scale"]

    gain = (1 + torch.arange(Fw, device="cuda") // 1024).float()
    w1, s1 = weight(C, Fw, col_gain=gain)
    w2, s2 = weight(Fw, C)
    x = randn(T, C, scale=2.0, shift=0.3)
    g, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
    b1, b2 = randn(Fw, scale=0.5), randn(C, scale=0.5)
    return (x, g, b, w1, s1, b1, w2, s2, b2, eps)


def mlp_v2_phase(gen, results: dict) -> dict:
    """The chunk-pipelined W8A8 MLP (`fused_mlp_block_v2`, K23), whose one
    caller is the MLP microbenchmark.

    1. At K12's phase shape and inputs (one B=16 ViT-H encode's 65536 rows,
       fc1's columns growing by chunk) and at 1000 rows (the last 64-row
       row tile ragged): K23 against its plain version with K12's gate,
       `row_rel_err` within 1e-2, at f_chunk 1024 and 512, and its bf16
       outputs bit-equal to K12's at the same f_chunk (share 1.0 required:
       the same roundings in the same order). The four mutants
       (`V2_MUTANTS`) must fail the gate at both f_chunks (the h exchange
       is a bulk copy at 1024 and 16-byte stores at 512). K23's time and K12's, K23's
       stages alone, its registers, shared bytes and blocks an SM at both
       f_chunks, and its SASS counts (`IGMMA`, `UTMALDG` > 0, `IMMA` 0).
    2. At the microbenchmark's shape and inputs ([150528, 1280] x 5120):
       the same gate and bit-equal share, and the `kernels` line row: ms
       (after the L2-evicting write), the bound at the int8 peak, the plain
       version's ms, the library chain's (`library_mlp`), K12's ms.
    3. The main path: the launch counts set to 0, the microbenchmark run
       once (`microbench.mlp_variants.main`, which prints its lines), the
       counts read: each variant launched only its own kernel, 2 + iters
       times, and the counts add up.
    Returns the microbenchmark's line (its counts and variant lines)."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench import mlp_variants
    from ullava_tpu_torch.ops import mlp_kernel

    dev, tol = "cuda", 1e-2
    T, C, Fw = B_INT8 * 4096, 1280, 5120

    def hold(where, args, f_chunk):
        """K23 against its plain version and K12: (info, out, plain out)."""
        got = mlp_kernel._mlp_block_v2_cuda(*args, f_chunk)[0]
        ref = mlp_kernel.fused_mlp_block_v2_plain(*args, f_chunk)
        k12 = mlp_kernel._mlp_block_cuda(*args, f_chunk)[0]
        torch.cuda.synchronize()
        err = row_rel_err(got, ref)
        info = {"row_rel_err": err, "tol": tol,
                "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                "bit_equal_share_vs_k12": bit_equal_share(got, k12),
                "k12_row_rel_err": row_rel_err(k12, ref)}
        must(f"fused_mlp_block_v2 {where} f_chunk {f_chunk}",
             err <= tol and bool(torch.isfinite(got.float()).all())
             and info["bit_equal_share_vs_k12"] == 1.0, info)
        return info, got, ref

    args = k12_phase_inputs(gen, T, C, Fw)
    ragged = (args[0][:1000].contiguous(), *args[1:])
    phase = {"ragged_1000_rows": hold("1000 rows", ragged, 1024)[0],
             "ragged_1000_rows_f512": hold("1000 rows", ragged, 512)[0]}
    del ragged
    refs = {}
    phase["f512"], _, refs[512] = hold("K12 shape", args, 512)
    info, got, refs[1024] = hold("K12 shape", args, 1024)
    phase["f1024"] = info
    mutants = {}
    for m, (src, define) in V2_MUTANTS.items():
        with kernels.mutant(src, define):
            for f_chunk, ref in refs.items():
                out = mlp_kernel._mlp_block_v2_cuda(*args, f_chunk)[0]
                torch.cuda.synchronize()
                err = row_rel_err(out, ref)
                mutants[f"{m}_f{f_chunk}"] = must_not(
                    "fused_mlp_block_v2", f"{m} f_chunk {f_chunk}", err <= tol, err)
    xq, xs = mlp_kernel._mlp_block_v2_cuda(*args, 1024)[1:]
    phase["ms"] = time_ms(lambda: mlp_kernel._mlp_block_v2_cuda(*args, 1024), 10)
    phase["k12_ms"] = time_ms(lambda: mlp_kernel._mlp_block_cuda(*args, 1024), 10)
    phase["stage_ms"] = stage_ms(
        lambda bits: mlp_kernel._mlp_block_v2_cuda(*args, 1024, stages=bits, scratch=(xq, xs)),
        {"row_pass": 1, "fc1": 2, "fc2": 4, "fc1_fc2": 6})
    phase["f512_ms"] = time_ms(lambda: mlp_kernel._mlp_block_v2_cuda(*args, 512), 10)
    phase["k12_f512_ms"] = time_ms(lambda: mlp_kernel._mlp_block_cuda(*args, 512), 10)
    phase["shape"] = [T, C, Fw]
    log(f"[kernel] fused_mlp_block_v2 at K12's shape {json.dumps(phase)}")
    del args, got, refs, ref, out, xq, xs
    torch.cuda.empty_cache()

    # The microbenchmark's shape and inputs.
    Tm = MICROBENCH_T
    margs = (*mlp_variants.inputs(Tm, C, Fw, dev), mlp_variants.EPS)
    minfo, got, ref = hold("microbenchmark shape", margs, 1024)
    minfo["f512"] = hold("microbenchmark shape", margs, 512)[0]
    xq, xs = mlp_kernel._mlp_block_v2_cuda(*margs, 1024)[1:]
    minfo["stage_ms"] = stage_ms(
        lambda bits: mlp_kernel._mlp_block_v2_cuda(*margs, 1024, stages=bits, scratch=(xq, xs)),
        {"row_pass": 1, "fc1": 2, "fc2": 4, "fc1_fc2": 6})
    k12_scratch = mlp_kernel._mlp_block_cuda(*margs, 1024)[1:]
    minfo["k12_stage_ms"] = stage_ms(
        lambda bits: mlp_kernel._mlp_block_cuda(*margs, 1024, stages=bits, scratch=k12_scratch),
        {"row_pass": 1, "fc1": 2, "fc2": 4})
    minfo["k12_ms"] = time_ms(lambda: mlp_kernel._mlp_block_cuda(*margs, 1024), 10)
    minfo["mutant_row_rel_err"] = mutants
    minfo["k12_shape"] = phase
    max_abs = minfo.pop("max_abs_err")
    line = kernel_line(
        "fused_mlp_block_v2", max_abs, minfo,
        lambda: mlp_kernel._mlp_block_v2_cuda(*margs, 1024),
        lambda: mlp_kernel.fused_mlp_block_v2_plain(*margs, 1024),
        lambda: library_mlp(*margs, 1024),
        nbytes(*margs[:-1], got), 4.0 * Tm * C * Fw, iters=10, flops_per_s=INT8_OPS_PER_S)
    line["shape"] = [Tm, C, Fw]
    line["f512_ms"] = time_ms(lambda: mlp_kernel._mlp_block_v2_cuda(*margs, 512), 10)
    line["kernel"] = {f"f{fc}": kernels.kernel_attrs(*V2_ATTRS, fc) for fc in (1024, 512)}
    line["sass"] = sass_counts("mlp_block_v2_int8.cu", "mlp_v2_kernel", ("IGMMA", "UTMALDG", "IMMA"))
    if line["sass"] != "not measured":
        must("fused_mlp_block_v2 SASS", line["sass"]["IGMMA"] > 0 and line["sass"]["UTMALDG"] > 0
             and line["sass"]["IMMA"] == 0, line["sass"])
    results["fused_mlp_block_v2"] = line
    log(f"[kernel] fused_mlp_block_v2 stages {json.dumps(minfo['stage_ms'])}; "
        f"K12 {json.dumps(minfo['k12_stage_ms'])}")
    del margs, got, ref, xq, xs, k12_scratch
    torch.cuda.empty_cache()

    # The main path: the microbenchmark, with the counts set to 0 before.
    kernels.reset_launch_counts()
    iters = 20
    variants = mlp_variants.main(iters=iters)
    launches = kernels.launch_counts()
    own = {"k12": "fused_mlp_block", "base": "fused_mlp_block", "v2": "fused_mlp_block_v2"}
    expect = {k: 0 for k in launches}
    skipped = []
    for v in variants:
        if "skipped" in v:
            skipped.append(v["variant"])
            continue
        name = own[v["variant"].split("_")[0]]
        must(f"microbenchmark {v['variant']} launches", v["launches"] == {name: iters + 2}, v)
        expect[name] += iters + 2
    must("microbenchmark launches", launches == expect and expect["fused_mlp_block_v2"] > 0,
         {"got": launches, "expected": expect})
    must("microbenchmark skips", skipped == ["k12_f2560", "k12_f5120", "v2_f2560", "v2_f5120"],
         skipped)
    return {"phase": "mlp_microbench", "launches": launches, "variants": variants}


# ViT-H's attention widths: C 1280, 16 heads of 80, 14 x 14 windows.
SAM_C, SAM_H, SAM_HD, SAM_W = 1280, 16, 80, 14
# The boundary classes of one B=16 window block: the right and bottom
# windows (14 x 8 and 8 x 14 tokens, 64 of each) in one dual-geometry
# launch, and the 16 corner windows of 8 x 8.
RECT_FORMS = (("edge_pair", [(14, 8), (8, 14)], B_INT8 * 4), ("corner", [(8, 8)], B_INT8))
# The deliberate bugs of the whole-window core (`window_whole.cuh`) that
# K3's and K14's gates must catch, beside the int8 forms' `I8_MUTANTS`:
# each thread's own partial row max in place of its quad's (K19's copy is
# in `PACKED_MUTANTS`), and K14's pad scores left out of the row sum.
QUAD_MAX_MUTANTS = {src: (src, "ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX")
                    for src in ("sam_window_attention.cu", "sam_rect_attention.cu")}
RECT_PAD_MUTANT = ("sam_rect_attention.cu", "ULLAVA_MUTANT_RECT_PAD_OUT_OF_SUM")
# The C entries that read the whole-window kernels' registers, shared
# bytes, spills and blocks an SM (`kernels.kernel_attrs`).
WINDOW_ATTRS = {"grid": ("sam_window_attention.cu", "ullava_window_attention_grid_attrs"),
                "rect": ("sam_rect_attention.cu", "ullava_window_attention_rect_attrs"),
                "packed": ("sam_packed_attention.cu", "ullava_window_attention_packed_attrs"),
                "head_major": ("sam_window_attention.cu", "ullava_fused_window_attention_attrs")}


def rect_attrs(dots_i8: bool, geoms) -> dict:
    """The boundary-window kernel's attributes for one form and geometry."""
    from ullava_tpu_torch import kernels

    first, second = geoms[0], geoms[-1]
    return kernels.kernel_attrs(*WINDOW_ATTRS["rect"], int(dots_i8), *first, *second)


def window_sdpa_inputs(y, a, bb, keys, key_ok, dims=(SAM_C, SAM_H, SAM_HD, SAM_W)):
    """The library yardstick of the window kernels (ViT-H's widths unless
    `dims` = (C, H, hd, W) says otherwise): head-major q of y [N, Sq, 3C]
    and the k, v of `keys` [N, Sk, 3C] with the reversed-column bias terms
    materialised as a [N, H, Sq, Sk] bf16 mask over the W x W logical key
    positions (-inf where `key_ok` [Sk] is False)."""
    import torch
    import torch.nn.functional as F

    C, H, hd, W = dims
    N, Sq, _ = y.shape
    q = y[:, :, :C].reshape(N, Sq, H, hd).transpose(1, 2).contiguous()
    k, v = (keys[:, :, i * C:(i + 1) * C].reshape(N, -1, H, hd).transpose(1, 2).contiguous()
            for i in (1, 2))
    A = a.reshape(N, Sq, H, W).flip(-1).permute(0, 2, 1, 3).float()
    Bm = bb.reshape(N, Sq, H, W).flip(-1).permute(0, 2, 1, 3).float()
    mask = (A[..., :, None] + Bm[..., None, :]).reshape(N, H, Sq, W * W) * hd**-0.5
    mask = F.pad(mask, (0, keys.shape[1] - W * W)).masked_fill(~key_ok, float("-inf"))
    return q, k, v, mask.to(torch.bfloat16)


def window_sdpa(q, k, v, mask):
    import torch.nn.functional as F

    N, H, Sq, hd = q.shape
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=hd**-0.5)
    return o.transpose(1, 2).reshape(N, Sq, H * hd)


def rect_case(gen, geoms, per, qkv_bias, dims=(SAM_C, SAM_H, SAM_HD, SAM_W)):
    """`per` boundary windows of each geometry of `geoms` (ViT-H widths
    unless `dims` = (C, H, hd, W) says otherwise): y, the bias terms, the
    encoder's own tables, the zero-padded windows the tables stand for
    ([N, W*W, 3C]) and which logical keys are real."""
    import torch

    from ullava_tpu_torch.models.sam import image_encoder

    C, H, hd, W = dims
    F1, bf = 3 * C, torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    rows, cols = geoms[0]
    N, T = per * len(geoms), rows * cols
    y = randn(N, T, F1)
    a, bb = (randn(N, T, H * W, scale=2.0 * hd**0.5) for _ in range(2))
    ohs = [image_encoder._rect_onehot(r, c, W, bf, "cuda") for r, c in geoms]
    pads = [image_encoder._pad_tables(qkv_bias, r, c, W, H, hd, bf) for r, c in geoms]
    tables = ((ohs[0], *pads[0]) if len(geoms) == 1 else
              (torch.stack(ohs), torch.stack([k for k, _ in pads]),
               torch.stack([v for _, v in pads])))
    # The zero-padded windows the tables stand for: qkv = qkv_bias at
    # every pad position, the real tokens scattered into their places.
    padded = qkv_bias.expand(N, W, W, F1).clone()
    is_real = torch.zeros((len(geoms), W, W), dtype=torch.bool, device="cuda")
    for i, (r, c) in enumerate(geoms):
        padded[i * per:(i + 1) * per, :r, :c] = y[i * per:(i + 1) * per].reshape(per, r, c, F1)
        is_real[i, :r, :c] = True
    return y, a, bb, tables, padded.reshape(N, W * W, F1), is_real.reshape(len(geoms), W * W)


# The deliberate bugs of K13's one launch on the wgmma + TMA int8 core
# (`int8_gemm_sm90.cuh`), each built into a copy of its source: the
# bias-term tiles reading W2 one tile over, and the bias-term columns
# scaled by W's scale.
K13_MUTANTS = {
    "bias_term_tiles_one_over": ("ln_linear_int8.cu", "ULLAVA_MUTANT_DUAL_TILE_OFFSET"),
    "bias_terms_by_w_scale": ("ln_linear_int8.cu", "ULLAVA_MUTANT_DUAL_W_SCALE"),
}
K13_ATTRS = ("ln_linear_int8.cu", "ullava_fused_ln_linear_dual_int8_attrs")


def resident_kernel_phases(gen, results: dict) -> None:
    """The kernels of the SAM encoder's resident window layout against
    their plain versions at the shapes of one B=16 ViT-H window block: 256
    full windows stored as 200 rows, 64 right and 64 bottom windows of 112
    tokens as one stream, 16 corner windows of 64. Adds K13's and K14's
    lines to `results` and K3's serving form to K3's line.

    Gates: bf16 outputs by `row_rel_err` within 1e-2 (the attention
    kernels over real query rows; K3's pad rows must be finite), K13's
    int8 rows at least 99.9% exact and the rest within 1. Each gate must
    reject mutated runs that stand for typical bugs (K13 also copies of its
    source built with `K13_MUTANTS`, K14 with `QUAD_MAX_MUTANTS` and
    `RECT_PAD_MUTANT`)."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import mlp_kernel, quant, sam_attention

    dev, bf = "cuda", torch.bfloat16
    tol, eps = 1e-2, 1e-6
    Bn, C, H, hd, W = B_INT8, SAM_C, SAM_H, SAM_HD, SAM_W
    R = 2 * W - 1
    F1, F2 = 3 * C, 2 * H * R
    sc = hd**-0.5
    kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc)

    def randn(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def weight(K, N):
        leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * 0.05)
        return leaf["q"], leaf["scale"]

    # K13: LN1 + qkv + the composite bias columns of each class tensor.
    g, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
    (wq, ws), (w2, s2) = weight(C, F1), weight(C, F2)
    bias, bias2 = randn(F1, scale=0.5), randn(F2, scale=0.5, dtype=torch.float32)
    wargs = (g, b, wq, ws, bias, w2, s2, bias2, eps)
    forms = {}
    for form, N, T, rows2 in (("full", Bn * 16, 200, 196), ("edge_pair", Bn * 8, 112, 112),
                              ("corner", Bn, 64, 64)):
        x = randn(N, T, C, scale=2.0, shift=0.3)
        ry, rp, rxq, rxs = mlp_kernel._ln_linear_dual_parts_plain(x, *wargs, True, rows2)
        y, p, xq, xs = mlp_kernel._ln_linear_dual_cuda(x, *wargs, rows2)
        torch.cuda.synchronize()
        ok, exact, worst = int8_gate(xq, rxq)
        info = {"row_rel_err": row_rel_err(y, ry), "row_rel_err_bias_terms": row_rel_err(p, rp),
                "tol": tol, "int8_exact_share": exact, "int8_max_diff": worst,
                "scale_rel_err": max_rel_err(xs, rxs)}
        must(f"fused_ln_linear_dual {form}", ok and info["row_rel_err"] <= tol
             and info["row_rel_err_bias_terms"] <= tol and info["scale_rel_err"] <= 1e-5, info)
        # Mutants. The second bias dropped; and, where rows are trimmed,
        # `rows2` ignored: the rows of all T, read as if they were packed;
        # and the one launch's two riskiest places, each a copy of the
        # source built with the bug (`K13_MUTANTS`).
        mutants = {"bias2_dropped": mlp_kernel._ln_linear_dual_cuda(
            x, *wargs[:7], torch.zeros_like(bias2), eps, rows2)[1]}
        if rows2 != T:
            untrimmed = mlp_kernel._ln_linear_dual_cuda(x, *wargs, T)[1]
            mutants["rows2_ignored"] = untrimmed.reshape(-1, F2)[:N * rows2].reshape(N, rows2, F2)
        for bug, src_define in K13_MUTANTS.items():
            with kernels.mutant(*src_define):
                mutants[bug] = mlp_kernel._ln_linear_dual_cuda(x, *wargs, rows2)[1]
        info["mutant_row_rel_err"] = {
            m: must_not(f"fused_ln_linear_dual {form}", m, row_rel_err(out, rp) <= tol,
                        row_rel_err(out, rp)) for m, out in mutants.items()}
        del mutants

        def library(x=x, rows2=rows2):
            xf = F.layer_norm(x, (C,), g, b, eps).float().reshape(-1, C)
            amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
            xq_ = torch.round(xf * (127.0 / amax)).to(torch.int8)
            xs_ = amax * (1.0 / 127.0)
            y_ = (torch._int_mm(xq_, wq).float() * (xs_ * ws) + bias.float()).to(bf)
            p_ = (torch._int_mm(xq_, w2).float() * (xs_ * s2) + bias2).to(bf)
            return y_.reshape(*x.shape[:2], F1), p_.reshape(*x.shape[:2], F2)[:, :rows2]

        line = kernel_line(
            "fused_ln_linear_dual",
            max((y.float() - ry.float()).abs().max().item(), (p.float() - rp.float()).abs().max().item()),
            info, lambda x=x, r=rows2: mlp_kernel._ln_linear_dual_cuda(x, *wargs, r),
            lambda x=x, r=rows2: mlp_kernel._ln_linear_dual_parts_plain(x, *wargs, True, r),
            library, nbytes(x, g, b, wq, ws, bias, w2, s2, bias2, y, p),
            2.0 * C * (N * T * F1 + N * rows2 * F2), iters=10, flops_per_s=INT8_OPS_PER_S)
        # Each stage alone on this call's scratch: the row pass, each column
        # range, and both in the one launch.
        line["stage_ms"] = {
            name: time_ms(lambda bits=bits, x=x, r=rows2, scr=(xq, xs): mlp_kernel._ln_linear_dual_cuda(
                x, *wargs, r, stages=bits, scratch=scr), 10)
            for name, bits in (("row_pass", 1), ("gemm_qkv", 2), ("gemm_bias_terms", 4), ("gemm", 6))}
        # cuBLASLt's int8 GEMM alone on each product's operands (int32 out,
        # no epilogue): a yardstick of the products, not of the function.
        xq2 = xq.reshape(-1, C)
        line["int_mm_ms"] = {"qkv": time_ms(lambda xq2=xq2: torch._int_mm(xq2, wq), 10),
                             "bias_terms": time_ms(lambda xq2=xq2: torch._int_mm(xq2, w2), 10)}
        line["shape"] = [N, T, C, F1, F2, rows2]
        # The median and spread of five batches (the corner's launches are
        # short enough for a stall of the host to move a mean of ten).
        line.update(spread_ms(lambda x=x, r=rows2: mlp_kernel._ln_linear_dual_cuda(x, *wargs, r),
                              iters=10))
        forms[form] = line
        del x, y, p, xq, xq2, xs, ry, rp, rxq, rxs
    # The kernels line carries the full class; the other two ride in it.
    results["fused_ln_linear_dual"] = {**forms["full"], **{
        f"{name}_form": {k: v for k, v in forms[name].items()
                         if k not in ("name", "route", "source", "replaces")}
        for name in ("edge_pair", "corner")}}
    results["fused_ln_linear_dual"].update(
        sass=sass_counts("ln_linear_int8.cu", K13_GEMM, ("IGMMA", "UTMALDG", "IMMA")),
        kernel=kernels.kernel_attrs(*K13_ATTRS))
    log(f"[kernel] fused_ln_linear_dual stages "
        f"{json.dumps({k: v['stage_ms'] for k, v in forms.items()})} int_mm "
        f"{json.dumps({k: v['int_mm_ms'] for k, v in forms.items()})}")
    torch.cuda.empty_cache()

    # K3's serving form: 256 windows stored as 200 rows, the last four of
    # each left out as keys. The pad rows of the bias terms are zero, as
    # `_assemble_bias_terms` makes them.
    N, S, real = Bn * 16, 200, W * W
    y = randn(N, S, F1)
    a, bb = (randn(N, S, H * W, scale=2.0 / sc) for _ in range(2))
    a[:, real:], bb[:, real:] = 0, 0
    run = lambda: sam_attention.fused_window_attention_grid(y, a, bb, **kw, total_rows=S)  # noqa: E731
    got = run()
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, H, hd, W, sc)
    torch.cuda.synchronize()
    err = row_rel_err(got[:, :real], ref[:, :real])
    finite = bool(torch.isfinite(got[:, real:]).all())
    must("fused_window_attention_grid total_rows", err <= tol and finite, (err, finite))
    is_real = torch.arange(S, device=dev) < real
    lib = window_sdpa_inputs(y, a, bb, y, is_real)
    # Mutants: the pad keys attended (the library chain with no key left
    # out), and the two bias terms swapped (through the kernel).
    caught = {
        "pad_key_mask_off": row_rel_err(
            window_sdpa(*lib[:3], lib[3].masked_fill(~is_real, 0.0))[:, :real], ref[:, :real]),
        "bias_swapped": row_rel_err(sam_attention.fused_window_attention_grid(
            y, bb, a, **kw, total_rows=S)[:, :real], ref[:, :real]),
    }
    for m, e in caught.items():
        must_not("fused_window_attention_grid total_rows", m, e <= tol, e)
    b_ms, b_by = bound_ms(nbytes(y, a, bb, got), 4.0 * N * H * S * real * hd)
    results["fused_window_attention_grid"]["total_rows_form"] = {
        "shape": [N, S, F1], "row_rel_err": err, "tol": tol, "pad_rows_finite": finite,
        "mutant_row_rel_err": caught,
        "max_abs_err": (got[:, :real].float() - ref[:, :real].float()).abs().max().item(),
        "ms": time_ms(run, 20),
        "plain_ms": time_ms(lambda: sam_attention.fused_window_attention_grid_plain(
            y, a, bb, H, hd, W, sc), 3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lambda: window_sdpa(*lib), 20)}
    log(f"[kernel] fused_window_attention_grid total_rows "
        f"{json.dumps(results['fused_window_attention_grid']['total_rows_form'])}")
    del y, a, bb, got, ref, lib
    torch.cuda.empty_cache()

    # K14: the right and bottom classes in one dual-geometry launch, and
    # the corner class; tables from the encoder's own helpers.
    qkv_bias = randn(F1, scale=0.5)
    rect_forms = {}
    for form, geoms, per in RECT_FORMS:
        y, a, bb, tables, padded, is_real = rect_case(gen, geoms, per, qkv_bias)
        geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
        run = lambda t=tables, g_=geometry: sam_attention.fused_window_attention_rect(  # noqa: E731
            y, a, bb, *t, **kw, geometry=g_)
        got = run()
        ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, H, hd, W, sc)
        torch.cuda.synchronize()
        err = row_rel_err(got, ref)
        must(f"fused_window_attention_rect {form}", err <= tol, err)
        every = torch.ones(W * W, dtype=torch.bool, device=dev)
        lib = window_sdpa_inputs(y, a, bb, padded, every)
        # Recorded, not gated: the library chain rounds each bias sum to
        # bf16 in its mask, which moves a logit of about 10 by up to 0.03.
        lib_err = row_rel_err(window_sdpa(*lib), ref)
        # Mutants: the pad keys dropped (a softmax over the real keys only,
        # through the library chain), the pad value dropped, and the two
        # halves' geometries swapped (both through the kernel).
        real_only = torch.cat([lib[3][i * per:(i + 1) * per].masked_fill(~is_real[i], float("-inf"))
                               for i in range(len(geoms))])
        caught = {
            "pad_keys_dropped": row_rel_err(window_sdpa(*lib[:3], real_only), ref),
            "pad_v_dropped": row_rel_err(run((*tables[:2], torch.zeros_like(tables[2]))), ref),
        }
        for bug, src_define in (("pad_out_of_sum", RECT_PAD_MUTANT),
                                ("quad_max_dropped", QUAD_MAX_MUTANTS["sam_rect_attention.cu"])):
            with kernels.mutant(*src_define):
                caught[bug] = row_rel_err(run(), ref)
        if len(geoms) == 2:
            caught["halves_swapped"] = row_rel_err(run(g_=(geoms[1], geoms[0])), ref)
        for m, e in caught.items():
            must_not(f"fused_window_attention_rect {form}", m, e <= tol, e)
        N, T = y.shape[:2]
        line = kernel_line(
            "fused_window_attention_rect", (got.float() - ref.float()).abs().max().item(),
            {"row_rel_err": err, "tol": tol, "padded_window_sdpa_row_rel_err": lib_err,
             "mutant_row_rel_err": caught},
            run, lambda t=tables: sam_attention.fused_window_attention_rect_plain(
                y, a, bb, *t, H, hd, W, sc),
            lambda l=lib: window_sdpa(*l), nbytes(y, a, bb, *tables, got), 4.0 * N * H * T * W * W * hd)
        line["shape"] = [N, T, F1]
        line["kernel"] = rect_attrs(False, geoms)
        rect_forms[form] = line
        del y, a, bb, tables, padded, got, ref, lib, real_only
    results["fused_window_attention_rect"] = {**rect_forms["edge_pair"], "corner_form": {
        k: v for k, v in rect_forms["corner"].items()
        if k not in ("name", "route", "source", "replaces")}}
    torch.cuda.empty_cache()


# The deliberate bug that the int8 score forms' gates must catch: each
# source with an int8 score form (K3's and K14's on the whole-window core,
# K11's on the global core) rebuilt so that every key of a K tile (a
# 16-key chunk on the whole-window core) is dequantized with its first
# key's scale.
I8_MUTANTS = {src: (src, "ULLAVA_MUTANT_I8_TILE_SCALE") for src in (
    "sam_window_attention.cu", "sam_global_attention_y.cu", "sam_rect_attention.cu")}
# The kernel forms the all-int8 serve adds (K11's int8 form as its
# pre-pass and its core).
I8_NAMES = ("fused_window_attention_grid_i8", "global_attention_y_quant_i8",
            "fused_global_attention_y_i8", "fused_window_attention_rect_i8",
            "flash_attention_fwd_bsh_hd64")
CLIP_TOKENS, CLIP_PADDED = 257, 264  # CLIP ViT-L/14's sequence, padded to a multiple of 8


# The deliberate bug of the global core (`global_sm90.cuh`) that only its
# 128-key tiles can hide: a tile spans two rows of the 64 x 64 key grid,
# and the copy takes the first row's A term for both.
GLOBAL_Y_MUTANTS = {
    "a_term_one_grid_row": ("sam_global_attention_y.cu", "ULLAVA_MUTANT_GLOBAL_A_ONE_ROW")}


def all_int8_kernel_phases(gen, results: dict) -> None:
    """The four kernel forms of the all-int8 serve against their plain
    versions at its shapes (B=16): the int8 score form (`dots_i8`) of the
    window kernel at one block-layout window block ([400, 196, 3840]) and
    in the resident layout's padded form ([256, 200, 3840], four rows a
    window left out as keys), of the lane-sliced global kernel at one
    global block ([16, 4096, 3840], both exponential forms), of the
    boundary kernel on the edge-pair and corner classes, and the flash
    forward at CLIP's head_dim 64 ([16, 264, 16, 64], kv_lens 257, not
    causal).

    Gates as for the bf16 forms: `row_rel_err` within 1e-2 over the real
    query rows (both sides quantize with the same arithmetic; only the
    order of fp32 operations differs), 2e-2 for the bf16 exponentials.
    Each gate must reject mutated runs: the kernel source rebuilt to use
    one key scale for a whole K tile (`I8_MUTANTS`), K11's also with the
    A term of a 128-key tile's first grid row used for both halves
    (`GLOBAL_Y_MUTANTS`), K14's with its pad scores out of the row sum
    (`RECT_PAD_MUTANT`), the bias terms swapped, the pad value dropped,
    K2's kv_lens ignored. K11's pre-pass is held bit for bit and must see
    the bias terms swapped. Bounds: qk at
    the int8 peak and P V at the bf16 peak, or the bytes. The library
    yardsticks: SDPA with the bias materialised as a mask (bf16 scores),
    and for K2 SDPA with a key-padding mask."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import attention, sam_attention

    dev, bf, tol = "cuda", torch.bfloat16, 1e-2
    C, H, hd, W = SAM_C, SAM_H, SAM_HD, SAM_W
    F1, sc, real = 3 * C, hd**-0.5, W * W
    kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def gate(name, got, ref, mutants, lim=tol, rows=slice(None)):
        err = row_rel_err(got[:, rows], ref[:, rows])
        must(name, err <= lim, err)
        caught = {m: row_rel_err(out[:, rows], ref[:, rows]) for m, out in mutants.items()}
        for m, e in caught.items():
            must_not(name, m, e <= lim, e)
        return {"row_rel_err": err, "tol": lim, "mutant_row_rel_err": caught}

    def max_abs(got, ref, rows=slice(None)):
        return (got[:, rows].float() - ref[:, rows].float()).abs().max().item()

    # K3: one window block in the block layout (400 windows of 196) and in
    # the resident layout (256 windows stored as 200 rows, the pad rows of
    # the bias terms zero as `_assemble_bias_terms` makes them).
    name, src = "fused_window_attention_grid_i8", "sam_window_attention.cu"
    forms = {}
    for form, N, S in (("block", B_INT8 * 25, real), ("total_rows", B_INT8 * 16, 200)):
        y = randn(N, S, F1)
        a, bb = (randn(N, S, H * W, scale=2.0 / sc) for _ in range(2))
        a[:, real:], bb[:, real:] = 0, 0
        tr = S if S != real else 0
        run = lambda a_=a, b_=bb, y=y, tr=tr: sam_attention.fused_window_attention_grid(  # noqa: E731
            y, a_, b_, **kw, total_rows=tr, dots_i8=True)
        plain = lambda y=y, a=a, bb=bb: sam_attention.fused_window_attention_grid_plain(  # noqa: E731
            y, a, bb, H, hd, W, sc, dots_i8=True)
        got, ref = run(), plain()
        with kernels.mutant(*I8_MUTANTS[src]):
            tile_scale = run()
        torch.cuda.synchronize()
        info = gate(f"{name} {form}", got, ref, {"one_key_scale_a_tile": tile_scale,
                                                 "bias_swapped": run(bb, a)}, rows=slice(0, real))
        info["pad_rows_finite"] = bool(torch.isfinite(got).all())
        must(f"{name} {form}", info["pad_rows_finite"], "non-finite rows")
        lib = window_sdpa_inputs(y, a, bb, y, torch.arange(S, device=dev) < real)
        forms[form] = kernel_line(
            name, max_abs(got, ref, slice(0, real)), info, run, plain,
            lambda l=lib: window_sdpa(*l), nbytes(y, a, bb, got), 4.0 * N * H * S * real * hd,
            bound=bound_i8_ms(nbytes(y, a, bb, got), 4.0 * N * H * S * real * hd))
        forms[form]["shape"] = [N, S, F1]
        forms[form]["kernel"] = kernels.kernel_attrs(*WINDOW_ATTRS["grid"], 1)
        del y, a, bb, got, ref, tile_scale, lib
        torch.cuda.empty_cache()
    results[name] = {**forms["block"], "total_rows_form": {
        k: v for k, v in forms["total_rows"].items() if k not in ("name", "route", "source", "replaces")}}

    # K11: one global block, both exponential forms; the kernels line
    # carries the serving form (bf16 exponentials, `mlp_w8a8`). Its time is
    # the pre-pass's and the core's; the pre-pass has a line of its own.
    name, src, Wg = "fused_global_attention_y_i8", "sam_global_attention_y.cu", 64
    S = Wg * Wg
    y = randn(B_INT8, S, F1)
    a, bb = (randn(B_INT8, S, H, Wg, scale=2.0 / sc) for _ in range(2))
    gkw = dict(num_heads=H, head_dim=hd, window=Wg, scale=sc, dots_i8=True)
    flops = 4.0 * B_INT8 * H * S * S * hd
    att = {}
    for exp_bf16 in (True, False):
        run = lambda a_=a, b_=bb, e=exp_bf16: sam_attention.fused_global_attention_y(  # noqa: E731
            y, a_, b_, **gkw, exp_bf16=e)
        got = run()
        ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **gkw, exp_bf16=exp_bf16)
        bugs = {}
        for bug, src_define in (("one_key_scale_a_tile", I8_MUTANTS[src]),
                                *GLOBAL_Y_MUTANTS.items()):
            with kernels.mutant(*src_define):
                bugs[bug] = run()
        torch.cuda.synchronize()
        form = "exp_bf16" if exp_bf16 else "exp_fp32"
        att[form] = gate(f"{name} {form}", got, ref, {**bugs, "bias_swapped": run(bb, a)},
                         lim=2e-2 if exp_bf16 else tol)
        att[form]["max_abs_err"] = max_abs(got, ref)
        att[form]["ms"] = time_ms(run, 5)
        att[form]["tflops"] = flops / att[form]["ms"] / 1e9
        del got, ref, bugs
    # The pre-pass alone: codes, scales and the [A | B] codes bit for bit.
    pre, pre_name = sam_attention.global_y_quant_i8(y, a, bb, H, hd), "global_attention_y_quant_i8"
    pre_ref = sam_attention.global_y_quant_i8_plain(y, a, bb, H, hd)
    exact = [bool(torch.equal(g, r)) for g, r in zip(pre, pre_ref)]
    must(pre_name, all(exact), exact)
    swapped = sam_attention.global_y_quant_i8(y, bb, a, H, hd)
    caught = not (torch.equal(swapped[2], pre_ref[2]) and torch.equal(swapped[3], pre_ref[3]))
    must_not(pre_name, "bias_swapped", not caught, caught)
    pre_io = nbytes(y) * 2 // 3 + nbytes(a, bb, *pre)
    results[pre_name] = kernel_line(
        pre_name, max(float((g.float() - r.float()).abs().max()) for g, r in zip(pre, pre_ref)),
        {"bit_equal": exact, "mutant_bit_equal": {"bias_swapped": not caught}},
        lambda: sam_attention.global_y_quant_i8(y, a, bb, H, hd),
        lambda: sam_attention.global_y_quant_i8_plain(y, a, bb, H, hd), None, pre_io, 0.0,
        iters=10)
    results[pre_name]["shape"] = [B_INT8, S, F1]
    del pre, pre_ref, swapped
    y5, mask = global_sdpa_inputs(y, a, bb)
    line = kernel_line(
        name, att["exp_bf16"].pop("max_abs_err"),
        {k: v for k, v in att["exp_bf16"].items() if k not in ("ms", "tflops")},
        lambda: sam_attention.fused_global_attention_y(y, a, bb, **gkw, exp_bf16=True),
        lambda: sam_attention.fused_global_attention_y_plain(y, a, bb, **gkw, exp_bf16=True),
        lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=mask, scale=sc),
        nbytes(y, a, bb) + nbytes(y) // 3, flops, iters=5,
        bound=bound_i8_ms(nbytes(y, a, bb) + nbytes(y) // 3, flops))
    line["tflops"] = flops / line["ms"] / 1e9
    line["pre_pass_ms"] = results[pre_name]["ms"]
    line["exp_fp32_form"] = att["exp_fp32"]
    line["shape"] = [B_INT8, S, F1]
    line["sass"] = global_core_sass(src)
    results[name] = line
    del y5, mask, y, a, bb
    torch.cuda.empty_cache()

    # K14: the right and bottom classes in one dual-geometry launch, and
    # the corner class.
    name, src = "fused_window_attention_rect_i8", "sam_rect_attention.cu"
    qkv_bias = randn(F1, scale=0.5)
    rect_forms = {}
    for form, geoms, per in RECT_FORMS:
        y, a, bb, tables, padded, _ = rect_case(gen, geoms, per, qkv_bias)
        geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
        run = lambda t=tables, g_=geometry, y=y, a=a, bb=bb: (  # noqa: E731
            sam_attention.fused_window_attention_rect(y, a, bb, *t, **kw, dots_i8=True, geometry=g_))
        plain = lambda t=tables, y=y, a=a, bb=bb: sam_attention.fused_window_attention_rect_plain(  # noqa: E731
            y, a, bb, *t, H, hd, W, sc, dots_i8=True)
        got, ref = run(), plain()
        with kernels.mutant(*I8_MUTANTS[src]):
            tile_scale = run()
        with kernels.mutant(*RECT_PAD_MUTANT):
            pad_out_of_sum = run()
        torch.cuda.synchronize()
        info = gate(f"{name} {form}", got, ref, {
            "one_key_scale_a_tile": tile_scale, "pad_out_of_sum": pad_out_of_sum,
            "pad_v_dropped": run((*tables[:2], torch.zeros_like(tables[2])))})
        lib = window_sdpa_inputs(y, a, bb, padded, torch.ones(real, dtype=torch.bool, device=dev))
        N, T = y.shape[:2]
        io, flops = nbytes(y, a, bb, *tables, got), 4.0 * N * H * T * real * hd
        rect_forms[form] = kernel_line(name, max_abs(got, ref), info, run, plain,
                                       lambda l=lib: window_sdpa(*l), io, flops,
                                       bound=bound_i8_ms(io, flops))
        rect_forms[form]["shape"] = [N, T, F1]
        rect_forms[form]["kernel"] = rect_attrs(True, geoms)
        del y, a, bb, tables, padded, got, ref, tile_scale, pad_out_of_sum, lib
    results[name] = {**rect_forms["edge_pair"], "corner_form": {
        k: v for k, v in rect_forms["corner"].items()
        if k not in ("name", "route", "source", "replaces")}}
    torch.cuda.empty_cache()

    # K2 at head_dim 64: one CLIP ViT-L/14 layer, 257 tokens padded to 264.
    name, Hc, hdc = "flash_attention_fwd_bsh_hd64", 16, 64
    q, k, v = (randn(B_INT8, CLIP_PADDED, Hc, hdc) for _ in range(3))
    lens = torch.full((B_INT8,), CLIP_TOKENS, dtype=torch.int32, device=dev)
    run = lambda l=lens: attention.flash_attention_fwd_bsh(  # noqa: E731
        q, k, v, l, causal=False, scale=hdc**-0.5)
    got = run()
    ref = attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=False, scale=hdc**-0.5)
    with kernels.mutant(*K2_MUTANTS["kv_edge_at_tile_end"]):
        kv_edge = run()
    info = gate(name, got, ref, {"kv_lens_ignored": run(torch.full_like(lens, CLIP_PADDED)),
                                 "kv_edge_at_tile_end": kv_edge})
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    key_ok = (torch.arange(CLIP_PADDED, device=dev) < CLIP_TOKENS)[None, None, None, :]
    results[name] = kernel_line(
        name, max_abs(got, ref), info, run,
        lambda: attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=False,
                                                        scale=hdc**-0.5),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_ok, scale=hdc**-0.5),
        nbytes(q, lens, got) + live_bytes(lens.tolist(), k, v),
        4.0 * B_INT8 * Hc * CLIP_PADDED * CLIP_TOKENS * hdc)
    results[name].update(shape=[B_INT8, CLIP_PADDED, Hc, hdc], sass=k2_sass(),
                         kernel=kernels.kernel_attrs(*K2_ATTRS, hdc))
    del q, k, v, qt, kt, vt, got, ref, kv_edge
    torch.cuda.empty_cache()


# The stage-2 batch: B=4 images, so the SAM encode of one stage-2 step has
# 16384 global-block tokens and 64 full, 32 edge and 4 corner windows.
B_STAGE2, S_STAGE2 = 4, 512
# The deliberate bugs that the weight-only gates must catch, each built
# into a copy of both weight-only sources (`bf16_wq_gemm_sm90.cuh`, the core
# of K10, K12 and K13): the int8 weight widened as unsigned bytes, the
# widening's bias constant one code off and the transposed epilogue's scale
# indexed by token; and in K13's source alone W2's row-mapped tiles stored
# with the window of the tile's first row only.
WQ_SOURCES = ("ln_linear_wq.cu", "mlp_block_wq.cu")
WQ_MUTANTS = {src: (src, "ULLAVA_MUTANT_WQ_UNSIGNED") for src in WQ_SOURCES}
WQ_WIDEN_MUTANTS = {src: (src, "ULLAVA_MUTANT_WQ_BIAS_OFF_BY_ONE") for src in WQ_SOURCES}
WQ_EPILOGUE_MUTANTS = {src: (src, "ULLAVA_MUTANT_WQ_SCALE_BY_TOKEN") for src in WQ_SOURCES}
WQ_DUAL_MUTANT = ("ln_linear_wq.cu", "ULLAVA_MUTANT_WQ_DUAL_FIRST_WINDOW")
WQ_NAMES = ("fused_ln_linear_wq", "fused_ln_linear_dual_wq", "fused_mlp_block_wq")
# The GEMM kernels of the wgmma + TMA core by their namespace (K12's two
# forms) or form (K10's `LinearForm` and K13's `DualForm`, which share
# ln_linear_wq.cu's library), and the entries that read their registers
# and shared bytes.
WQ_SM90_GEMM = "wq_sm90"
K10_WQ_FORM, K13_WQ_FORM = "LinearForm", "DualForm"
K10_WQ_ATTRS = ("ln_linear_wq.cu", "ullava_fused_ln_linear_wq_attrs")
K12_WQ_ATTRS = ("mlp_block_wq.cu", "ullava_fused_mlp_block_wq_attrs")
K13_WQ_ATTRS = ("ln_linear_wq.cu", "ullava_fused_ln_linear_dual_wq_attrs")
# The rows of a stage-2 encode's (B=4) classes: full windows (64 x 196),
# the merged right and bottom pair (32 x 112), the corners (4 x 64), the
# global blocks.
STAGE2_CLASS_ROWS = (12544, 3584, 256, 16384)


def wq_exact_widening(gen, define=None) -> dict:
    """Both weight-only sources' GEMM (`define` None: as built; else the
    copy built with that mutant) on x = the identity [256, 256] against an
    int8 weight that holds every one of the 256 codes in every column (code
    (k + 3 n) mod 256 - 128 at [k, n]), power-of-two channel scales and
    small bf16 biases: y[m, n] must be bf16(code[m, n] * s[n] + b[n]) bit
    for bit, a product of one live term that is exact in fp32. K10 through
    `fused_linear`, K12 through its fc2 stage alone (h the identity, x zero).
    {source: share of outputs bit-equal}."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import mlp_kernel, quant

    n, dev, bf = 256, "cuda", torch.bfloat16
    k = torch.arange(n, device=dev)
    codes = ((k[:, None] + 3 * k[None, :]) % 256 - 128).to(torch.int8)  # [K, N]
    wq = quant.column_major(codes)
    ws = torch.exp2(-torch.randint(4, 12, (n,), generator=gen, device=dev).float())
    bias = (torch.randn(n, generator=gen, device=dev) * 0.25).to(bf)
    eye = torch.eye(n, device=dev, dtype=bf)
    ref = (codes.float() * ws + bias.float()).to(bf)
    ones, zeros = torch.ones(n, device=dev, dtype=bf), torch.zeros(n, device=dev, dtype=bf)
    out = {}
    for src in WQ_SOURCES:
        with kernels.mutant(src, define) if define else contextlib.nullcontext():
            if src == "ln_linear_wq.cu":
                got = mlp_kernel._ln_linear_wq_cuda(eye, None, None, wq, ws, bias, 0.0, None)[0]
            else:
                x0 = torch.zeros((n, n), device=dev, dtype=bf)
                got = mlp_kernel._mlp_block_wq_cuda(
                    x0, ones, zeros, wq, ws, bias, wq, ws, bias, 1e-6, stages=4,
                    scratch=(torch.empty_like(x0), eye))[0]
        torch.cuda.synchronize()
        out[src] = (got.view(torch.int16) == ref.view(torch.int16)).float().mean().item()
    return out


def weight_only_kernel_phases(gen, results: dict) -> None:
    """The weight-only (`w8a8=False`) forms of K10, K13 and K12 against
    their plain versions at the shapes of one B=4 ViT-H encode: 16384
    global-block rows, C 1280, F 5120; K13 on the full (64 windows stored
    as 200 rows, 196 with bias terms), edge-pair (32 x 112) and corner (4 x
    64) classes. All three run on the wgmma + TMA bf16 x int8-weight core.

    Gate: bf16 outputs (and the LN'd bf16 rows, and K12's bf16 GELU
    output) by `row_rel_err` within 1e-2, one bf16 ulp of a row's largest
    value: both sides take the same bf16 operands and fp32 sums in other
    orders. Each gate must reject mutated runs: the weight scale applied
    per tensor, the LN bias, the residual, fc1's bias or the second bias
    dropped, `rows2` ignored, and the kernel source rebuilt with the int8
    weight widened as unsigned bytes (`WQ_MUTANTS`), with the core's
    transposed epilogue scaling by token (`WQ_EPILOGUE_MUTANTS`), and with
    its widening's bias constant one code off (`WQ_WIDEN_MUTANTS`: K12,
    K10's proj form and K13's bias terms, whose inputs have a mean that
    the shifted codes meet; K10's LN'd rows have almost none, so K13's LN
    bias is given a mean of 0.5); K13's bias terms also with W2's
    row-mapped tiles stored at the window of the tile's first row only
    (`WQ_DUAL_MUTANT`). First the exact-widening check
    (`wq_exact_widening`), which every widening mutant must fail. Bounds:
    the bf16 peak for the products, HBM for the int8 weights and the
    activations. The library chain: `F.layer_norm`, `w_q.to(bf16)`,
    `torch.matmul`, then scale and bias; `bf16_gemm_ms` is `torch.matmul`
    alone on the weight widened once outside the timer (the product alone,
    a yardstick the port never calls). The lines carry their SASS counts,
    registers, TFLOP/s and stage times; K10's and K12's also times at the
    stage-2 encode's class rows; K13's the kernels of one call by the
    profiler (one row pass and one GEMM launch)."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import mlp_kernel, quant

    dev, bf = "cuda", torch.bfloat16
    tol, eps = 1e-2, 1e-6
    T, C, Fw, H, W = B_STAGE2 * 4096, 1280, 5120, 16, 14
    F1, F2 = 3 * C, 2 * H * (2 * W - 1)

    def randn(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def weight(K, N):
        leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * 0.05)
        return leaf["q"], leaf["scale"]

    def gate(name, info, mutants, ref):
        must(name, all(v <= tol for k, v in info.items() if k.endswith("row_rel_err")), info)
        info["mutant_row_rel_err"] = {
            m: must_not(name, m, row_rel_err(out, ref) <= tol, row_rel_err(out, ref))
            for m, out in mutants.items()}
        info["tol"] = tol

    def lin_chain(xn, wq, ws, bias):  # the library yardstick's product, scale and bias
        return torch.matmul(xn, wq.to(bf)).float() * ws + bias.float()

    # The widening on all 256 codes, bit for bit, as built and in each
    # widening mutant (which must not be bit-equal). Its own generator: the
    # phases after it draw from `gen` what they drew before it existed.
    egen = torch.Generator(device=dev).manual_seed(18)
    exact = wq_exact_widening(egen)
    must("weight-only exact widening", all(v == 1.0 for v in exact.values()), exact)
    exact_mutants = {}
    for bug, table in (("weight_widened_unsigned", WQ_MUTANTS),
                       ("widen_bias_off_by_one", WQ_WIDEN_MUTANTS)):
        shares = wq_exact_widening(egen, table["ln_linear_wq.cu"][1])
        for src, share in shares.items():
            exact_mutants[f"{bug} {src}"] = must_not(
                "weight-only exact widening", f"{bug} {src}", share == 1.0, share)
    log(f"[kernel] weight-only exact widening {json.dumps(exact)} mutants {json.dumps(exact_mutants)}")

    x = randn(T, C, scale=2.0, shift=0.3)
    g, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)

    # K10: LN1 + qkv, and proj + residual, of the global blocks.
    forms = {}
    for form, N, ln in (("ln_qkv", F1, True), ("proj_residual", C, False)):
        wq, ws = weight(C, N)
        bias = randn(N, scale=0.5)
        res = None if ln else randn(T, N)
        lg, lb = (g, b) if ln else (None, None)
        args = (x, lg, lb, wq, ws, bias, eps)
        ref = mlp_kernel._ln_linear_parts_plain(*args, False, res)[0]
        got, xn = mlp_kernel._ln_linear_wq_cuda(*args, res)
        torch.cuda.synchronize()
        info = {"row_rel_err": row_rel_err(got, ref)}
        if ln:
            info["ln_rows_row_rel_err"] = row_rel_err(xn, mlp_kernel._ln_f32(x.float(), g, b, eps).to(bf))
        mutants = {"per_tensor_scale": mlp_kernel._ln_linear_wq_cuda(
            x, lg, lb, wq, ws.mean().expand_as(ws).contiguous(), bias, eps, res)[0]}
        if ln:
            mutants["ln_bias_dropped"] = mlp_kernel._ln_linear_wq_cuda(
                x, lg, torch.zeros_like(lb), wq, ws, bias, eps, res)[0]
        else:
            mutants["residual_dropped"] = mlp_kernel._ln_linear_wq_cuda(*args, None)[0]
        tables = {"weight_widened_unsigned": WQ_MUTANTS, "scale_by_token": WQ_EPILOGUE_MUTANTS}
        if not ln:
            tables["widen_bias_off_by_one"] = WQ_WIDEN_MUTANTS
        for bug, table in tables.items():
            with kernels.mutant(*table["ln_linear_wq.cu"]):
                mutants[bug] = mlp_kernel._ln_linear_wq_cuda(*args, res)[0]
        gate(f"fused_ln_linear_wq {form}", info, mutants, ref)
        del mutants

        def library(lg=lg, lb=lb, wq=wq, ws=ws, bias=bias, res=res):
            xn_ = F.layer_norm(x, (C,), lg, lb, eps) if lg is not None else x
            y = lin_chain(xn_, wq, ws, bias)
            return (y if res is None else y + res.float()).to(bf)

        in_out = nbytes(x, wq, ws, bias, got) + (nbytes(g, b) if ln else nbytes(res))
        flops = 2.0 * T * C * N
        line = kernel_line(
            "fused_ln_linear_wq", (got.float() - ref.float()).abs().max().item(), info,
            lambda a=args, r=res: mlp_kernel._ln_linear_wq_cuda(*a, r),
            lambda a=args, r=res: mlp_kernel._ln_linear_parts_plain(*a, False, r),
            library, in_out, flops, iters=10)
        if ln:
            line["stage_ms"] = stage_ms(lambda bits, a=args, sc=xn: mlp_kernel._ln_linear_wq_cuda(
                *a, None, stages=bits, scratch=sc), {"row_pass": 1, "gemm": 2})
        else:  # no row pass: the function is the product
            line["stage_ms"] = {"gemm": line["ms"]}
        w_bf = wq.to(bf)  # widened once, outside the timer
        line.update(
            shape=[T, C, N], tflops=flops / line["ms"] / 1e9,
            gemm_tflops=flops / line["stage_ms"]["gemm"] / 1e9,
            bf16_peak_share=flops / line["stage_ms"]["gemm"] / 1e9 / (BF16_FLOPS_PER_S / 1e12),
            bf16_gemm_ms=time_ms(lambda a=(xn if ln else x), w=w_bf: torch.matmul(a, w), 10),
            class_rows_ms={str(n): time_ms(lambda n=n, a=args, r=res: mlp_kernel._ln_linear_wq_cuda(
                x[:n], *a[1:], None if r is None else r[:n]), 10) for n in STAGE2_CLASS_ROWS})
        forms[form] = line
        del ref, got, xn, res, w_bf
    results["fused_ln_linear_wq"] = {**forms["ln_qkv"], "proj_residual_form": {
        k: v for k, v in forms["proj_residual"].items()
        if k not in ("name", "route", "source", "replaces")}}
    results["fused_ln_linear_wq"].update(
        exact_widening_share=exact, exact_widening_mutant_share=exact_mutants,
        sass=sass_counts("ln_linear_wq.cu", K10_WQ_FORM, ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")),
        kernel=kernels.kernel_attrs(*K10_WQ_ATTRS))
    wq_sass(results["fused_ln_linear_wq"]["sass"], "fused_ln_linear_wq")
    log(f"[kernel] fused_ln_linear_wq stages {json.dumps({k: v['stage_ms'] for k, v in forms.items()})} "
        f"classes {json.dumps({k: v['class_rows_ms'] for k, v in forms.items()})} "
        f"sass {json.dumps(results['fused_ln_linear_wq']['sass'])} "
        f"kernel {json.dumps(results['fused_ln_linear_wq']['kernel'])}")
    torch.cuda.empty_cache()

    # K13: LN1 + qkv + the composite bias columns of each class tensor,
    # both products in one launch. Its LN bias has a mean of 0.5, so that
    # the LN'd rows do too and the widening mutant one code off shows.
    (wq, ws), (w2, s2) = weight(C, F1), weight(C, F2)
    bias, bias2 = randn(F1, scale=0.5), randn(F2, scale=0.5, dtype=torch.float32)
    b13 = (b.float() + 0.5).to(bf)
    wargs = (g, b13, wq, ws, bias, w2, s2, bias2, eps)
    forms = {}
    for form, N, Tw, rows2 in (("full", B_STAGE2 * 16, 200, 196), ("edge_pair", B_STAGE2 * 8, 112, 112),
                               ("corner", B_STAGE2, 64, 64)):
        xw = randn(N, Tw, C, scale=2.0, shift=0.3)
        ry, rp = mlp_kernel._ln_linear_dual_parts_plain(xw, *wargs, False, rows2)[:2]
        run = lambda xw=xw, r=rows2, out=None: mlp_kernel._ln_linear_dual_wq_cuda(  # noqa: E731
            xw, *wargs, r, out=out)
        # The gated runs write into outputs filled with 1e4 first, so that a
        # row the kernel leaves unwritten fails, whatever the allocator
        # hands out (a freed block of the plain version's can hold its rows).
        poisoned = lambda: tuple(  # noqa: E731
            torch.full(t.shape, 1e4, dtype=bf, device=dev) for t in (ry, rp))
        y, p, xn = run(out=poisoned())
        torch.cuda.synchronize()
        info = {"row_rel_err": row_rel_err(y, ry), "bias_terms_row_rel_err": row_rel_err(p, rp)}
        mutants = {"bias2_dropped": mlp_kernel._ln_linear_dual_wq_cuda(
            xw, *wargs[:7], torch.zeros_like(bias2), eps, rows2)[1]}
        if rows2 != Tw:
            untrimmed = mlp_kernel._ln_linear_dual_wq_cuda(xw, *wargs, Tw)[1]
            mutants["rows2_ignored"] = untrimmed.reshape(-1, F2)[:N * rows2].reshape(N, rows2, F2)
        qkv_mutants = {}
        for bug, src_define in (("weight_widened_unsigned", WQ_MUTANTS["ln_linear_wq.cu"]),
                                ("widen_bias_off_by_one", WQ_WIDEN_MUTANTS["ln_linear_wq.cu"]),
                                ("scale_by_token", WQ_EPILOGUE_MUTANTS["ln_linear_wq.cu"]),
                                ("bias_terms_first_window_only", WQ_DUAL_MUTANT)):
            with kernels.mutant(*src_define):
                my, mutants[bug] = run(out=poisoned())[:2]
            if bug in ("weight_widened_unsigned", "scale_by_token"):
                qkv_mutants[bug] = my
        gate(f"fused_ln_linear_dual_wq {form}", info, mutants, rp)
        # The qkv columns through the same copies: the core's bugs reach y too.
        info["qkv_mutant_row_rel_err"] = {
            m: must_not(f"fused_ln_linear_dual_wq {form} qkv", m, row_rel_err(out, ry) <= tol,
                        row_rel_err(out, ry))
            for m, out in qkv_mutants.items()}
        del mutants, qkv_mutants, my

        def library(xw=xw, rows2=rows2):
            xn_ = F.layer_norm(xw, (C,), g, b13, eps)
            return (lin_chain(xn_, wq, ws, bias).to(bf),
                    (torch.matmul(xn_, w2.to(bf)).float() * s2 + bias2).to(bf)[:, :rows2])

        flops = 2.0 * C * (N * Tw * F1 + N * rows2 * F2)
        line = kernel_line(
            "fused_ln_linear_dual_wq",
            max((y.float() - ry.float()).abs().max().item(), (p.float() - rp.float()).abs().max().item()),
            info, run,
            lambda xw=xw, r=rows2: mlp_kernel._ln_linear_dual_parts_plain(xw, *wargs, False, r),
            library, nbytes(xw, g, b13, wq, ws, bias, w2, s2, bias2, y, p), flops, iters=10)
        line["stage_ms"] = stage_ms(
            lambda bits, xw=xw, r=rows2, sc=xn: mlp_kernel._ln_linear_dual_wq_cuda(
                xw, *wargs, r, stages=bits, scratch=sc),
            {"row_pass": 1, "gemm_qkv": 2, "gemm_bias_terms": 4, "gemm": 6})
        line.update(shape=[N, Tw, C, F1, F2, rows2], tflops=flops / line["ms"] / 1e9,
                    gemm_tflops=flops / line["stage_ms"]["gemm"] / 1e9,
                    kernels_a_call=kernels_of_a_call(run))
        # Two kernels, the row pass and K13's GEMM, at most one launch of each
        # a call (the profiler can drop a few records of a short window).
        calls = line["kernels_a_call"]
        if calls != "not measured":
            must(f"fused_ln_linear_dual_wq {form}: one row pass and one GEMM launch a call",
                 len(calls) == 2 and max(calls.values()) <= 1
                 and any(K13_WQ_FORM in k for k in calls)
                 and any("ln_rows_bf16_kernel" in k for k in calls), calls)
        forms[form] = line
        del xw, y, p, xn, ry, rp
    results["fused_ln_linear_dual_wq"] = {**forms["full"], **{
        f"{name}_form": {k: v for k, v in forms[name].items()
                         if k not in ("name", "route", "source", "replaces")}
        for name in ("edge_pair", "corner")}}
    results["fused_ln_linear_dual_wq"].update(
        sass=sass_counts("ln_linear_wq.cu", K13_WQ_FORM, ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")),
        kernel=kernels.kernel_attrs(*K13_WQ_ATTRS))
    wq_sass(results["fused_ln_linear_dual_wq"]["sass"], "fused_ln_linear_dual_wq")
    log(f"[kernel] fused_ln_linear_dual_wq stages {json.dumps({k: v['stage_ms'] for k, v in forms.items()})} "
        f"sass {json.dumps(results['fused_ln_linear_dual_wq']['sass'])} "
        f"kernel {json.dumps(results['fused_ln_linear_dual_wq']['kernel'])}")
    torch.cuda.empty_cache()

    # K12: one global block's MLP.
    (w1, s1), (w2, s2) = weight(C, Fw), weight(Fw, C)
    b1, b2 = randn(Fw, scale=0.5), randn(C, scale=0.5)
    args = (x, g, b, w1, s1, b1, w2, s2, b2, eps)
    ref = mlp_kernel._mlp_block_parts_plain(*args, 1024, False)[0]
    got, xn, h = mlp_kernel._mlp_block_wq_cuda(*args)
    torch.cuda.synchronize()
    xn_ref = mlp_kernel._ln_f32(x.float(), g, b, eps).to(bf)
    h_ref = mlp_kernel._gelu_exact(xn_ref.float() @ w1.float() * s1 + b1.float()).to(bf)
    info = {"row_rel_err": row_rel_err(got, ref), "h_row_rel_err": row_rel_err(h, h_ref)}
    mutants = {
        "per_tensor_fc1_scale": mlp_kernel._mlp_block_wq_cuda(
            x, g, b, w1, s1.mean().expand_as(s1).contiguous(), b1, w2, s2, b2, eps)[0],
        "fc1_bias_dropped": mlp_kernel._mlp_block_wq_cuda(
            x, g, b, w1, s1, torch.zeros_like(b1), w2, s2, b2, eps)[0],
    }
    for bug, table in (("weight_widened_unsigned", WQ_MUTANTS),
                       ("widen_bias_off_by_one", WQ_WIDEN_MUTANTS),
                       ("scale_by_token", WQ_EPILOGUE_MUTANTS)):
        with kernels.mutant(*table["mlp_block_wq.cu"]):
            mutants[bug] = mlp_kernel._mlp_block_wq_cuda(*args)[0]
    gate("fused_mlp_block_wq", info, mutants, ref)
    del mutants, xn_ref, h_ref

    def library_mlp():
        xn_ = F.layer_norm(x, (C,), g, b, eps)
        h_ = F.gelu(lin_chain(xn_, w1, s1, b1)).to(bf)
        return (lin_chain(h_, w2, s2, b2) + x.float()).to(bf)

    flops = 4.0 * T * C * Fw
    line = results["fused_mlp_block_wq"] = kernel_line(
        "fused_mlp_block_wq", (got.float() - ref.float()).abs().max().item(), info,
        lambda: mlp_kernel._mlp_block_wq_cuda(*args),
        lambda: mlp_kernel._mlp_block_parts_plain(*args, 1024, False), library_mlp,
        nbytes(x, g, b, w1, s1, b1, w2, s2, b2, got), flops, iters=10)
    line["stage_ms"] = stage_ms(
        lambda bits: mlp_kernel._mlp_block_wq_cuda(*args, stages=bits, scratch=(xn, h)),
        {"row_pass": 1, "fc1": 2, "fc2": 4})
    w1_bf, w2_bf = w1.to(bf), w2.to(bf)  # widened once, outside the timer
    line.update(
        shape=[T, C, Fw], tflops=flops / line["ms"] / 1e9,
        fc_tflops={fc: flops / 2 / line["stage_ms"][fc] / 1e9 for fc in ("fc1", "fc2")},
        bf16_gemm_ms={"fc1": time_ms(lambda: torch.matmul(xn, w1_bf), 10),
                      "fc2": time_ms(lambda: torch.matmul(h, w2_bf), 10)},
        class_rows_ms={str(n): time_ms(lambda n=n: mlp_kernel._mlp_block_wq_cuda(
            x[:n], *args[1:]), 10) for n in STAGE2_CLASS_ROWS},
        sass=sass_counts("mlp_block_wq.cu", WQ_SM90_GEMM, ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")),
        kernel={fc: kernels.kernel_attrs(*K12_WQ_ATTRS, i) for i, fc in ((1, "fc1"), (2, "fc2"))})
    wq_sass(line["sass"], "fused_mlp_block_wq")
    log(f"[kernel] fused_mlp_block_wq stages {json.dumps(line['stage_ms'])} "
        f"classes {json.dumps(line['class_rows_ms'])} bf16_gemm {json.dumps(line['bf16_gemm_ms'])} "
        f"sass {json.dumps(line['sass'])} kernel {json.dumps(line['kernel'])}")
    del ref, got, xn, h, x, w1, w2, w1_bf, w2_bf
    torch.cuda.empty_cache()


def wq_sass(counts, name) -> None:
    """The wgmma + TMA core's kernels must issue wgmma (`HGMMA`) and TMA
    loads, and no mma.sync (`HMMA`); unread where the toolkit has no
    cuobjdump."""
    if counts != "not measured":
        must(f"{name} SASS", counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0,
             counts)


# The training shapes: B=4 sequences of 1024 tokens, LLaMA-7B's 32 heads
# of 128; ragged kv_lens for the kernel phase.
B_TRAIN, S_TRAIN = 4, 1024
TRAIN_LENS = (1024, 1000, 777, 513)
# The deliberate bugs that the K15-K18 gates must catch: each is a copy of
# a kernel source compiled with the define (see `kernels.mutant`).
TRAIN_MUTANTS = {
    "flash_attention_fwd_lse": ("flash_fwd_sm90.cu", "ULLAVA_MUTANT_LSE_NO_LOG"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", "ULLAVA_MUTANT_NO_DELTA"),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu", "ULLAVA_MUTANT_DQ_NO_SCALE"),
    "rms_norm_bwd": ("rms_norm_bwd.cu", "ULLAVA_MUTANT_NO_C"),
}
# K18's second bug, in its fused two-value reduction: the slot's last warp's
# partial pair left out.
K18_MUTANTS = {"warp_left_out": ("rms_norm_bwd.cu", "ULLAVA_MUTANT_RMS_BWD_WARP_OUT")}
K18_ATTRS = ("rms_norm_bwd.cu", "ullava_rms_norm_bwd_attrs")
# K15's second bug, in its masking: a masked tile's causal bound one key late.
K15_MASK_MUTANT = ("flash_fwd_sm90.cu", "ULLAVA_MUTANT_CAUSAL_SHIFT")
# The fused backward's own hazards (besides delta and scale dropped, in
# `TRAIN_MUTANTS`): a masked tile's causal bound one key late, and only the
# first consumer warpgroup's 64 keys of a tile reaching dQ.
BWD_MUTANTS = {
    "causal_mask_shifted": ("flash_attention_bwd.cu", "ULLAVA_MUTANT_BWD_CAUSAL_SHIFT"),
    "dq_one_warpgroup": ("flash_attention_bwd.cu", "ULLAVA_MUTANT_DQ_ONE_WARPGROUP"),
}
BWD_ATTRS = ("flash_attention_bwd.cu", "ullava_flash_attention_bwd_attrs")
# Small edges of the fused backward's key tiles on the card:
# (B, Sq, Sk, kv_lens, causal): a batch row with kv_len 0, and Sq 200
# (a ragged last query tile) with ragged kv_lens.
BWD_EDGES = {"kv_len_0": (2, 128, 128, (128, 0), True),
             "sq_200_ragged": (2, 200, 200, (200, 131), True)}


def flash_bwd_edges(gen) -> dict:
    """The backward against its plain version at `BWD_EDGES`, dk and dv
    exact zeros past kv_len; {case: {grad: grad_rel_err}}."""
    import torch

    from ullava_tpu_torch.ops import attention

    out = {}
    for name, (Bn, Sq, Sk, lens, causal) in BWD_EDGES.items():
        q, do = ((torch.randn((Bn, Sq, 4, 128), generator=gen, device="cuda")).to(
            torch.bfloat16) for _ in range(2))
        k, v = ((torch.randn((Bn, Sk, 4, 128), generator=gen, device="cuda")).to(
            torch.bfloat16) for _ in range(2))
        kv = torch.tensor(lens, device="cuda", dtype=torch.int32)
        kw = dict(causal=causal, scale=128**-0.5)
        o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
        ref = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, kv, **kw)
        errs = {n: grad_rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        zero = all(not t[b, n:].any() for t in got[1:] for b, n in enumerate(lens))
        must(f"flash_attention_bwd edge {name}", max(errs.values()) <= 1e-2 and zero, (errs, zero))
        out[name] = errs
    return out


def train_kernel_phases(gen, results: dict) -> None:
    """K15-K18 against their plain versions at the shapes of the stage-1
    step: attention [4, 1024, 32, 128], causal, kv_lens 1024/1000/777/513;
    RMSNorm backward over [4096, 4096] without and with dw.

    Gates: bf16 outputs by `row_rel_err` and gradients by `grad_rel_err`
    within 1e-2 (one ulp of a row's largest value); lse within 1e-4
    absolute (fp32, a few
    units; sums in another order); dw within 1e-2 of its largest value.
    Each gate must reject the kernel rebuilt with a deliberate bug
    (`TRAIN_MUTANTS`, `K15_MASK_MUTANT`, `BWD_MUTANTS`): lse without log l
    and a masked tile's causal bound one key late in K15; in the fused
    backward delta dropped from dS (dk's gate), the dS that feeds dQ
    unscaled, only one consumer warpgroup's keys reaching dQ (dq's gate),
    a masked tile's causal bound one key late (all three); the c term
    dropped from dx. dk and dv must be bit-equal over two calls (dq's
    largest difference between them is recorded: its fp32 sums arrive by
    reduce-adds in no fixed order), and the backward must hold its gate at
    `BWD_EDGES`. The library yardsticks: SDPA with is_causal (no kv_lens
    mask) forward, and its backward under autograd (dq, dk and dv in one
    call) for K16's line and for the whole backward (its three launches,
    as the step runs it); the bf16 cast for K17's line (the dq finish);
    none for the pre-pass (delta and the zeroed accumulator; its line adds
    the einsum that computed delta before); the backward of `F.rms_norm`
    under autograd.
    K15's and K16's lines add their rate over the live products and their
    `HGMMA` / `UTMALDG` (K16 also `UTMAREDG`, the TMA reduce-add) / `HMMA`
    counts in the built library's SASS; K16's and K17's their registers,
    shared bytes and blocks an SM."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import attention, norms

    dev, bf, tol = "cuda", torch.bfloat16, 1e-2
    H, hd = 32, 128
    sc = hd**-0.5

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    q, k, v, do = (randn(B_TRAIN, S_TRAIN, H, hd) for _ in range(4))
    lens = torch.tensor(TRAIN_LENS, device=dev, dtype=torch.int32)
    live = sum(min(i + 1, n) for n in TRAIN_LENS for i in range(S_TRAIN)) * H
    kw = dict(causal=True, scale=sc)

    # K15: o and lse; each mutant must fail the gate of what it breaks.
    o, lse = attention.flash_attention_fwd(q, k, v, lens, **kw)
    o_ref, lse_ref = attention.flash_attention_fwd_plain(q, k, v, lens, **kw)
    with kernels.mutant(*TRAIN_MUTANTS["flash_attention_fwd_lse"]):
        lse_bad = attention.flash_attention_fwd(q, k, v, lens, **kw)[1]
    with kernels.mutant(*K15_MASK_MUTANT):
        o_bad = attention.flash_attention_fwd(q, k, v, lens, **kw)[0]
    err_o = row_rel_err(o, o_ref)
    err_lse = (lse - lse_ref).abs().max().item()
    bad_lse = (lse_bad - lse_ref).abs().max().item()
    bad_o = row_rel_err(o_bad, o_ref)
    must("flash_attention_fwd_lse", err_o <= tol and err_lse <= 1e-4, (err_o, err_lse))
    must_not("flash_attention_fwd_lse", "lse_without_log_l", bad_lse <= 1e-4, bad_lse)
    must_not("flash_attention_fwd_lse", "causal_mask_shifted", bad_o <= tol, bad_o)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    flops = 4.0 * hd * live
    line = kernel_line(
        "flash_attention_fwd_lse", (o.float() - o_ref.float()).abs().max().item(),
        {"row_rel_err": err_o, "tol": tol, "lse_max_abs_err": err_lse, "lse_tol": 1e-4,
         "mutant_lse_max_abs_err": {"lse_without_log_l": bad_lse},
         "mutant_row_rel_err": {"causal_mask_shifted": bad_o}},
        lambda: attention.flash_attention_fwd(q, k, v, lens, **kw),
        lambda: attention.flash_attention_fwd_plain(q, k, v, lens, **kw),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=sc),
        nbytes(q, lens, o, lse) + live_bytes(TRAIN_LENS, k, v), flops)
    line["tflops_live"] = flops / line["ms"] / 1e9
    line["sass"] = sass_counts("flash_fwd_sm90.cu", "flash_fwd_sm90_kernel")
    results["flash_attention_fwd_lse"] = line
    log(f"[kernel] K15 tflops_live {line['tflops_live']} sass {line['sass']}")
    del o_ref, lse_ref, lse_bad, o_bad

    # K16 + K17 on the forward's own o and lse: the gate, the determinism
    # of dk and dv, each mutant against the gate of what it breaks.
    dq, dk, dv = attention.flash_attention_bwd(q, k, v, o, lse, do, lens, **kw)
    ref = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, lens, **kw)
    grads = ("dq", "dk", "dv")
    errs = {n: grad_rel_err(g, r) for n, g, r in zip(grads, (dq, dk, dv), ref)}
    zero_pad = all(not t[b, n:].any() for t in (dk, dv) for b, n in enumerate(TRAIN_LENS))
    must("flash_attention_bwd", max(errs.values()) <= tol and zero_pad, (errs, zero_pad))
    dq2, dk2, dv2 = attention.flash_attention_bwd(q, k, v, o, lse, do, lens, **kw)
    determinism = {"dk_dv_bit_equal": torch.equal(dk, dk2) and torch.equal(dv, dv2),
                   "dq_max_abs_diff": (dq.float() - dq2.float()).abs().max().item(),
                   "dq_grad_rel_diff": grad_rel_err(dq2, dq)}
    must("flash_attention_bwd determinism", determinism["dk_dv_bit_equal"], determinism)
    del dq2, dk2, dv2
    caught = {}
    for label, (src, define), checked in (
            ("delta_dropped", TRAIN_MUTANTS["flash_attention_bwd_dkv"], ("dk",)),
            ("scale_dropped", TRAIN_MUTANTS["flash_attention_bwd_dq"], ("dq",)),
            ("causal_mask_shifted", BWD_MUTANTS["causal_mask_shifted"], grads),
            ("dq_one_warpgroup", BWD_MUTANTS["dq_one_warpgroup"], ("dq",))):
        with kernels.mutant(src, define):
            bad = attention.flash_attention_bwd(q, k, v, o, lse, do, lens, **kw)
        caught[label] = max(grad_rel_err(bad[grads.index(n)], ref[grads.index(n)])
                            for n in checked)
        must_not("flash_attention_bwd", define, caught[label] <= tol, caught[label])
        del bad
    # Their own generator: the phases after this one draw what they drew before.
    edges = flash_bwd_edges(torch.Generator(device=dev).manual_seed(15))
    # The pre-pass: delta within 1e-5 of its largest value (fp32 sums of
    # 128 products in another order), the accumulator all zeros.
    delta = attention.flash_bwd_delta_plain(o, do).contiguous()
    dq_acc = torch.full(q.shape, 1.0, dtype=torch.float32, device=dev)
    got_delta = torch.empty_like(delta)
    prepass = (do.data_ptr(), o.data_ptr(), got_delta.data_ptr(), dq_acc.data_ptr(), S_TRAIN, H,
               B_TRAIN * S_TRAIN * H)
    kernels.launch("flash_attention_bwd_delta", *prepass)
    err_delta = (got_delta - delta).abs().max().item()
    rel_delta = err_delta / delta.abs().max().item()
    acc_zero = not dq_acc.any()
    must("flash_attention_bwd_delta", rel_delta <= 1e-5 and acc_zero, (rel_delta, acc_zero))
    line = kernel_line(
        "flash_attention_bwd_delta", err_delta,
        {"rel_err": rel_delta, "tol": 1e-5, "accumulator_zeroed": acc_zero,
         "plain_covers": "delta and the zeroed accumulator",
         "einsum_ms": time_ms(lambda: attention.flash_bwd_delta_plain(o, do), 20)},
        lambda: kernels.launch("flash_attention_bwd_delta", *prepass),
        lambda: (attention.flash_bwd_delta_plain(o, do), torch.zeros_like(dq_acc)), None,
        nbytes(do, o, delta, dq_acc), 2.0 * hd * B_TRAIN * S_TRAIN * H,
        flops_per_s=FP32_FLOPS_PER_S)
    line["kernel"] = kernels.kernel_attrs(*BWD_ATTRS, 2)
    results["flash_attention_bwd_delta"] = line
    fused = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), lens.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B_TRAIN, S_TRAIN, S_TRAIN, H, 1, 0, float(sc))
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (qt, kt, vt))
    sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, scale=sc)
    # SDPA's backward under autograd: dq, dk and dv in one call.
    library_ms = time_ms(
        lambda: torch.autograd.grad(sdpa, (qr, kr, vr), dot, retain_graph=True), 20)
    plain = lambda: attention.flash_attention_bwd_plain(q, k, v, o, lse, do, lens, **kw)  # noqa: E731
    sass = sass_counts("flash_attention_bwd.cu", "flash_bwd_kernel",
                       ("HGMMA", "UTMALDG", "UTMAREDG", "HMMA"))
    flops5 = 10.0 * hd * live  # S, dP, dV, dK, dQ over the live scores
    line = kernel_line(
        "flash_attention_bwd_dkv",
        max((dk.float() - ref[1].float()).abs().max().item(),
            (dv.float() - ref[2].float()).abs().max().item()),
        {"grad_rel_err": errs, "tol": tol, "pad_keys_zero": zero_pad,
         "determinism": determinism, "edges_grad_rel_err": edges,
         "mutant_grad_rel_err": caught,
         "plain_covers": "dq, dk and dv", "library_covers": "dq, dk and dv (SDPA backward)"},
        lambda: kernels.launch("flash_attention_bwd_dkv", *fused), plain, None,
        nbytes(q, do, lse, delta, lens, dk, dv, dq_acc) + live_bytes(TRAIN_LENS, k, v), flops5)
    line["library_ms"] = library_ms
    line["tflops_live"] = flops5 / line["ms"] / 1e9
    line["sass"] = sass
    line["kernel"] = kernels.kernel_attrs(*BWD_ATTRS, 0)
    results["flash_attention_bwd_dkv"] = line
    n8 = dq.numel() // 8
    line = kernel_line(
        "flash_attention_bwd_dq", (dq.float() - ref[0].float()).abs().max().item(),
        {"grad_rel_err": errs["dq"], "tol": tol, "plain_covers": "dq, dk and dv",
         "library_covers": "the dq finish alone (`Tensor.to(torch.bfloat16)`)"},
        lambda: kernels.launch("flash_attention_bwd_dq", dq_acc.data_ptr(), dq.data_ptr(), n8),
        plain, lambda: dq_acc.to(torch.bfloat16), nbytes(dq_acc, dq), 0.0)
    line["sass"] = sass_counts("flash_attention_bwd.cu", "dq_finish_kernel",
                               ("HGMMA", "UTMALDG", "HMMA"))
    line["kernel"] = kernels.kernel_attrs(*BWD_ATTRS, 1)
    results["flash_attention_bwd_dq"] = line
    # The whole backward as the training step calls it (its three
    # launches and their allocations) beside SDPA's backward.
    whole = lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, lens, **kw)  # noqa: E731
    b_ms, b_by = bound_ms(nbytes(q, o, do, lse, lens, dq, dk, dv) + live_bytes(TRAIN_LENS, k, v),
                          flops5)
    whole_line = {"ms": time_ms(whole, 20), "library_ms": library_ms, "bound_ms": b_ms,
                  "bound_by": b_by}
    whole_line["vs_library"] = whole_line["ms"] / whole_line["library_ms"]
    whole_line["tflops_live"] = flops5 / whole_line["ms"] / 1e9
    results["flash_attention_bwd_dkv"]["whole_backward"] = whole_line
    log(f"[kernel] flash backward: fused {results['flash_attention_bwd_dkv']['tflops_live']} "
        f"TFLOP/s sass {sass}; whole {json.dumps(whole_line)}")
    del ref, sdpa, qr, kr, vr, qt, kt, vt, dot, q, k, v, do, o, lse, dq, dk, dv, delta, dq_acc
    del got_delta
    torch.cuda.empty_cache()

    # K18: dy correlated with x (as the gradient of a norm's output is), so
    # the c term carries weight and its mutant shows.
    rows, D = B_TRAIN * S_TRAIN, 4096
    x = randn(rows, D, scale=2.0)
    dy = (0.5 * x.float() + torch.randn(rows, D, generator=gen, device=dev)).to(bf)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf)
    dx_ref, dw_ref = norms.rms_norm_bwd_plain(x, w, dy, 1e-6)
    dx = norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=False)[0]
    dx2, dw = norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=True)
    err, err_dw = row_rel_err(dx, dx_ref), row_rel_err(dw[None], dw_ref[None])
    must("rms_norm_bwd", err <= tol and err_dw <= tol and torch.equal(dx, dx2), (err, err_dw))
    bad = {}
    for m, (src, define) in {"c_term_dropped": TRAIN_MUTANTS["rms_norm_bwd"],
                             **K18_MUTANTS}.items():
        with kernels.mutant(src, define):
            bad[m] = row_rel_err(norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=False)[0], dx_ref)
        must_not("rms_norm_bwd", define, bad[m] <= tol, bad[m])
    xr, wr = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    y = F.rms_norm(xr, (D,), wr, 1e-6)
    dw_form = {
        "row_rel_err_dw": err_dw, "dx_equal_to_dx_form": True,
        "ms": time_ms(lambda: norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=True), 20),
        "plain_ms": time_ms(lambda: norms.rms_norm_bwd_plain(x, w, dy, 1e-6), 5, warmup=1),
        "library_ms": time_ms(lambda: torch.autograd.grad(y, (xr, wr), dy, retain_graph=True), 20),
        "bound_ms": bound_ms(nbytes(x, w, dy, dx, dw), 13.0 * x.numel(), FP32_FLOPS_PER_S)[0],
        "kernel": kernels.kernel_attrs(*K18_ATTRS, D, 1),
    }
    results["rms_norm_bwd"] = kernel_line(
        "rms_norm_bwd", (dx.float() - dx_ref.float()).abs().max().item(),
        {"row_rel_err": err, "tol": tol, "mutant_row_rel_err": bad, "dw_form": dw_form,
         "kernel": kernels.kernel_attrs(*K18_ATTRS, D, 0)},
        lambda: norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=False),
        lambda: norms.rms_norm_bwd_plain(x, w, dy, 1e-6, need_dw=False),
        lambda: torch.autograd.grad(y, xr, dy, retain_graph=True),
        nbytes(x, w, dy, dx), 10.0 * x.numel(), flops_per_s=FP32_FLOPS_PER_S)
    del x, dy, dx, dx2, dx_ref, y, xr, wr
    torch.cuda.empty_cache()


# The deliberate bugs that the gates of the packed kernels, the per-(window,
# head) window kernel and the non-writing decode kernel must catch: each
# source rebuilt with the bug under `-D<define>`; the two packed forms share
# a source and face both of its bugs.
PACKED_MUTANTS = {
    "bias_read_prescaled": ("sam_packed_attention.cu", "ULLAVA_MUTANT_PACKED_BIAS_PRESCALED"),
    "k_one_head_over": ("sam_packed_attention.cu", "ULLAVA_MUTANT_PACKED_HEAD_OFFSET"),
    "a_term_one_grid_row": ("sam_packed_attention.cu", "ULLAVA_MUTANT_GLOBAL_A_ONE_ROW"),
    "quad_max_dropped": ("sam_packed_attention.cu", "ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX"),
    "bias_not_prescaled": ("sam_window_attention.cu", "ULLAVA_MUTANT_WINDOW_BIAS_RAW"),
    "kv_lens_ignored": ("decode_attention_int8.cu", "ULLAVA_MUTANT_DECODE_NO_KV_LENS"),
    "peer_l_dropped": ("decode_attention_int8.cu", "ULLAVA_MUTANT_DECODE_PEER_L_DROPPED"),
}
K22_ATTRS = ("decode_attention_int8.cu", "ullava_decode_attention_int8_attrs")
PACKED_NAMES = ("fused_window_attention_packed", "fused_global_attention_packed")
# Kernels that no path of either package calls: each line reports its
# launches in every serve (all 0) and says so.
UNCALLED_NAMES = ("fused_window_attention", "decode_attention_int8")
SAM_HP = 128  # the packed layout's lanes a head


def packed_sdpa_inputs(y, a, bb, H, hp):
    """The library yardstick of the packed kernels: head-major q, k, v over
    the same padded lanes and the raw bias terms materialised as a
    [N, H, S, S] bf16 mask, added after the scale as the kernels do."""
    import torch

    N, S, _ = y.shape
    W = a.shape[-1]
    y5 = y.reshape(N, S, 3, H, hp).permute(2, 0, 3, 1, 4).contiguous()
    t = torch.arange(S, device=y.device)
    mask = (a.float()[..., t // W] + bb.float()[..., t % W]).to(torch.bfloat16)
    return y5, mask


def packed_kernel_phases(gen, results: dict) -> None:
    """The packed kernels and the two uncalled ones against their plain
    versions: the packed window kernel at one window block of a B=4
    packed serve ([100, 196, 6144]: 16 heads of 80 lanes padded to 128, pad lanes zero
    as the packed weights make them), the packed global kernel at one
    global block ([4, 4096, 6144]), the per-(window, head) window kernel
    (`k21_line`) and the decode attention that does not write
    (`k22_line`).

    Gates: `row_rel_err` within 1e-2 (one bf16 ulp of a row's largest
    value); the window forms normalize P before its bf16 rounding, as
    their TPU kernels and the plain versions do (K19 and K21 on
    `window_whole.cuh`). Each gate must reject the source rebuilt with a
    deliberate bug (`PACKED_MUTANTS`; the global form's A term of a
    128-key tile's first grid row for both halves too) and a mutated
    input (bias terms swapped; for the decode kernel the key and value
    scales swapped). The packed global kernel's line gives the global
    core's SASS counts. Bounds: the packed kernels' products over all 128
    lanes (the function contracts them; the 80 real lanes' bound is
    reported beside), the window kernel's and the decode kernel's bytes.
    The library yardsticks: SDPA with the bias as a materialised bf16
    mask; the decode kernel has none."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import sam_attention

    dev, bf, tol = "cuda", torch.bfloat16, 1e-2
    H, hd, hp, W = SAM_H, SAM_HD, SAM_HP, SAM_W
    sc = hd**-0.5

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def gate(name, got, ref, mutants):
        err = row_rel_err(got, ref)
        must(name, err <= tol, err)
        caught = {m: row_rel_err(out, ref) for m, out in mutants.items()}
        for m, e in caught.items():
            must_not(name, m, e <= tol, e)
        return {"row_rel_err": err, "tol": tol, "mutant_row_rel_err": caught}

    def mutated(run, *bugs):
        out = {}
        for bug in bugs:
            with kernels.mutant(*PACKED_MUTANTS[bug]):
                out[bug] = run()
        torch.cuda.synchronize()
        return out

    # K19 and K20: a packed y with zero pad lanes, raw bias terms of the
    # encoder's size (q . rel_pos with an unscaled q: a few units).
    for name, N, Wn, iters in (("fused_window_attention_packed", B * 25, W, 20),
                               ("fused_global_attention_packed", B, 64, 5)):
        S = Wn * Wn
        y = torch.zeros((N, S, 3, H, hp), dtype=bf, device=dev)
        y[..., :hd] = randn(N, S, 3, H, hd)
        y = y.reshape(N, S, 3 * H * hp)
        a, bb = (randn(N, H, S, Wn, scale=2.0) for _ in range(2))
        fn = getattr(sam_attention, name)
        plain_fn = getattr(sam_attention, f"{name}_plain")
        run = lambda a_=a, b_=bb, y=y, fn=fn, Wn=Wn: fn(y, a_, b_, H, hp, Wn, sc)  # noqa: E731
        plain = lambda y=y, a=a, bb=bb, f=plain_fn, Wn=Wn: f(y, a, bb, H, hp, Wn, sc)  # noqa: E731
        got, ref = run(), plain()
        bugs = ("bias_read_prescaled", "k_one_head_over") + (
            ("quad_max_dropped",) if name == "fused_window_attention_packed" else
            ("a_term_one_grid_row",))
        info = gate(name, got, ref, {**mutated(run, *bugs), "bias_swapped": run(bb, a)})
        info["pad_lanes_zero"] = bool(torch.all(got.reshape(N, S, H, hp)[..., hd:] == 0))
        must(name, info["pad_lanes_zero"], "pad lanes of the output are not zero")
        y5, mask = packed_sdpa_inputs(y, a, bb, H, hp)
        flops = 4.0 * N * H * S * S * hp
        io = nbytes(y, a, bb, got)
        line = kernel_line(
            name, (got.float() - ref.float()).abs().max().item(), info, run, plain,
            lambda y5=y5, m=mask: F.scaled_dot_product_attention(y5[0], y5[1], y5[2],
                                                                 attn_mask=m, scale=sc),
            io, flops, iters=iters)
        line["bound_ms_real_lanes"] = bound_ms(io, flops * hd / hp)[0]
        line["shape"] = [N, S, 3 * H * hp]
        line["tflops_128_lanes"] = flops / line["ms"] / 1e9
        if name == "fused_window_attention_packed":
            line["sass"] = sass_counts("sam_packed_attention.cu", "window_whole_kernel")
            line["kernel"] = kernels.kernel_attrs(*WINDOW_ATTRS["packed"])
        else:
            line["sass"] = global_core_sass("sam_packed_attention.cu")
        results[name] = line
        del y, a, bb, got, ref, y5, mask
        torch.cuda.empty_cache()

    results["fused_window_attention"] = k21_line(gen, gate, mutated)
    results["decode_attention_int8"] = k22_line(gen, gate, mutated)
    torch.cuda.empty_cache()


def k21_line(gen, gate, mutated) -> dict:
    """K21 at the block layout's windows of one B=4 window block,
    head-major ([1600, 196, 80]), on the whole-window core: its gate, the
    mutants, time, bound, plain version and SDPA + mask; beside it K3 on
    the same windows (q, k, v packed as K3's y, the bias terms pre-scaled
    by the kernel's own fp32 1/scale and reversed, as K3 takes them), its
    time and the share of bf16 outputs equal to K21's (the same core and
    arithmetic), and K21's registers and SASS counts."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import sam_attention

    dev, bf = "cuda", torch.bfloat16
    H, hd, W = SAM_H, SAM_HD, SAM_W
    sc = hd**-0.5
    name, Nw, S = "fused_window_attention", B * 25, W * W
    N = Nw * H

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    q, k, v = (randn(N, S, hd) for _ in range(3))
    a, bb = (randn(N, S, W, scale=2.0) for _ in range(2))
    run = lambda a_=a, b_=bb: sam_attention.fused_window_attention(q, k, v, a_, b_, W, sc)  # noqa: E731
    plain = lambda: sam_attention.fused_window_attention_plain(q, k, v, a, bb, W, sc)  # noqa: E731
    got, ref = run(), plain()
    info = gate(name, got, ref, {**mutated(run, "bias_not_prescaled"), "bias_swapped": run(bb, a)})
    inv = 1.0 / sc
    a_s, b_s = ((t.float() * inv).to(bf).float() for t in (a, bb))
    mask = ((a_s[:, :, :, None] + b_s[:, :, None, :]).reshape(N, S, S) * sc).to(bf)
    line = kernel_line(
        name, (got.float() - ref.float()).abs().max().item(), info, run, plain,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=sc),
        nbytes(q, k, v, a, bb, got), 4.0 * N * S * S * hd)
    del a_s, b_s, mask
    # The witness: K3 on the same windows.
    y = torch.stack((q, k, v)).reshape(3, Nw, H, S, hd).permute(1, 3, 0, 2, 4).reshape(
        Nw, S, 3 * H * hd).contiguous()
    inv32 = (torch.ones((), dtype=torch.float32) / torch.tensor(sc, dtype=torch.float32)).item()
    a3, b3 = ((t.float() * inv32).to(bf).reshape(Nw, H, S, W).flip(-1).permute(0, 2, 1, 3)
              .reshape(Nw, S, H * W).contiguous() for t in (a, bb))
    k3 = lambda: sam_attention.fused_window_attention_grid(y, a3, b3, H, hd, W, sc)  # noqa: E731
    merged = got.reshape(Nw, H, S, hd).permute(0, 2, 1, 3).reshape(Nw, S, H * hd)
    o3 = k3()
    torch.cuda.synchronize()
    line["k3_same_windows"] = {
        "ms": time_ms(k3, 20), "row_rel_err_to_k21": row_rel_err(o3, merged),
        "bit_equal_share_to_k21": bit_equal_share(o3, merged.contiguous())}
    line.update(shape=[N, S, hd], kernel=kernels.kernel_attrs(*WINDOW_ATTRS["head_major"], 0),
                sass=sass_counts("sam_window_attention.cu", "WindowHeadMajor"))
    del q, k, v, a, bb, got, ref, y, a3, b3, o3, merged
    torch.cuda.empty_cache()
    return line


def k22_line(gen, gate, mutated) -> dict:
    """K22 at one layer of K8's stacked cache ([32, 16, 352, 4096] int8,
    ragged kv_lens, rep 1: 512 blocks, no split), rows past kv_lens filled
    with data the mask must hide; GQA (32 heads on 8 kv heads) small; and
    a long cache with few blocks ([1, 32, 2048, 128], kv_len in 1900-2047),
    where the wrapper splits each (sample, head)'s rows over a cluster of
    blocks, timed beside one block a (sample, head); then a uniform row
    (kv_lens 0) beside a long one at the same split shape. Each form's
    gate, the cache untouched, every mutant (the cluster merge's at the
    split shape) failing it. Time: the median and spread of five batches,
    as K8's line; bound: the bytes of the rows this run's kv_lens make
    the kernel read, at the fp32 rate."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import decode_attention

    dev = "cuda"
    name, hdl = "decode_attention_int8", 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {}
    for form, L, Bd, Hq, Hkv, S_, lens in (
            ("rep1", 32, B_INT8, 32, 32, PROMPT + NEW_TOKENS,
             [PROMPT + NEW_TOKENS - (7 * i) % 64 for i in range(B_INT8)]),
            ("gqa_rep4", 2, 4, 32, 8, 64, [64, 9, 1, 40]),
            ("split", 2, 1, 32, 32, 2048, None),
            ("split_uniform", 2, 2, 32, 32, 2048, [0, 2011])):
        cache = [torch.randint(-127, 128, (L, Bd, S_, Hkv * hdl), generator=gen, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        cache += [torch.rand((L, Bd, S_, Hkv), generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in range(2)]
        q = (torch.randn((Bd, 1, Hq, hdl), generator=gen, device=dev)).to(torch.bfloat16)
        if lens is None:
            lens = [1900 + int(torch.randint(0, 148, (1,), generator=gen, device=dev))]
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        lay = 5 if form == "rep1" else 1
        run = lambda splits=None, ks=cache[2], vs=cache[3], q=q, c=cache[:2], kl=kv_lens, l_=lay: (  # noqa: E731
            decode_attention._decode_read_cuda(q, *c, ks, vs, kl, l_, hdl**-0.5, splits))
        plain = lambda q=q, c=cache, kl=kv_lens, l_=lay: (  # noqa: E731
            decode_attention.decode_attention_int8_plain(q, *c, kl, l_, scale=hdl**-0.5))
        before = [t.clone() for t in cache]
        got = decode_attention.decode_attention_int8(q, *cache, kv_lens, lay, scale=hdl**-0.5)
        ref = plain()
        bugs = ("kv_lens_ignored",) + (("peer_l_dropped",) if form == "split" else ())
        info = gate(f"{name} {form}", got, ref, {**mutated(run, *bugs),
                                                 "scales_swapped": run(ks=cache[3], vs=cache[2])})
        info["splits"] = splits = decode_attention.decode_read_splits(Bd, Hq, S_, hdl, sms)
        if splits > 1:  # the same rows with one block a (sample, head)
            info["one_block_row_rel_err"] = err = row_rel_err(run(1), ref)
            must(f"{name} {form} one block", err <= info["tol"], err)
        info["cache_untouched"] = all(torch.equal(x, y_) for x, y_ in zip(before, cache))
        must(name, info["cache_untouched"], "the cache changed")
        info.update(shape=[L, Bd, S_, Hkv * hdl], kv_lens=lens)
        rows = float(kv_lens.clamp(0, S_).sum()) + S_ * int((kv_lens <= 0).sum())
        # The rows this run's kv_lens make the kernel read: K and V of each
        # live row and their scales (a uniform row: V and its scales only).
        io = (float(kv_lens.clamp(0, S_).sum()) * (2 * Hkv * hdl + 2 * 4 * Hkv)
              + S_ * int((kv_lens <= 0).sum()) * (Hkv * hdl + 4 * Hkv)
              + 2 * nbytes(q) + nbytes(kv_lens))
        cases[form] = (info, got, ref, run, plain, io, 4.0 * rows * Hq * hdl)
        del before, cache
    info, got, ref, run, plain, io, flops = cases.pop("rep1")
    line = kernel_line(name, (got.float() - ref.float()).abs().max().item(), info, run, plain,
                       None, io, flops, flops_per_s=FP32_FLOPS_PER_S)
    line.update(spread_ms(run))  # the median of five batches, as K8's line
    line["kernel"] = kernels.kernel_attrs(*K22_ATTRS, decode_attention.read_rows(
        PROMPT + NEW_TOKENS, hdl, 1))
    for form, (info, got, ref, run, plain, io, flops) in cases.items():
        line[f"{form}_form"] = info
        if form == "split":
            b_ms, b_by = bound_ms(io, flops, FP32_FLOPS_PER_S)
            info.update({"bound_ms": b_ms, "bound_by": b_by, "cluster": spread_ms(run),
                         "one_block": spread_ms(lambda: run(1)),
                         "kernel": kernels.kernel_attrs(*K22_ATTRS, decode_attention.read_rows(
                             2048, hdl, info["splits"]))})
    del cases
    torch.cuda.empty_cache()
    return line


def full_config():
    """LLaMA-7B + CLIP ViT-L/14 + SAM ViT-H in bf16 at full width; the
    vocabulary is LLaMA's 32000 + [PAD] + 6 multimodal + 4 stage-2 tokens.
    The SAM encoder's window layout is the default one (resident), and the
    LLM's attention the default "auto" (flash on the card)."""
    import torch

    from ullava_tpu_torch.models import clip_vit, llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import build as sam_build

    core = ullava_core.UllavaCoreConfig(
        llm=llama.LlamaConfig(vocab_size=32011),
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
                "fused_ln_linear": 0, "fused_global_attention_y": 0, "fused_mlp_block": 0,
                "fused_ln_linear_dual": 0, "fused_window_attention_rect": 0}
# The training path's kernels launch in no serve, the all-int8 serve's
# forms and the packed kernels in no other serve, the two uncalled kernels
# and the chunk-pipelined MLP (whose path is the microbenchmark) in none.
# The hd 64 forms (ViT-L's and ViT-B's heads), bf16 scores and the
# `dots_i8` forms with K11's pre-pass: only the sam_predictor phase
# reaches them.
SAM_HD64_NAMES = ("fused_window_attention_grid_hd64", "fused_window_attention_rect_hd64",
                  "fused_global_attention_hd64", "fused_global_attention_y_hd64",
                  "fused_window_attention_grid_i8_hd64", "fused_window_attention_rect_i8_hd64",
                  "global_attention_y_quant_i8_hd64", "fused_global_attention_y_i8_hd64")
IDLE_IN_SERVING = {"flash_attention_fwd_lse": 0, "flash_attention_bwd_delta": 0,
                   "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0, "rms_norm_bwd": 0, **{k: 0 for k in WQ_NAMES},
                   **{k: 0 for k in I8_NAMES}, **{k: 0 for k in PACKED_NAMES + UNCALLED_NAMES},
                   "fused_mlp_block_v2": 0, **{k: 0 for k in SAM_HD64_NAMES}}
BF16_LAUNCHES = {"fused_rotary": 64, "flash_attention_fwd_bsh": 32, **SAM_LAUNCHES,
                 "rms_norm_fwd": 65 * (1 + NEW_TOKENS),
                 "rms_norm_residual_quant": 0, "silu_mul_quant": 0,
                 "prefill_quantize_write": 0, "decode_attention_int8_fused_write": 0,
                 **IDLE_IN_SERVING}
INT8_LAUNCHES = {"fused_rotary": 64, "flash_attention_fwd_bsh": 32, **SAM_LAUNCHES,
                 **IDLE_IN_SERVING,
                 "rms_norm_residual_quant": 64, "silu_mul_quant": 32,
                 "prefill_quantize_write": 32, "rms_norm_fwd": 1 + 65 * NEW_TOKENS,
                 "decode_attention_int8_fused_write": 32 * NEW_TOKENS}
# The int8 SAM encoder in the block layout: the fused MLP in all 32 blocks;
# in each of the 4 global blocks LN1+qkv and proj+residual (one fused
# linear each) around the lane-sliced attention; the window kernel in the
# 28 window blocks; the transpose-staged global kernel never.
SAM_INT8_LAUNCHES = {**INT8_LAUNCHES, "fused_global_attention": 0, "fused_ln_linear": 8,
                     "fused_global_attention_y": 4, "fused_mlp_block": 32}
# The same encoder in the resident layout with composite bias weights. Each
# of the 28 window blocks runs three class tensors (full, the merged right
# and bottom, corner): the dual LN1+qkv, proj+residual and the fused MLP
# on each (at B=16 all three clear the MLP's 512-row gate), the window
# kernel on the full class, the boundary kernel on the other two. The 4
# global blocks are as in the block layout.
SAM_RESIDENT_LAUNCHES = {**SAM_INT8_LAUNCHES, "fused_ln_linear_dual": 28 * 3,
                         "fused_window_attention_rect": 28 * 2, "fused_ln_linear": 28 * 3 + 8,
                         "fused_mlp_block": 28 * 3 + 4}
# The all-int8 serve: the resident serve with the SAM attention kernels'
# int8 score forms in place of their bf16 forms, and CLIP's 23 layers (up
# to the readout at -2) through the flash forward at head_dim 64.
ALL_INT8_LAUNCHES = {**SAM_RESIDENT_LAUNCHES, "fused_window_attention_grid": 0,
                     "fused_window_attention_rect": 0, "fused_global_attention_y": 0,
                     "fused_window_attention_grid_i8": 28, "fused_window_attention_rect_i8": 28 * 2,
                     "global_attention_y_quant_i8": 4, "fused_global_attention_y_i8": 4,
                     "flash_attention_fwd_bsh_hd64": 23}
# The bf16 serve with its SAM image encoder packed (`pack_sam_attention`):
# the packed window kernel in the 28 window blocks (block layout), the
# packed global kernel in the 4 global blocks, the unpacked forms never.
PACKED_LAUNCHES = {**BF16_LAUNCHES, "fused_window_attention_grid": 0, "fused_global_attention": 0,
                   "fused_window_attention_packed": 28, "fused_global_attention_packed": 4}


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

    t_phase = time.perf_counter()
    reqs = requests(cfg, n_req, PROMPT, np.random.default_rng(0))
    gc = generate.GenerateConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
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

        t_prof = time.perf_counter()
        step_profile = profile_serve(lambda: timed(decode_steps))
        profiling_s = time.perf_counter() - t_prof
        _, steps_s = timed(decode_steps)
        emb, sam_s = timed(lambda: ullava.get_visual_embs(params, cfg, batch["images_sam"]))
        seg = torch.zeros((n_req, 1, 256), device="cuda")
        _, dec_s = timed(lambda: sam_build.forward_masks(params["sam"], cfg.sam, emb, seg))
    t_prof = time.perf_counter()
    profile_line = {**profile_serve(lambda: timed(lambda: serve((cfg, params), reqs, "cuda", gc))),
                    "phase": f"{phase}_profile"}
    profiling_s += time.perf_counter() - t_prof
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
        # The phase's wall, and the part of it under or after the profiler
        # (its two profiled runs and the processing of their events).
        "phase_s": time.perf_counter() - t_phase, "profiling_s": profiling_s,
    }
    print(json.dumps(line), flush=True)
    print(json.dumps(profile_line), flush=True)
    return line, profile_line


def clip_knob_split(cfg, params) -> dict:
    """CLIP + projector + splice of one B=16 batch (host clock around a
    synchronized call, median of three after a warm one) under each
    combination of CLIP's `a8` and `attn_impl`, on the same weights: what
    each knob costs or saves alone."""
    import numpy as np
    import torch

    from ullava_tpu_torch.models import ullava_core
    from ullava_tpu_torch.serve import collate

    batch = collate(requests(cfg, B_INT8, PROMPT, np.random.default_rng(0)), "cuda")
    out = {}
    for impl in ("xla", "flash"):
        for a8 in (False, True):
            core = dataclasses.replace(cfg.core, vision=dataclasses.replace(
                cfg.core.vision, a8=a8, attn_impl=impl))
            runs = []
            for _ in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with torch.no_grad():
                    ullava_core.embed_multimodal(params["core"], core, batch["input_ids"],
                                                 batch["images"])
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t)
            out[f"{impl}_{'a8' if a8 else 'weight_only'}"] = sorted(runs[1:])[1]
    return out


def stage1_config(**llm):
    """The stage-1 model at full width: CLIP ViT-L/14 (224, read out at
    layer -2, frozen), the MLP projector, LLaMA-7B in bf16 with remat per
    layer and the streamed CE; pretraining (`projector_from_scratch`)."""
    from ullava_tpu_torch.models import clip_vit, llama, ullava_core

    return ullava_core.UllavaCoreConfig(
        llm=llama.LlamaConfig(vocab_size=32011, remat=True, **llm),
        vision=clip_vit.CLIPVisionConfig(), vision_hidden_layer=-2,
        img_start_id=32001, img_end_id=32002, vid_start_id=32004, vid_end_id=32005,
        projector_from_scratch=True, fused_ce=True,
    )


# Launches of one stage-1 step with remat: every layer's forward runs twice
# (the step and the backward's recompute): K15 and two K9 per layer each
# time, the final norm's K9 once; the backward runs the flash backward's
# pre-pass, K16, K17 and two K18 per layer and one K18 for the final norm.
# Nothing else launches a kernel (CLIP is plain ops under no_grad; K2 and
# K1 are serving routes).
FLASH_BWD_NAMES = ("flash_attention_bwd_delta", "flash_attention_bwd_dkv",
                   "flash_attention_bwd_dq")
TRAIN_LAUNCHES = {**{k: 0 for k in BF16_LAUNCHES}, "flash_attention_fwd_lse": 64,
                  **{k: 32 for k in FLASH_BWD_NAMES}, "rms_norm_bwd": 65, "rms_norm_fwd": 129}


def _fingerprint(t):
    """An exact checksum of a tensor's bits (any one changed value moves it)."""
    import torch

    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):  # a sharded leaf: its whole value
        t = t.full_tensor()
    bits = t.detach().view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])
    return int(bits.sum(dtype=torch.int64)), int((bits.long() * bits.long()).sum())


def stage1_train_phase(gen) -> dict:
    """The training path: fresh bf16 stage-1 weights from the seeded
    generator, one B=4, S=1024 batch (256 image tokens), the pretraining
    policy, lr 2e-3 (constant after the schedule's one warmup step at 0),
    clip 1.0, remat on, built by `train.build_stage1`. One warm step with
    the launch counts set to 0 just before it and read just after (every
    kernel in `TRAIN_LAUNCHES` exactly that often), five timed steps, one
    profiled step. Checks: finite losses, the last below the first; the
    gradient norm finite and nonzero and every trainable leaf moved; every
    frozen leaf bit-unchanged."""
    import math

    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.models import ullava_core
    from ullava_tpu_torch.training import optim

    cfg = stage1_config()
    t0 = time.perf_counter()
    params = ullava_core.init_params(cfg, gen, "cuda")
    batch = train.make_batch(cfg, B_TRAIN, S_TRAIN, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    training_cfg = {"learning_rate": 2e-3, "lr_scheduler_type": "constant"}
    state, step, _ = train.build_stage1(cfg, params, training_cfg, total_steps=7)
    leaves = list(optim.named_leaves(state.params))  # the freeze policy set requires_grad
    trained = [t for _, t in leaves if t.requires_grad]
    frozen = [(n, t) for n, t in leaves if not t.requires_grad]
    frozen_before = [(n, _fingerprint(t)) for n, t in frozen]
    train_before = [t.detach().clone() for t in trained]

    def timed_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].float().item()
        return (loss, gnorm), time.perf_counter() - t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (loss0, gnorm0), first_s = timed_step()
    launches = kernels.launch_counts()
    wrong = {k: (launches[k], n) for k, n in TRAIN_LAUNCHES.items() if launches[k] != n}
    if wrong or set(TRAIN_LAUNCHES) != set(launches):
        raise AssertionError(f"stage1_train: launches (got, expected) {wrong}")
    runs = [timed_step() for _ in range(5)]
    losses = [loss0] + [r[0][0] for r in runs]
    gnorms = [gnorm0] + [r[0][1] for r in runs]
    step_s = sorted(r[1] for r in runs)[2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_serve(lambda: (None, timed_step()[1]))
    if not all(math.isfinite(x) for x in losses + gnorms) or min(gnorms) <= 0:
        raise AssertionError(f"stage1_train: losses {losses}, grad norms {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"stage1_train: the loss did not fall: {losses}")
    moved = [not torch.equal(a, t) for a, t in zip(train_before, trained)]
    frozen_after = [(n, _fingerprint(t)) for n, t in frozen]
    if not all(moved) or frozen_after != frozen_before:
        changed = [n for (n, a), (_, b) in zip(frozen_before, frozen_after) if a != b]
        raise AssertionError(f"stage1_train: trainable moved {moved}, frozen changed {changed}")
    tokens = B_TRAIN * S_TRAIN
    busy = profile["device_busy_s"]
    line = {
        "phase": "stage1_train", "batch": B_TRAIN, "seq": S_TRAIN,
        "image_tokens": cfg.vision.num_patches, "policy": "pretrain", "lr": 2e-3, "clip": 1.0,
        "remat": True, "init_s": init_s, "first_step_s": first_s, "step_s": step_s,
        "step_runs_s": [r[1] for r in runs], "images_per_s": B_TRAIN / step_s,
        "tokens_per_s": tokens / step_s, "losses": losses, "grad_norms": gnorms,
        "peak_mem_gb": peak_gb, "trainable_leaves": len(train_before),
        "frozen_leaves_unchanged": len(frozen_before),
        "profiled_step_wall_s": profile["wall_s"], "device_busy_s": busy,
        "device_idle_share": profile["device_idle_share"],
        "watched_device_ms_calls": profile["watched_device_ms_calls"],
        "top_device_ms": dict(list(profile["top_device_ms"].items())[:8]),
        "top_device_calls": dict(list(profile["top_device_calls"].items())[:8]),
        "launches": launches,
    }
    print(json.dumps(line), flush=True)
    del step, leaves, trained, frozen, train_before
    line["parallel"] = parallel_stage1(cfg, state, batch, training_cfg)
    # Last: the video step trains the core's leaves in place.
    line["video_stage1_step"] = video_stage1_phase(cfg, state.params["core"], training_cfg,
                                                   card_name_and_power_limit())
    del state, params, batch
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# The parallel phase: the sharded paths (`parallel/`) at world size 1, an
# NCCL group of this process alone and a (1, 1, 1) cuda mesh, on the models
# the stage-1, stage-2 and int8 serve phases build.
# ---------------------------------------------------------------------------
# grad_rel_err of "dots" against "full": the flash backward's gate, or twice "full"'s own spread
# between two runs where that is larger (K17's dq and the embedding's bf16 scatter-add backward
# are order-dependent).
PARALLEL_GRAD_TOL = 1e-2
PARALLEL_STAGE2_TOL = 5e-2  # check_stage2's gate on a loss's relative error


def parallel_mesh():
    """The (dp, fsdp, tp) = (1, 1, 1) mesh on the card: an NCCL group of
    one rank, joined on first use (the phase fails where it cannot be)."""
    from ullava_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(), "cuda")


def _snapshot(state, labels):
    """Clones of the trainable leaves and the moments (local tensors),
    and a function that writes them and the step count back."""
    import torch

    from ullava_tpu_torch.training import optim

    def tensors(st):
        return ([t.to_local() if hasattr(t, "to_local") else t
                 for t in optim.partition_params(st.params, labels)]
                + [t.to_local() if hasattr(t, "to_local") else t
                   for k in ("mu", "nu") for t in st.opt_state[k]])

    saved = [t.detach().clone() for t in tensors(state)]
    count = state.opt_state["count"]

    @torch.no_grad()
    def restore(st):
        for t, v in zip(tensors(st), saved, strict=True):
            t.copy_(v)
        st.opt_state = {**st.opt_state, "count": count}
        return st

    return restore


def parallel_stage1(cfg, state, batch, training_cfg) -> dict:
    """Stage 1 on the sharded path (`shard_train_state`, `jit_step`) from
    the stage-1 phase's state, once under remat_policy "full" and once
    under "dots", each from the same snapshot of the trainable leaves and
    moments: the gradients (`trainable_grads` in the step's data-parallel
    extent; under "full" twice, for its own run-to-run spread), then one
    step with the launch counts set to 0 just before it and read just
    after (`TRAIN_LAUNCHES` under both: the ctypes kernels recompute, only
    matmul outputs are kept), its wall time and peak memory. Gates:
    bit-equal losses, every trainable leaf's gradient within
    `PARALLEL_GRAD_TOL` or twice the "full" spread (grad_rel_err), the
    step losses bit-equal."""
    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.models import ullava_core
    from ullava_tpu_torch.parallel import collectives, sharding
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import (
        TrainState,
        jit_step,
        make_stage1_step,
        shard_train_state,
        trainable_grads,
    )

    t0 = time.perf_counter()
    mesh = parallel_mesh()
    _, tx = train._schedule_and_optimizer(training_cfg, 2e-3, 7)
    labels = optim.trainable_labels(state.params, optim.STAGE1_PRETRAIN)
    restore = _snapshot(state, labels)
    sstate = shard_train_state(state, mesh, tx, labels)
    runs, grads = {}, {}
    for policy in ("full", "full_again", "dots"):
        c = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                             remat_policy=policy.split("_")[0]))

        def loss_fn(params, b):
            return ullava_core.forward(params["core"], c, input_ids=b["input_ids"],
                                       labels=b["labels"], attn_lens=b["attn_lens"],
                                       images=b["images"])["loss"], {}

        sstate = restore(sstate)
        with collectives.data_parallel(mesh):
            local = sharding.local_batch(sharding.shard_batch(batch, mesh))
            loss, _, g = trainable_grads(loss_fn, sstate.params, labels, local)
        grads[policy] = [x.to_local().detach() for x in g]
        if policy == "full_again":
            del g, loss
            continue
        step = jit_step(make_stage1_step(c, tx, labels))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        sstate, m = step(TrainState(sstate.step, sstate.params, sstate.opt_state), batch)
        step_loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        launches = kernels.launch_counts()
        _check_launches(f"parallel stage1 {policy}", launches, TRAIN_LAUNCHES)
        runs[policy] = {"loss": loss.detach().clone(), "step_loss": step_loss, "step_s": step_s,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "grad_norm": m["grad_norm"].float().item()}
        del g, loss, m
    restore(sstate)
    def rel(name):
        return [grad_rel_err(d.reshape(-1, d.shape[-1]), f.reshape(-1, f.shape[-1]))
                for d, f in zip(grads[name], grads["full"], strict=True)]

    errs, spread = rel("dots"), rel("full_again")
    tol = max(PARALLEL_GRAD_TOL, 2 * max(spread))
    full, dots = runs["full"], runs["dots"]
    line = {"part": "stage1", "mesh": [1, 1, 1], "batch": B_TRAIN, "seq": S_TRAIN,
            "loss_bit_equal": torch.equal(full["loss"], dots["loss"]),
            "step_loss_bit_equal": full["step_loss"] == dots["step_loss"],
            "grad_rel_err": errs, "full_spread_grad_rel_err": spread, "grad_tol": tol,
            "trainable_leaves": len(errs),
            **{f"{p}_{k}": v for p, r in runs.items() for k, v in r.items() if k != "loss"},
            "launches_equal_train_launches": True, "s": time.perf_counter() - t0}
    must("parallel stage1", line["loss_bit_equal"] and line["step_loss_bit_equal"]
         and max(errs) <= tol, line)
    return line


def parallel_stage2(cfg, state, batch, training_cfg) -> dict:
    """Stage 2: one `jit_step(shard_train_state(...))` step against one
    unsharded step, both from the same snapshot of the stage-2 phase's
    trainable leaves and moments; the sharded step's launches are
    `STAGE2_LAUNCHES`, its loss and aux losses within check_stage2's gate
    of the unsharded step's."""
    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import (
        STAGE2_AUX,
        TrainState,
        jit_step,
        make_stage2_step,
        shard_train_state,
    )

    t0 = time.perf_counter()
    mesh = parallel_mesh()
    _, tx = train._schedule_and_optimizer(training_cfg, 2e-4, 5)
    labels = optim.trainable_labels(state.params, optim.STAGE2_LORA)
    restore = _snapshot(state, labels)
    keys = ("loss", "grad_norm", *STAGE2_AUX)
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, m = make_stage2_step(cfg, tx, labels)(
        TrainState(state.step, state.params, dict(state.opt_state)), batch)
    single = {k: m[k].float().item() for k in keys}
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    sstate = shard_train_state(restore(st), mesh, tx, labels)
    step = jit_step(make_stage2_step(cfg, tx, labels))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sstate, m = step(sstate, batch)
    sharded = {k: m[k].float().item() for k in keys}
    _check_launches("parallel stage2", kernels.launch_counts(), STAGE2_LAUNCHES)
    torch.cuda.synchronize()
    t = time.perf_counter()  # a second sharded step from the snapshot, warm
    sstate, m = step(restore(sstate), batch)
    again = {k: m[k].float().item() for k in keys}
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    restore(sstate)
    errs = {k: abs(sharded[k] - single[k]) / abs(single[k]) for k in keys}
    line = {"part": "stage2", "mesh": [1, 1, 1], "batch": B_STAGE2, "seq": S_STAGE2,
            "sharded": sharded, "single": single, "rel_err": errs, "tol": PARALLEL_STAGE2_TOL,
            "sharded_again_loss_equal": again["loss"] == sharded["loss"],
            "single_step_s": single_s, "sharded_step_s": step_s,
            "launches_equal_stage2_launches": True,
            "s": time.perf_counter() - t0}
    must("parallel stage2", max(errs.values()) <= PARALLEL_STAGE2_TOL, line)
    return line


def parallel_serve(cfg, params) -> dict:
    """`make_generate_fn` over the int8 serve's params sharded on the mesh
    (tp = 1): the int8 serve's B=16 requests, greedy; its tokens and
    lengths equal `serve`'s, its launches those of the unsharded
    generate, exactly."""
    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models import generate
    from ullava_tpu_torch.parallel import shard_params
    from ullava_tpu_torch.serve import collate, serve

    t0 = time.perf_counter()
    reqs = requests(cfg, B_INT8, PROMPT, np.random.default_rng(0))
    gc = generate.GenerateConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
    served = serve((cfg, params), reqs, "cuda", gc)["sequences"]
    batch = collate(reqs, "cuda")
    args = (batch["input_ids"], batch["prompt_lens"], batch["images"])
    core = params["core"]
    sharded = shard_params(core, parallel_mesh())
    fn = generate.make_generate_fn(cfg.core, gc)
    out = {}
    for name, run in (("plain", lambda: generate.generate(
            core, cfg.core, gc, input_ids=args[0], prompt_lens=args[1], images=args[2])),
                      ("sharded", lambda: fn(sharded, *args))):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t, kernels.launch_counts())
    got, gen_s, launches = out["sharded"]
    seqs = [got["sequences"][i, :n].tolist() for i, n in enumerate(got["lengths"].tolist())]
    line = {"part": "serve", "mesh": [1, 1, 1], "batch": B_INT8, "new_tokens": NEW_TOKENS,
            "tokens_equal_serve": seqs == served,
            "launches_equal_plain_generate": launches == out["plain"][2],
            "generate_s": out["plain"][1], "sharded_generate_s": gen_s,
            "launches": {k: v for k, v in launches.items() if v},
            "s": time.perf_counter() - t0}
    llm = ("fused_rotary", "flash_attention_fwd_bsh", "rms_norm_residual_quant",
           "silu_mul_quant", "prefill_quantize_write", "decode_attention_int8_fused_write",
           "rms_norm_fwd")
    must("parallel serve", line["tokens_equal_serve"] and line["launches_equal_plain_generate"]
         and all(launches[k] > 0 for k in llm), line)
    return line


def stage2_config():
    """The stage-2 model as `models/build.py` makes it from
    `configs/train/ullava_lora.yaml` with `quantize: 'int8_towers'`, at full
    width: CLIP ViT-L/14 (frozen), the MLP projector (frozen), LLaMA-7B in
    bf16 with remat per layer and the streamed CE (finetuning: no detach),
    SAM ViT-H (the image encoder's window layout the default, resident; the
    prompt encoder and mask decoder in fp32, as `sam_vit_h` leaves them),
    three mask and box slots, masks scored at the 1024 frame."""
    import torch

    from ullava_tpu_torch.models import clip_vit, llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import build as sam_build

    core = ullava_core.UllavaCoreConfig(
        llm=llama.LlamaConfig(vocab_size=32011, remat=True),
        vision=clip_vit.CLIPVisionConfig(), vision_hidden_layer=-2,
        img_start_id=32001, img_end_id=32002, vid_start_id=32004, vid_end_id=32005,
        projector_from_scratch=False, fused_ce=True,
    )
    return ullava.UllavaConfig(core=core, sam=sam_build.sam_vit_h(torch.bfloat16),
                               seg_token_idx=32007, loc_token_idx=32008,
                               max_masks=3, max_boxes=3, mask_loss_frame=1024)


# Launches of one stage-2 step at B=4: the LLM as in stage 1 (32 layers
# under remat); one weight-only SAM encode under no_grad in the resident
# layout without composite weights. Each of the 28 window blocks runs
# three class tensors (full 64 x 196, the merged right and bottom 32 x
# 112, corner 4 x 64): LN1+qkv and proj+residual on each (K10 weight-only
# 6 times), the window kernel on the full class, the boundary kernel on
# the other two; of their MLPs only the merged pair's 3584 rows clear the
# fused MLP's 512-row gate (12544 and 256 take the plain chain). The 4
# global blocks: LN1+qkv, proj+residual, lane-sliced attention (fp32
# exponentials) and the fused MLP. No int8-activation and no serving
# kernel launches.
STAGE2_LAUNCHES = {**{k: 0 for k in BF16_LAUNCHES}, "flash_attention_fwd_lse": 64,
                   **{k: 32 for k in FLASH_BWD_NAMES},
                   "rms_norm_bwd": 65, "rms_norm_fwd": 129,
                   "fused_window_attention_grid": 28, "fused_window_attention_rect": 28 * 2,
                   "fused_global_attention_y": 4, "fused_ln_linear_wq": 28 * 6 + 4 * 2,
                   "fused_mlp_block_wq": 28 + 4}
# The same encode with composite bias weights: the dual LN1+qkv on the
# three classes, the full class stored as 200 rows, so its 12800 rows
# clear the MLP's gate too.
WQ_ENCODE_LAUNCHES = {**{k: 0 for k in BF16_LAUNCHES}, "fused_window_attention_grid": 28,
                      "fused_window_attention_rect": 28 * 2, "fused_global_attention_y": 4,
                      "fused_ln_linear_dual_wq": 28 * 3, "fused_ln_linear_wq": 28 * 3 + 4 * 2,
                      "fused_mlp_block_wq": 28 * 2 + 4}


def _check_launches(phase, launches, expect):
    wrong = {k: (launches[k], n) for k, n in expect.items() if launches[k] != n}
    if wrong or set(expect) != set(launches):
        raise AssertionError(f"{phase}: launches (got, expected) {wrong}; all {launches}")


def stage2_train_phase(gen) -> tuple:
    """The stage-2 path: fresh full-width weights from the seeded
    generator, `train.build_stage2` (int8 towers, LoRA r=8 alpha 16 on
    q_proj and v_proj), one B=4, S=512 batch of `train.make_stage2_batch`
    (bench.py's layout: [SEG] and [LOC] after the image span, one valid
    mask and box slot of three), the `STAGE2_LORA` policy, AdamW lr 2e-4
    (constant after the schedule's one warmup step at 0), clip 1.0. One
    warm step with the launch counts set to 0 just before it and read just
    after (`STAGE2_LAUNCHES`), three timed steps, one profiled. Checks:
    finite losses, the last below the first; every frozen leaf
    bit-unchanged (int64 checksums of its bits); every adapter, the
    embeddings, lm_head and the three heads moved (the mask decoder's
    moved leaves are counted). Then
    `weight_only_encode_phase` on the same encoder. Returns both lines."""
    import math

    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.models import ullava
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import STAGE2_AUX

    cfg = stage2_config()
    t0 = time.perf_counter()
    params = ullava.init_params(cfg, gen, "cuda")
    cfg, params = train.build_stage2(cfg, params, quantize="int8_towers", lora_r=8, lora_alpha=16)
    batch = train.make_stage2_batch(cfg, B_STAGE2, S_STAGE2, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    state, step, _ = train.build_stage2_step(
        cfg, params, {"learning_rate": 2e-4, "lr_scheduler_type": "constant"}, total_steps=5)
    leaves = list(optim.named_leaves(state.params))
    trained = [(n, t) for n, t in leaves if t.requires_grad]
    frozen = [(n, t) for n, t in leaves if not t.requires_grad]
    frozen_before = [_fingerprint(t) for _, t in frozen]
    train_before = [t.detach().clone() for _, t in trained]

    def timed_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        vals = {k: m[k].float().item() for k in ("loss", "grad_norm", *STAGE2_AUX)}
        return vals, time.perf_counter() - t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    first, first_s = timed_step()
    launches = kernels.launch_counts()
    log(f"[stage2_train] launches of one step {json.dumps(launches)}")
    _check_launches("stage2_train", launches, STAGE2_LAUNCHES)
    runs = [timed_step() for _ in range(3)]
    metrics = [first] + [r[0] for r in runs]
    step_s = sorted(r[1] for r in runs)[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_serve(lambda: (None, timed_step()[1]))
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"stage2_train: non-finite metrics {metrics}")
    if not losses[-1] < losses[0] or min(m["grad_norm"] for m in metrics) <= 0:
        raise AssertionError(f"stage2_train: the loss did not fall: {metrics}")
    # (path, moved) of every trainable leaf; paths repeat across layers.
    moved = [(n, not torch.equal(a, t)) for a, (n, t) in zip(train_before, trained)]
    stuck = [n for n, m in moved if not m and not n.startswith("sam/mask_decoder")]
    if stuck or frozen_before != [_fingerprint(t) for _, t in frozen]:
        changed = [n for (n, t), fp in zip(frozen, frozen_before) if _fingerprint(t) != fp]
        raise AssertionError(f"stage2_train: not moved {stuck}, frozen changed {changed}")
    # The mask decoder's unused mask tokens and hypernetworks (one mask
    # output a prompt) and its attention key biases get no gradient.
    decoder = [m for n, m in moved if n.startswith("sam/mask_decoder")]
    busy = profile["device_busy_s"]
    line = {
        "phase": "stage2_train", "batch": B_STAGE2, "seq": S_STAGE2,
        "image_tokens": cfg.core.vision.num_patches, "mask_loss_frame": cfg.mask_loss_frame,
        "policy": "STAGE2_LORA", "lora_r": 8, "lora_scale": cfg.core.llm.lora_scale,
        "towers": "int8 weight-only", "lr": 2e-4, "clip": 1.0, "remat": True, "init_s": init_s,
        "first_step_s": first_s, "step_s": step_s, "step_runs_s": [r[1] for r in runs],
        "images_per_s": B_STAGE2 / step_s, "tokens_per_s": B_STAGE2 * S_STAGE2 / step_s,
        "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics],
        **{k: [m[k] for m in metrics] for k in STAGE2_AUX},
        "peak_mem_gb": peak_gb, "trainable_leaves": len(trained),
        "trainable_leaves_moved": sum(m for _, m in moved),
        "mask_decoder_leaves_moved": [sum(decoder), len(decoder)],
        "frozen_leaves_unchanged": len(frozen),
        "profiled_step_wall_s": profile["wall_s"], "device_busy_s": busy,
        "device_idle_share": profile["device_idle_share"],
        "watched_device_ms_calls": profile["watched_device_ms_calls"],
        "top_device_ms": dict(list(profile["top_device_ms"].items())[:8]),
        "top_device_calls": dict(list(profile["top_device_calls"].items())[:8]),
        "launches": launches,
    }
    print(json.dumps(line), flush=True)
    del step, leaves, trained, frozen, train_before
    line["parallel"] = parallel_stage2(cfg, state, batch,
                                       {"learning_rate": 2e-4, "lr_scheduler_type": "constant"})
    del state
    torch.cuda.empty_cache()
    encode_line = weight_only_encode_phase(cfg, params, batch["images_sam"])
    del params, batch
    torch.cuda.empty_cache()
    return line, encode_line


def weight_only_encode_phase(cfg, params, images_sam) -> dict:
    """One resident SAM encode with the int8 towers' weights, `mlp_w8a8`
    off and the composite bias weights (`precompute_window_bias_weights`):
    the path on which K13's weight-only form runs (`bench.py`'s serve with
    `BENCH_W8A8=0`). Launch counts set to 0 just before it and read just
    after (`WQ_ENCODE_LAUNCHES`); the embeddings finite, of their shape, and
    within 5e-2 of their largest value of the stage-2 step's encode (no
    composite weights: the standalone bias terms, in bf16). Three timed
    encodes of each, then one with composite weights under the profiler
    (its busy seconds and watched kernels: K13's GEMM)."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models.sam import image_encoder

    enc = params["sam"]["image_encoder"]
    vcfg = cfg.sam.vision
    t0 = time.perf_counter()
    with_bw = image_encoder.precompute_window_bias_weights(enc, vcfg)
    torch.cuda.synchronize()
    bias_weights_s = time.perf_counter() - t0

    def timed(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = image_encoder.encode(p, vcfg, images_sam)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    kernels.reset_launch_counts()
    emb, first_s = timed(with_bw)
    launches = kernels.launch_counts()
    _check_launches("weight_only_encode", launches, WQ_ENCODE_LAUNCHES)
    ref = image_encoder.encode(enc, vcfg, images_sam)
    err = ((emb.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    if tuple(emb.shape) != (B_STAGE2, 64, 64, 256) or not torch.isfinite(emb).all() or err > 5e-2:
        raise AssertionError(f"weight_only_encode: shape {tuple(emb.shape)}, rel err {err}")
    runs = [timed(with_bw)[1] for _ in range(3)]
    runs_plain = [timed(enc)[1] for _ in range(3)]
    prof = profile_serve(lambda: (None, timed(with_bw)[1]))
    line = {"phase": "weight_only_encode", "batch": B_STAGE2, "mlp_w8a8": False,
            "composite_bias_weights": True, "bias_weights_s": bias_weights_s,
            "first_encode_s": first_s, "encode_s": sorted(runs)[1], "encode_runs_s": runs,
            "encode_without_composite_s": sorted(runs_plain)[1],
            "rel_err_vs_without_composite": err, "launches": launches,
            "profiled_encode_wall_s": prof["wall_s"], "device_busy_s": prof["device_busy_s"],
            "watched_device_ms_calls": prof["watched_device_ms_calls"]}
    print(json.dumps(line), flush=True)
    del with_bw, emb, ref
    return line


# Kernels whose device time a profiled serve or training step reports
# whether or not they are among its top kernels: [ms, calls] of the kernels
# whose name holds the string (K1's and K7's kernels, old design and new;
# K8's kernel; K13's GEMM, whose row pass K10
# and K12 share; K10's GEMM (`::LinearEpi>`: no other epilogue's name ends
# so, `DualLinearEpi` has no `::` before `LinearEpi`) and its row pass
# without a LayerNorm (the proj form's; no other kernel takes it); K9 in
# both of its forms, the row staged in shared memory and the few-row one;
# the flash forward, K15 in training and K2 in serving; the flash
# backward's pre-pass, fused pass (K16) and dq finish (K17); K4 on the
# global core (its problem type's name); the weight-only kernels: the
# wgmma + TMA core's GEMMs (K10's, K12's and K13's), K13's alone (its
# epilogue form's name), and their bf16 LayerNorm row pass; K18's main
# kernel, not its dw reduce).
PROFILE_WATCH = {"rope": "rope_kernel", "kv_quant_write": "kv_quant_write_kernel",
                 "decode_attention_int8_fused_write": "fused_write_kernel",
                 "fused_ln_linear_dual_gemm": "DualLinearEpi",
                 "fused_ln_linear_gemm": "::LinearEpi>",
                 "fused_ln_linear_proj_row_pass": "ln_quant_rows_kernel<false>",
                 "rms_norm_fwd_staged": "rms_row_kernel<false, false>",
                 "rms_norm_fwd_few_rows": "rms_fwd_rows_kernel",
                 "flash_fwd_sm90_kernel": "flash_fwd_sm90_kernel",
                 "flash_attention_bwd_delta": "bwd::delta_kernel",
                 "flash_attention_bwd_dkv": "bwd::flash_bwd_kernel",
                 "flash_attention_bwd_dq": "bwd::dq_finish_kernel",
                 "fused_global_attention": "HeadMajorGlobal",
                 "wq_gemm_sm90": "wq_sm90::gemm_kernel",
                 "fused_ln_linear_dual_wq_gemm": "DualForm>",
                 "wq_ln_rows": "ln_rows_bf16_kernel", "rms_norm_bwd": "rms_bwd_kernel"}


def _dev_us(e):
    """A profiler entry's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def device_ms_a_call(fn, part: str, calls: int = 50) -> float:
    """Device time of one launch of the kernel whose name holds `part`, by
    the profiler over `calls` back-to-back calls of `fn` (the launch's
    latency and the timer's own cost left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if part in e.key]
    n = sum(e.count for e in events)
    return sum(_dev_us(e) for e in events) / 1e3 / n if n else "not measured"


def kernels_of_a_call(fn, calls: int = 20):
    """{kernel name: launches a call} of `fn`, by the profiler over `calls`
    back-to-back calls; "not measured" where the profiler saw no kernel
    (a short window after many profiled ones can come back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = {e.key: e.count / calls for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", "")) and _dev_us(e) > 0}
    return seen or "not measured"


def profile_serve(run, trace_path=None) -> dict:
    """One serve under torch.profiler: device kernel time by name and the
    device's busy share of the wall time (the profiler's own overhead
    lengthens the wall time, so the idle share is an upper bound). The
    device activity alone is recorded: the host's op events add nothing to
    these numbers, and on an H100 host they took about 30 s to process
    after a whole serve's profile, with the same busy time either way.
    With `trace_path`, the profile's Chrome trace is written there."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_s = run()
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)

    # Device-side entries only (kernels, copies): an aten op's entry
    # repeats the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", "")) and _dev_us(e) > 0]
    busy_s = sum(_dev_us(e) for e in events) / 1e6
    # Names are cut to 80 characters; kernels that then share a name
    # (elementwise kernels of different functors) are summed.
    ms, calls = {}, {}
    for e in events:
        ms[e.key[:80]] = ms.get(e.key[:80], 0.0) + _dev_us(e) / 1e3
        calls[e.key[:80]] = calls.get(e.key[:80], 0) + e.count
    top = sorted(ms, key=ms.get, reverse=True)[:12]
    watched = {label: [sum(_dev_us(e) for e in events if part in e.key) / 1e3,
                       sum(e.count for e in events if part in e.key)]
               for label, part in PROFILE_WATCH.items()}
    return {
        "phase": "profile", "wall_s": wall_s, "watched_device_ms_calls": watched,
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
    global kernels), the masks decoded from both embeddings, the same
    encoder packed (the two packed kernels; also against the unpacked
    encode on the card), and an int8
    SAM encoder in the block layout (the fused int8 linear, MLP and
    lane-sliced attention kernels) and in the resident layout (the dual
    LN1+qkv, the padded-window and boundary-window kernels), the latter
    also with int8 scores, beside a CLIP tower with W8A8 linears and flash
    attention at head_dim 64 (the all-int8 serve's forms)."""
    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench.stage2_grads import cpu_copy
    from ullava_tpu_torch.models import clip_vit, llama
    from ullava_tpu_torch.models.sam import build as sam_build
    from ullava_tpu_torch.models.sam import image_encoder
    from ullava_tpu_torch.ops import quant

    def rel_err(got, ref):
        return ((got.float().cpu() - ref).abs().max() / ref.abs().max()).item()

    rng = np.random.default_rng(1)
    errs = {}
    lcfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_layers=2, num_heads=2, num_kv_heads=2, attn_impl="flash")
    lp = llama.init_params(lcfg, gen, "cuda")
    ids = torch.as_tensor(rng.integers(0, 512, size=(2, 200)))
    lens = torch.tensor([200, 131], dtype=torch.int32)
    c32 = dataclasses.replace(lcfg, dtype=torch.float32)
    with torch.no_grad():
        got = llama.forward(lp, lcfg, input_ids=ids.cuda(), kv_lens=lens.cuda(),
                            kv_cache=llama.init_kv_cache(lcfg, 2, 200, device="cuda"))
        ref = llama.forward(cpu_copy(lp), c32, input_ids=ids, kv_lens=lens,
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
    qp32 = cpu_copy(qp)
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
        # A one-sample prompt of 12 tokens: its W8A8 products have 12 rows,
        # fewer than the library int8 product takes on the card, so
        # `quant.int8_matmul` pads them; then two decode steps.
        lens1 = torch.tensor([12], dtype=torch.int32)
        cache = llama.init_kv_cache(qcfg, 1, 14, device="cuda")
        cache32 = llama.init_kv_cache(q32, 1, 14, device="cpu")
        got = llama.forward(qp, qcfg, input_ids=ids[:1, :12].cuda(), kv_lens=lens1.cuda(),
                            kv_cache=cache)
        ref = llama.forward(qp32, q32, input_ids=ids[:1, :12], kv_lens=lens1, kv_cache=cache32)
        errs["int8_llama_12_token_prompt_hidden"] = rel_err(got["hidden_states"][0],
                                                            ref["hidden_states"][0])
        for i in range(2):
            pos = lens1 + i
            got = llama.forward(qp, qcfg, input_ids=toks[i, :1].cuda(),
                                positions=pos[:, None].cuda(), kv_lens=(pos + 1).cuda(),
                                kv_cache=cache, write_pos=pos.cuda())
            ref = llama.forward(qp32, q32, input_ids=toks[i, :1], positions=pos[:, None],
                                kv_lens=pos + 1, kv_cache=cache32, write_pos=pos)
            errs[f"int8_llama_12_token_prompt_decode_{i}_logits"] = rel_err(got["logits"],
                                                                            ref["logits"])
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
        sp32 = cpu_copy(sp)
        emb_ref = image_encoder.encode(sp32["image_encoder"], s32.vision, img)
        masks, _ = sam_build.forward_masks(sp, scfg, emb, text.cuda())
        masks_ref, _ = sam_build.forward_masks(sp32, s32, emb_ref, text)
    errs["sam_image_embeddings"] = rel_err(emb, emb_ref)
    errs["sam_low_res_masks"] = rel_err(masks, masks_ref)

    # The same encoder packed head-major (hp 128; block layout): its window
    # block through the packed window kernel, its global block through the
    # packed global kernel, against fp32 on the CPU from the same packed
    # weights, and against the unpacked encode on the card (the packing is
    # a relayout: the same function up to bf16 rounding).
    pp = image_encoder.pack_sam_attention(sp["image_encoder"], scfg.vision)
    before = kernels.launch_counts()
    with torch.no_grad():
        emb_p = image_encoder.encode(pp, scfg.vision, img.cuda())
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
        emb_p_ref = image_encoder.encode(cpu_copy(pp), s32.vision, img)
    if ran != {"fused_window_attention_packed": 1, "fused_global_attention_packed": 1}:
        raise AssertionError(f"the small packed SAM encoder launched {ran}")
    errs["packed_sam_image_embeddings"] = rel_err(emb_p, emb_p_ref)
    errs["packed_vs_unpacked_sam_image_embeddings"] = rel_err(emb_p, emb.float().cpu())
    del sp, sp32, emb, emb_ref, pp, emb_p, emb_p_ref

    # The int8 SAM encoder at the widths its kernels are built for (hd 80,
    # W 14, grid 64; 8 heads so that a head slab is 128-aligned; F 2560,
    # so the MLP's chunks are 512 wide): one window and one global block
    # through the fused int8 kernels on the card, against their plain
    # versions in fp32 on the CPU from the same int8 weights.
    v8 = image_encoder.SamVisionConfig(embed_dim=640, depth=2, num_heads=8, global_attn_indexes=(1,),
                                       out_chans=256, mlp_w8a8=True, window_layout="block")
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
            cpu_copy(ep), dataclasses.replace(v8, dtype=torch.float32), img)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    if ran != {"fused_window_attention_grid": 1, "fused_ln_linear": 2,
               "fused_global_attention_y": 1, "fused_mlp_block": 2}:
        raise AssertionError(f"the small int8 SAM encoder launched {ran}")
    errs["int8_sam_image_embeddings"] = rel_err(emb, emb_ref)

    # The same encoder in the resident layout with composite bias weights,
    # at B=4: the full class (12800 rows) and the merged right and bottom
    # classes (3584) clear the fused MLP's 512-row gate, the corner class
    # (256) takes the plain chain. Against fp32 on the CPU, and against
    # the block layout of the same weights on the card: the same function
    # up to rounding (bf16 activations into weight-only projections there,
    # int8 activations and int8 composite weights here), held to the same
    # 5e-2 of the largest value.
    vres = dataclasses.replace(v8, window_layout="auto")
    rp = image_encoder.precompute_window_bias_weights(ep, vres)
    img4 = torch.as_tensor(rng.standard_normal((4, 1024, 1024, 3)).astype(np.float32))
    before = kernels.launch_counts()
    with torch.no_grad():
        emb = image_encoder.encode(rp, vres, img4.cuda())
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
        emb_block = image_encoder.encode(rp, v8, img4.cuda())
        emb_ref = image_encoder.encode(
            cpu_copy(rp), dataclasses.replace(vres, dtype=torch.float32), img4)
    if ran != {"fused_ln_linear_dual": 3, "fused_window_attention_grid": 1,
               "fused_window_attention_rect": 2, "fused_ln_linear": 5,
               "fused_global_attention_y": 1, "fused_mlp_block": 3}:
        raise AssertionError(f"the small resident int8 SAM encoder launched {ran}")
    errs["resident_int8_sam_image_embeddings"] = rel_err(emb, emb_ref)
    errs["resident_vs_block_int8_sam_image_embeddings"] = rel_err(emb, emb_block.float().cpu())
    del emb, emb_block, emb_ref

    # The all-int8 serve's towers. The same resident encoder with int8
    # scores in its attention kernels (`attn_dots_i8`), and a CLIP tower at
    # ViT-L/14's head width and sequence (2 heads of 64, 257 tokens padded
    # to 264; two layers) with int8 weights, `a8` and flash attention, B=2;
    # each against fp32 on the CPU from the same weights.
    vi8 = dataclasses.replace(vres, attn_dots_i8=True)
    ccfg = clip_vit.CLIPVisionConfig(hidden_size=128, intermediate_size=512, num_layers=2,
                                     num_heads=2, a8=True, attn_impl="flash")
    cp = quant.quantize_tree(clip_vit.init_params(ccfg, gen, "cuda"), quant.CLIP_QUANT_KEYS)
    cimg = torch.as_tensor(rng.standard_normal((2, 224, 224, 3)).astype(np.float32))
    before = kernels.launch_counts()
    with torch.no_grad():
        emb = image_encoder.encode(rp, vi8, img4.cuda())
        hid = clip_vit.forward(cp, ccfg, cimg.cuda())["hidden_states"]
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
        emb_ref = image_encoder.encode(
            cpu_copy(rp), dataclasses.replace(vi8, dtype=torch.float32), img4)
        hid_ref = clip_vit.forward(
            cpu_copy(cp), dataclasses.replace(ccfg, dtype=torch.float32), cimg)["hidden_states"]
    if ran != {"fused_ln_linear_dual": 3, "fused_window_attention_grid_i8": 1,
               "fused_window_attention_rect_i8": 2, "fused_ln_linear": 5,
               "global_attention_y_quant_i8": 1, "fused_global_attention_y_i8": 1,
               "fused_mlp_block": 3,
               "flash_attention_fwd_bsh_hd64": 2}:
        raise AssertionError(f"the small all-int8 towers launched {ran}")
    errs["all_int8_sam_image_embeddings"] = rel_err(emb, emb_ref)
    errs["all_int8_clip_hidden_states"] = rel_err(hid, hid_ref)
    del rp, ep, emb, emb_ref, cp, hid, hid_ref
    check_stage1(gen, errs)
    check_stage2(gen, errs)
    # bf16 activations on the card against fp32 on the CPU; on the int8
    # path they also quantize to neighbouring int8 steps here and there.
    tol = 5e-2
    print(json.dumps({"phase": "check", "rel_err": errs, "tol": tol}), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference: {bad}")


def check_stage1(gen, errs: dict) -> None:
    """Stage 1 at hd 128 (LLaMA 2 x 256 wide, 2 heads; tiny CLIP): three
    steps on the card (bf16, through K15-K18 and K9) against the same
    steps in fp32 on the CPU (plain versions) from the same weights, under
    the pretraining and the finetuning policy (which trains the norm
    weights, so K18's dw form runs): the loss and the gradient norm of
    each step into `errs`. Then `train.train_stage1` end to end on the
    card: two epochs of two batches, checkpoints every two steps, and a
    resume that has nothing left to do."""
    import tempfile

    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.microbench.stage2_grads import cpu_copy
    from ullava_tpu_torch.models import clip_vit, llama, ullava_core
    from ullava_tpu_torch.training import checkpoint

    cfg = ullava_core.UllavaCoreConfig(
        llm=llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                              num_layers=2, num_heads=2, num_kv_heads=2, remat=True,
                              attn_impl="flash"),
        vision=clip_vit.CLIPVisionConfig.tiny(dtype=torch.bfloat16),
        img_start_id=500, img_end_id=501, vid_start_id=502, vid_end_id=503,
    )
    batch = train.make_batch(cfg, 2, 200, seed=1, device="cuda")
    batch["attn_lens"] = torch.tensor([200, 131], dtype=torch.int32, device="cuda")
    batch32 = {k: v.cpu() for k, v in batch.items()}
    tcfg = {"learning_rate": 1e-3, "lr_scheduler_type": "constant"}
    for policy, from_scratch in (("pretrain", True), ("finetune", False)):
        c = dataclasses.replace(cfg, projector_from_scratch=from_scratch)
        c32 = dataclasses.replace(
            c, llm=dataclasses.replace(c.llm, dtype=torch.float32),
            vision=dataclasses.replace(c.vision, dtype=torch.float32))
        params = ullava_core.init_params(c, gen, "cuda")
        state, step, _ = train.build_stage1(c, params, tcfg, 4)
        state32, step32, _ = train.build_stage1(c32, cpu_copy(params), tcfg, 4)
        before = kernels.launch_counts()
        for i in range(3):
            state, m = step(state, batch)
            state32, m32 = step32(state32, batch32)
            for key in ("loss", "grad_norm"):
                ref = m32[key].item()
                errs[f"stage1_{policy}_{key}_{i}"] = abs(m[key].float().item() - ref) / abs(ref)
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
        if ran != {"flash_attention_fwd_lse": 12, **{k: 6 for k in FLASH_BWD_NAMES},
                   "rms_norm_fwd": 27, "rms_norm_bwd": 15}:
            raise AssertionError(f"the small stage-1 step ({policy}) launched {ran}")
    with tempfile.TemporaryDirectory() as out:
        tcfg = {**tcfg, "num_train_epochs": 2, "save_steps": 2, "save_total_limit": 2,
                "output_dir": out}
        loader = train.SyntheticLoader([batch, batch32])
        final = train.train_stage1(cfg, ullava_core.init_params(cfg, gen, "cuda"), loader, tcfg)
        ckpts = checkpoint.list_checkpoints(out)
        resumed = train.train_stage1(cfg, ullava_core.init_params(cfg, gen, "cuda"), loader, tcfg)
        if final.step != 4 or ckpts != [2, 4] or resumed.step != 4:
            raise AssertionError(f"train_stage1: steps {final.step}, {resumed.step}; {ckpts}")


def check_stage2(gen, errs: dict) -> None:
    """Stage 2 on `microbench.stage2_grads.build`'s small model (the
    widths the SAM kernels are built for, one window and one global block;
    LLaMA at hd 128; int8 towers, LoRA r=8; B=2, S=200 with a short second
    row): three steps on the card (bf16, through the weight-only K10 and
    K12, K3, K14, K11, K15-K18, K9), exact launch counts.

    Each step is read twice against fp32 on the CPU (plain versions):
      - from shared parameters: before the step the CPU copy takes the
        card's current trainable leaves, and both sides take the loss and
        the gradients there (`stage2_step_loss_i`, `stage2_step_grad_norm_i`
        into `errs`; each leaf's relative error and sign agreement printed);
      - along the trajectory: the same three steps on the CPU from the
        starting weights (`stage2_loss_i` into `errs`; the trajectory's
        gradient norm printed, not gated). After one AdamW step each
        zero-initialised LoRA B element has moved by about lr whatever the
        size of its gradient, so the two trajectories' gradients part
        where bf16 and fp32 gradients differ in sign (PERF.md section 6)."""
    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.microbench import stage2_grads
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import stage2_loss, trainable_grads

    cfg, cfg32, params, batch, batch32 = stage2_grads.build(gen)
    tcfg = stage2_grads.TCFG
    shared32 = stage2_grads.cpu_copy(params)  # the CPU side of the per-step reading
    state32, step32, _ = train.build_stage2_step(cfg32, stage2_grads.cpu_copy(params), tcfg, 4)
    state, step, _ = train.build_stage2_step(cfg, params, tcfg, 4)
    labels = optim.trainable_labels(params, optim.STAGE2_LORA)
    names = stage2_grads.leaf_names(params, labels)
    loss_fn, loss_fn32 = stage2_loss(cfg), stage2_loss(cfg32)
    ran, readings, trajectory = {}, [], []
    for i in range(3):
        with torch.no_grad():
            for p32, p in zip(optim.partition_params(shared32, labels),
                              optim.partition_params(state.params, labels)):
                p32.copy_(p.float().cpu())
        loss, _, grads = trainable_grads(loss_fn, state.params, labels, batch)
        loss32, _, grads32 = trainable_grads(loss_fn32, shared32, labels, batch32)
        norm = optim.global_norm(grads).float().item()
        norm32 = optim.global_norm(grads32).item()
        errs[f"stage2_step_loss_{i}"] = abs(loss.float().item() - loss32.item()) / abs(loss32.item())
        errs[f"stage2_step_grad_norm_{i}"] = abs(norm - norm32) / abs(norm32)
        reading, _ = stage2_grads.step_reading(names, grads, grads32)
        readings.append({"step": i, "grad_norm": norm, "grad_norm_ref": norm32, **reading})
        del loss, loss32, grads, grads32
        before = kernels.launch_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        for k, n in kernels.launch_counts().items():
            if n != before[k]:
                ran[k] = ran.get(k, 0) + n - before[k]
        state32, m32 = step32(state32, batch32)
        ref = m32["loss"].item()
        errs[f"stage2_loss_{i}"] = abs(m["loss"].float().item() - ref) / abs(ref)
        ref = m32["grad_norm"].item()
        trajectory.append(abs(m["grad_norm"].float().item() - ref) / abs(ref))
    print(json.dumps({"phase": "check_stage2_steps", "per_step": readings,
                      "trajectory_grad_norm_rel_err": trajectory}), flush=True)
    # Per step: the window block's three classes (LN1+qkv, proj) and the
    # global block's two linears; only the global block's 8192 rows clear
    # the MLP's gate.
    if ran != {"fused_ln_linear_wq": 3 * 8, "fused_mlp_block_wq": 3, "fused_window_attention_grid": 3,
               "fused_window_attention_rect": 3 * 2, "fused_global_attention_y": 3,
               "flash_attention_fwd_lse": 12, **{k: 6 for k in FLASH_BWD_NAMES},
               "rms_norm_fwd": 27, "rms_norm_bwd": 15}:
        raise AssertionError(f"the small stage-2 step launched {ran}")


# ---------------------------------------------------------------------------
# The inference phase: checkpoint files -> build -> run_once.
# ---------------------------------------------------------------------------
INFERENCE_LLAMA_LAYERS = 4  # the depth cut; Vicuna-7B has 32
INFERENCE_NEW_TOKENS = 32
# Residual lanes of the written LLaMA that no layer writes: lane 5 holds
# 30.0 in the embedding of every id below TOY_IDS (the toy tokenizer's
# vocabulary) but [SEG], lane 9 in [SEG]'s, and lm_head reads lane 5 as
# [SEG] and lane 9 as [LOC]. So decoding answers [SEG] and [LOC] in turn
# and the masks and boxes are decoded. Ids from TOY_IDS on keep both
# lanes 0: the sampling gate's prompts draw from there, where the logits
# are the random model's. A fresh toy tokenizer gives [SEG] and [LOC]
# ids 10 and 11 once the build has added the 6 multimodal and the 4
# stage-2 tokens to its 4 specials.
SEG_LANE, LOC_LANE, LANE_VALUE, TOY_IDS, SEG_ID, LOC_ID = 5, 9, 30.0, 64, 10, 11
# The rows that one image (B=1) gives the weight-only K10 in the SAM
# encode: the 16 full windows' 3136, the merged right and bottom classes'
# 896 (8 windows of 14 x 8), the corner's 64 (less than one M tile), and a
# global block's 4096 (K12's only row count there: no window class reaches
# the fused MLP's 512-row gate).
INFERENCE_CLASS_ROWS = (3136, 896, 64, 4096)
# The greedy comparison's new tokens: [SEG] and [LOC] four times each, so
# every one of the three masks and boxes is read out.
INFERENCE_CHECK_TOKENS = 8
# A deliberate bug in the kernel sources that the inference path runs;
# the greedy comparison of the card with the CPU must fail on each copy.
# K2's and K11's (`K2_MUTANTS`, `GLOBAL_Y_MUTANTS`) move that comparison
# by less than its tolerance (the random model's attention is close to
# uniform), so `inference_kernel_gates` catches them at the path's shapes.
INFERENCE_MUTANTS = {
    "fused_rotary partner_sign": K1_MUTANTS["partner_sign"],
    "prefill_quantize_write half_lanes_amax": K7_MUTANTS["half_lanes_amax"],
    "decode_attention_int8_fused_write split_last_tile_left_out":
        K8_MUTANTS["split_last_tile_left_out"],
    "rms_norm_fwd warp_partial_left_out": K9_MUTANTS["warp_partial_left_out"],
    "fused_window_attention_grid quad_max_dropped":
        QUAD_MAX_MUTANTS["sam_window_attention.cu"],
    "fused_window_attention_rect pad_out_of_sum": RECT_PAD_MUTANT,
    "fused_ln_linear_wq weight_widened_unsigned": WQ_MUTANTS["ln_linear_wq.cu"],
    "fused_mlp_block_wq weight_widened_unsigned": WQ_MUTANTS["mlp_block_wq.cu"],
}


def _vicuna_config():
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
            "num_hidden_layers": INFERENCE_LLAMA_LAYERS, "num_attention_heads": 32,
            "num_key_value_heads": 32, "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0, "hidden_act": "silu", "torch_dtype": "bfloat16"}


def _clip_l14_config():
    return {"architectures": ["CLIPVisionModel"], "model_type": "clip_vision_model",
            "hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
            "num_attention_heads": 16, "image_size": 224, "patch_size": 14,
            "layer_norm_eps": 1e-5, "projection_dim": 768, "torch_dtype": "bfloat16"}


def _llama_specs(c):
    """(name, shape, init) of an HF LlamaForCausalLM state dict."""
    D, F_, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    out = [("model.embed_tokens.weight", (V, D), "normal")]
    for i in range(c["num_hidden_layers"]):
        b = f"model.layers.{i}."
        out += [(b + "input_layernorm.weight", (D,), "ones"),
                *[(b + f"self_attn.{n}_proj.weight", (D, D), "normal") for n in "qkvo"],
                (b + "post_attention_layernorm.weight", (D,), "ones"),
                (b + "mlp.gate_proj.weight", (F_, D), "normal"),
                (b + "mlp.up_proj.weight", (F_, D), "normal"),
                (b + "mlp.down_proj.weight", (D, F_), "normal")]
    return out + [("model.norm.weight", (D,), "ones"), ("lm_head.weight", (V, D), "normal")]


def _clip_specs(c):
    """(name, shape, init) of an HF CLIPVisionModel state dict."""
    D, F_, p = c["hidden_size"], c["intermediate_size"], c["patch_size"]
    v = "vision_model."
    out = [(v + "embeddings.class_embedding", (D,), "normal"),
           (v + "embeddings.patch_embedding.weight", (D, 3, p, p), "normal"),
           (v + "embeddings.position_embedding.weight", ((c["image_size"] // p) ** 2 + 1, D),
            "normal"),
           (v + "pre_layrnorm.weight", (D,), "ones"), (v + "pre_layrnorm.bias", (D,), "zeros")]
    for i in range(c["num_hidden_layers"]):
        b = f"{v}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            out += [(b + n + ".weight", (D,), "ones"), (b + n + ".bias", (D,), "zeros")]
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(b + f"self_attn.{n}.weight", (D, D), "normal"),
                    (b + f"self_attn.{n}.bias", (D,), "zeros")]
        out += [(b + "mlp.fc1.weight", (F_, D), "normal"), (b + "mlp.fc1.bias", (F_,), "zeros"),
                (b + "mlp.fc2.weight", (D, F_), "normal"), (b + "mlp.fc2.bias", (D,), "zeros")]
    return out + [(v + "post_layernorm.weight", (D,), "ones"),
                  (v + "post_layernorm.bias", (D,), "zeros")]


# (embed, depth, heads, global blocks) of Meta's three SAM image encoders
# (`build_sam.py`; the port's `models/sam/build.py`).
SAM_SIZES = {"vit_h": (1280, 32, 16, (7, 15, 23, 31)), "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
             "vit_b": (768, 12, 12, (2, 5, 8, 11))}


def sam_meta_specs(C, depth, heads, global_idx):
    """(name, shape, init) of Meta's SAM state dict (`sam_vit_h_4b8939.pth`
    and its ViT-L and ViT-B siblings): every key the released files have,
    for an image encoder of width C, `depth` blocks of `heads` heads and
    the global blocks `global_idx` on the 64 x 64 grid (`SAM_SIZES` gives
    the released three); prompt and decoder width 256."""
    g, hd, O = 64, C // heads, 256
    out = [("image_encoder.pos_embed", (1, g, g, C), "normal"),
           ("image_encoder.patch_embed.proj.weight", (C, 3, 16, 16), "normal"),
           ("image_encoder.patch_embed.proj.bias", (C,), "zeros")]
    for i in range(depth):
        b = f"image_encoder.blocks.{i}."
        rel = 2 * (g if i in global_idx else 14) - 1
        out += [(b + "norm1.weight", (C,), "ones"), (b + "norm1.bias", (C,), "zeros"),
                (b + "attn.qkv.weight", (3 * C, C), "normal"), (b + "attn.qkv.bias", (3 * C,), "zeros"),
                (b + "attn.proj.weight", (C, C), "normal"), (b + "attn.proj.bias", (C,), "zeros"),
                (b + "attn.rel_pos_h", (rel, hd), "normal"), (b + "attn.rel_pos_w", (rel, hd), "normal"),
                (b + "norm2.weight", (C,), "ones"), (b + "norm2.bias", (C,), "zeros"),
                (b + "mlp.lin1.weight", (4 * C, C), "normal"), (b + "mlp.lin1.bias", (4 * C,), "zeros"),
                (b + "mlp.lin2.weight", (C, 4 * C), "normal"), (b + "mlp.lin2.bias", (C,), "zeros")]
    out += [("image_encoder.neck.0.weight", (O, C, 1, 1), "normal"),
            ("image_encoder.neck.1.weight", (O,), "ones"), ("image_encoder.neck.1.bias", (O,), "zeros"),
            ("image_encoder.neck.2.weight", (O, O, 3, 3), "normal"),
            ("image_encoder.neck.3.weight", (O,), "ones"), ("image_encoder.neck.3.bias", (O,), "zeros")]
    pe, md = "prompt_encoder.", "prompt_encoder.mask_downscaling."
    out += [(pe + "pe_layer.positional_encoding_gaussian_matrix", (2, O // 2), "gaussian"),
            *[(pe + f"point_embeddings.{i}.weight", (1, O), "normal") for i in range(4)],
            (pe + "not_a_point_embed.weight", (1, O), "normal"),
            (md + "0.weight", (4, 1, 2, 2), "normal"), (md + "0.bias", (4,), "zeros"),
            (md + "1.weight", (4,), "ones"), (md + "1.bias", (4,), "zeros"),
            (md + "3.weight", (16, 4, 2, 2), "normal"), (md + "3.bias", (16,), "zeros"),
            (md + "4.weight", (16,), "ones"), (md + "4.bias", (16,), "zeros"),
            (md + "6.weight", (O, 16, 1, 1), "normal"), (md + "6.bias", (O,), "zeros"),
            (pe + "no_mask_embed.weight", (1, O), "normal")]

    def lin(name, i, o):
        return [(name + ".weight", (o, i), "normal"), (name + ".bias", (o,), "zeros")]

    def ln(name, n=O):
        return [(name + ".weight", (n,), "ones"), (name + ".bias", (n,), "zeros")]

    def attn(name, inner):
        return (lin(name + ".q_proj", O, inner) + lin(name + ".k_proj", O, inner)
                + lin(name + ".v_proj", O, inner) + lin(name + ".out_proj", inner, O))

    tr, dd = "mask_decoder.transformer.", "mask_decoder."
    for i in range(2):
        b = f"{tr}layers.{i}."
        out += (attn(b + "self_attn", O) + ln(b + "norm1")
                + attn(b + "cross_attn_token_to_image", O // 2) + ln(b + "norm2")
                + lin(b + "mlp.lin1", O, 2048) + lin(b + "mlp.lin2", 2048, O) + ln(b + "norm3")
                + ln(b + "norm4") + attn(b + "cross_attn_image_to_token", O // 2))
    out += attn(tr + "final_attn_token_to_image", O // 2) + ln(tr + "norm_final_attn")
    out += [(dd + "iou_token.weight", (1, O), "normal"), (dd + "mask_tokens.weight", (4, O), "normal"),
            (dd + "output_upscaling.0.weight", (O, O // 4, 2, 2), "normal"),
            (dd + "output_upscaling.0.bias", (O // 4,), "zeros"), *ln(dd + "output_upscaling.1", O // 4),
            (dd + "output_upscaling.3.weight", (O // 4, O // 8, 2, 2), "normal"),
            (dd + "output_upscaling.3.bias", (O // 8,), "zeros")]
    for i in range(4):
        b = f"{dd}output_hypernetworks_mlps.{i}.layers."
        out += lin(b + "0", O, O) + lin(b + "1", O, O) + lin(b + "2", O, O // 8)
    b = dd + "iou_prediction_head.layers."
    return out + lin(b + "0", O, O) + lin(b + "1", O, O) + lin(b + "2", O, 4)


def _draw(spec, dtype, gen):
    """One tensor of a written checkpoint, drawn on the card: std 0.02
    normal weights (the random-Fourier matrix std 1), norm scales 1,
    biases 0; returned on the host."""
    import torch

    name, shape, init = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    std = 1.0 if init == "gaussian" else 0.02
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype).cpu()


def _seg_loc_lanes(name, t):
    """The lanes of `SEG_LANE` / `LOC_LANE` in one LLaMA tensor (see there)."""
    if name == "model.embed_tokens.weight":
        t[:, [SEG_LANE, LOC_LANE]] = 0
        t[:TOY_IDS, SEG_LANE] = LANE_VALUE
        t[SEG_ID, SEG_LANE], t[SEG_ID, LOC_LANE] = 0, LANE_VALUE
    elif name == "lm_head.weight":  # [V, D]
        t[:, [SEG_LANE, LOC_LANE]] = 0
        t[SEG_ID, SEG_LANE], t[LOC_ID, LOC_LANE] = 5.0, 5.0
    elif name.endswith(("o_proj.weight", "down_proj.weight")):
        t[[SEG_LANE, LOC_LANE]] = 0  # [out, in]: no layer writes the lanes
    return t


def write_safetensors(path, specs, dtype, gen, edit=lambda name, t: t) -> None:
    """A `.safetensors` file written tensor by tensor (an 8-byte
    little-endian header length, the JSON header, the raw bytes)."""
    import struct

    import torch

    header, off = {}, 0
    for name, shape, _ in specs:
        n = dtype.itemsize
        for s in shape:
            n *= s
        header[name] = {"dtype": {torch.bfloat16: "BF16", torch.float32: "F32"}[dtype],
                        "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for spec in specs:
            t = edit(spec[0], _draw(spec, dtype, gen)).contiguous()
            f.write(memoryview(t.view(torch.uint8).numpy()))


def write_inference_checkpoints(root, gen) -> dict:
    """The checkpoint set of the inference phase under `root`: `llm/`
    (Vicuna-7B's widths cut to `INFERENCE_LLAMA_LAYERS` layers, bf16
    safetensors), `clip/` (ViT-L/14-224, 24 layers, bf16 safetensors) and
    `sam_vit_h.pth` (Meta's key names, ViT-H, fp32 as released)."""
    import os

    import torch

    os.makedirs(os.path.join(root, "llm"))
    os.makedirs(os.path.join(root, "clip"))
    llm_cfg, clip_cfg = _vicuna_config(), _clip_l14_config()
    for d, c in (("llm", llm_cfg), ("clip", clip_cfg)):
        with open(os.path.join(root, d, "config.json"), "w") as f:
            json.dump(c, f)
    write_safetensors(os.path.join(root, "llm", "model.safetensors"), _llama_specs(llm_cfg),
                      torch.bfloat16, gen, _seg_loc_lanes)
    write_safetensors(os.path.join(root, "clip", "model.safetensors"), _clip_specs(clip_cfg),
                      torch.bfloat16, gen)
    sam_path = os.path.join(root, "sam_vit_h.pth")
    torch.save({s[0]: _draw(s, torch.float32, gen) for s in sam_meta_specs(*SAM_SIZES["vit_h"])},
               sam_path)
    return {"llm_path": os.path.join(root, "llm"), "vision_encoder": os.path.join(root, "clip"),
            "sam_path": sam_path}


def check_converters(paths) -> dict:
    """Load each written file and convert it on the card (timed apart),
    then hold one converted linear of each tower to its source tensor,
    transposed, exactly (the SAM source cast to the build's bf16)."""
    import torch

    from ullava_tpu_torch.models.sam import build as sam_build
    from ullava_tpu_torch.models.sam.convert import convert_sam
    from ullava_tpu_torch.models.weights import (convert_clip_vision, convert_llama,
                                                 load_state_dict)

    t0 = time.perf_counter()
    sds = {k: load_state_dict(p) for k, p in paths.items()}
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    llm = convert_llama(sds["llm_path"], INFERENCE_LLAMA_LAYERS, torch.bfloat16, device="cuda")
    clip = convert_clip_vision(sds["vision_encoder"], 24, torch.bfloat16, device="cuda")
    sam = convert_sam(sds["sam_path"], sam_build.sam_vit_h(torch.bfloat16), device="cuda")
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    pairs = {
        "llama_layer3_q_proj": (llm["layers"][3]["q_proj"],
                                sds["llm_path"]["model.layers.3.self_attn.q_proj.weight"]),
        "clip_layer23_fc1": (clip["layers"][23]["fc1"],
                             sds["vision_encoder"]["vision_model.encoder.layers.23.mlp.fc1.weight"]),
        "sam_block31_qkv": (sam["image_encoder"]["global_blocks"][3]["qkv"],
                            sds["sam_path"]["image_encoder.blocks.31.attn.qkv.weight"]),
    }
    for name, (got, src) in pairs.items():
        must(f"convert {name}", torch.equal(got.cpu(), src.to(torch.bfloat16).t()),
             "the converted leaf is not the transposed source")
    return {"load_s": load_s, "convert_s": convert_s, "leaves_checked": sorted(pairs),
            "file_gb": {k: sum(t.numel() * t.element_size() for t in sd.values()) / 1e9
                        for k, sd in sds.items()}}


@contextlib.contextmanager
def recording(module, name, sink):
    """Route `module.name` through a wrapper that keeps its last result and
    host wall time in `sink` for the `with` block."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        sink[name] = orig(*args, **kwargs)
        sink[name + "_s"] = time.perf_counter() - t0
        return sink[name]

    setattr(module, name, wrapper)
    try:
        yield sink
    finally:
        setattr(module, name, orig)


def _kernel_gate(out: dict, tol: float):
    """`gate(name, run, ref, mutants, inputs=None)`: `run()` within `tol`
    of `ref` by `row_rel_err`, and outside it under each of `mutants` (bug:
    (source, define)) and of `inputs` (bug: a run on mutated inputs); the
    readings go into `out[name]` and come back with the limit."""
    from ullava_tpu_torch import kernels

    def gate(name, run, ref, mutants, inputs=None):
        err = row_rel_err(run(), ref)
        must(name, err <= tol, err)
        caught = {}
        for bug, src_define in mutants.items():
            with kernels.mutant(*src_define):
                e = row_rel_err(run(), ref)
            caught[bug] = must_not(name, bug, e <= tol, e)
        for bug, bad in (inputs or {}).items():
            e = row_rel_err(bad(), ref)
            caught[bug] = must_not(name, bug, e <= tol, e)
        out[name] = {"row_rel_err": err, "mutant_row_rel_err": caught}
        return {**out[name], "tol": tol}

    return gate


def _wq_mutants(src, widen):
    return {"weight_widened_unsigned": WQ_MUTANTS[src],
            "scale_by_token": WQ_EPILOGUE_MUTANTS[src],
            **({"widen_bias_off_by_one": WQ_WIDEN_MUTANTS[src]} if widen else {})}


def sam_encode_gates(gen, gate, class_rows, mlp_rows, images) -> None:
    """The kernels of a weight-only ViT-H encode (resident layout, no
    composite weights) at the shapes it gives them, each by `gate`: K10 in
    both forms (LN1 + qkv; proj + residual) at each of `class_rows`, K12 at
    each of `mlp_rows`, and for each batch of `images` K3 on its full
    windows (16 an image), K14 on its merged right and bottom windows (4 +
    4 an image) and on its corners, K11 on its global blocks (fp32
    exponentials: `mlp_w8a8` is off)."""
    import torch

    from ullava_tpu_torch.ops import mlp_kernel, quant, sam_attention

    dev, bf, eps = "cuda", torch.bfloat16, 1e-6
    C, H, hd, W = SAM_C, SAM_H, SAM_HD, SAM_W
    sc = hd**-0.5
    kw = dict(num_heads=H, head_dim=hd, scale=sc)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(bf)

    def weight(K, N):
        leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * 0.05)
        return leaf["q"], leaf["scale"]

    x = randn(max(class_rows + mlp_rows), C, scale=2.0, shift=0.3)
    g, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
    for form, N, ln in (("ln_qkv", 3 * C, True), ("proj_residual", C, False)):
        w, s = weight(C, N)
        bias = randn(N, scale=0.5)
        res = None if ln else randn(x.shape[0], N)
        lg, lb = (g, b) if ln else (None, None)
        for T in class_rows:
            r = None if res is None else res[:T]
            gate(f"fused_ln_linear_wq {form} {T}",
                 lambda T=T, r=r: mlp_kernel.fused_ln_linear(
                     x[:T], lg, lb, w, s, bias, eps, w8a8=False, residual=r),
                 mlp_kernel._ln_linear_parts_plain(x[:T], lg, lb, w, s, bias, eps, False, r)[0],
                 _wq_mutants("ln_linear_wq.cu", not ln))
        del res

    (w1, s1), (w2, s2) = weight(C, 4 * C), weight(4 * C, C)
    b1, b2 = randn(4 * C, scale=0.5), randn(C, scale=0.5)
    for T in mlp_rows:
        args = (x[:T], g, b, w1, s1, b1, w2, s2, b2, eps)
        gate(f"fused_mlp_block_wq {T}", lambda a=args: mlp_kernel.fused_mlp_block(*a, w8a8=False),
             mlp_kernel._mlp_block_parts_plain(*args, 1024, False)[0],
             _wq_mutants("mlp_block_wq.cu", True))
    del x, w1, w2, args

    for B in images:
        y = randn(16 * B, W * W, 3 * C)
        a, bb = (randn(16 * B, W * W, H * W, scale=2.0 / sc) for _ in range(2))
        gate(f"fused_window_attention_grid {16 * B} x 196",
             lambda y=y, a=a, bb=bb: sam_attention.fused_window_attention_grid(
                 y, a, bb, **kw, window=W),
             sam_attention.fused_window_attention_grid_plain(y, a, bb, H, hd, W, sc),
             {"quad_max_dropped": QUAD_MAX_MUTANTS["sam_window_attention.cu"]})

    qkv_bias = randn(3 * C, scale=0.5)
    for form, geoms, per in (("edge_pair", [(14, 8), (8, 14)], 4), ("corner", [(8, 8)], 1)):
        for B in images:
            y, a, bb, tables = rect_case(gen, geoms, per * B, qkv_bias)[:4]
            geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
            gate(f"fused_window_attention_rect {form} {y.shape[0]} x {y.shape[1]}",
                 lambda y=y, a=a, bb=bb, t=tables, g_=geometry:
                     sam_attention.fused_window_attention_rect(
                         y, a, bb, *t, **kw, window=W, geometry=g_),
                 sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, H, hd, W, sc),
                 {"pad_out_of_sum": RECT_PAD_MUTANT,
                  "quad_max_dropped": QUAD_MAX_MUTANTS["sam_rect_attention.cu"]})

    G = 64
    for B in images:
        y = randn(B, G * G, 3 * C)
        a, bb = (randn(B, G * G, H, G, scale=2.0 / sc) for _ in range(2))
        gate(f"fused_global_attention_y {B} x 4096",
             lambda y=y, a=a, bb=bb: sam_attention.fused_global_attention_y(
                 y, a, bb, **kw, window=G),
             sam_attention.fused_global_attention_y_plain(y, a, bb, **kw, window=G),
             GLOBAL_Y_MUTANTS)
    del y, a, bb
    torch.cuda.empty_cache()


def inference_kernel_gates(gen, prompt_len: int) -> dict:
    """Kernels at the shapes that one image (B=1) gives them on the
    inference path, each against its plain version by `row_rel_err`
    within 1e-2: K2 on the prompt's `prompt_len` tokens (32 heads of 128,
    causal), and the SAM encoder's (`sam_encode_gates`): the weight-only
    K10 in both forms at `INFERENCE_CLASS_ROWS`, the weight-only K12 at
    4096 rows, K3 on the 16 full windows (196 rows, no pad rows), K14 on
    the merged right and bottom windows (4 + 4) and on the corner, and K11
    on one global block. Each gate must reject copies of its source built
    with a deliberate bug (K10 and K12: `WQ_MUTANTS`, `WQ_EPILOGUE_MUTANTS`,
    and for the proj form and K12 `WQ_WIDEN_MUTANTS`; K3 and K14
    `QUAD_MAX_MUTANTS`, K14 also `RECT_PAD_MUTANT`; K11 `GLOBAL_Y_MUTANTS`;
    K2 its causal mask one key late: its other mutant, the kv_len edge
    tile masked at its end, leaves a prompt that fills its rows
    unchanged)."""
    import torch

    from ullava_tpu_torch.ops import attention

    tol = 1e-2
    out = {"tol": tol}
    gate = _kernel_gate(out, tol)
    q, k, v = ((torch.randn((1, prompt_len, 32, 128), generator=gen, device="cuda"))
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor([prompt_len], device="cuda", dtype=torch.int32)
    gate(f"flash_attention_fwd_bsh 1 x {prompt_len}",
         lambda: attention.flash_attention_fwd_bsh(q, k, v, lens, causal=True, scale=128**-0.5),
         attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=128**-0.5),
         {"causal_mask_shifted": K2_MUTANTS["causal_mask_shifted"]})
    del q, k, v
    sam_encode_gates(gen, gate, INFERENCE_CLASS_ROWS, (4096,), (1,))
    return out


def fp32_config(u_cfg):
    """`u_cfg` with every tower computing in fp32 (the CPU reference)."""
    import torch

    r = dataclasses.replace
    f32 = torch.float32
    core = r(u_cfg.core, llm=r(u_cfg.core.llm, dtype=f32), vision=r(u_cfg.core.vision, dtype=f32))
    return r(u_cfg, core=core, sam=r(u_cfg.sam, vision=r(u_cfg.sam.vision, dtype=f32)))


def greedy_readout(params, u_cfg, inputs) -> dict:
    """Greedy `generate` and `ullava.evaluate` (`INFERENCE_CHECK_TOKENS`
    new tokens) on `inputs`, on the device the tensors lie on. Returns on
    the host: the tokens, the last layer's hidden rows that produced each
    [SEG] and [LOC] without the two lanes that `_seg_loc_lanes` fixes, and
    the valid masks (low-res), boxes and IoU predictions."""
    import torch

    from ullava_tpu_torch.models import generate, ullava

    gc = generate.GenerateConfig(max_new_tokens=INFERENCE_CHECK_TOKENS, temperature=0.0)
    with torch.no_grad():
        g = generate.generate(params["core"], u_cfg.core, gc, input_ids=inputs["input_ids"],
                              prompt_lens=inputs["prompt_lens"], images=inputs["images"])
        out = ullava.evaluate(params, u_cfg, gc, **inputs)
    lanes = torch.ones(g["hidden_last"].shape[-1], dtype=torch.bool, device=g["hidden_last"].device)
    lanes[[SEG_LANE, LOC_LANE]] = False
    got = {"sequences": out["sequences"][0].cpu()}
    for name, idx, n in (("seg", u_cfg.seg_token_idx, u_cfg.max_masks),
                         ("loc", u_cfg.loc_token_idx, u_cfg.max_boxes)):
        h, ok = generate.readout_token_hidden(g["sequences"], g["hidden_last"], g["lengths"], idx, n)
        got[name + "_hidden"] = h[ok][:, lanes].float().cpu()
    n_seg, n_loc = int(out["seg_valid"][0].sum()), int(out["loc_valid"][0].sum())
    got["low_res_masks"] = out["low_res_masks"][0, :n_seg].float().cpu()
    got["iou_pred"] = out["iou_pred"][0, :n_seg].float().cpu()
    got["pred_boxes"] = out["pred_boxes"][0, :n_loc].float().cpu()
    return got


def readout_errs(got, ref) -> dict:
    """max|got - ref| / max|ref| of each readout (inf where the tokens or
    the shapes differ)."""
    import torch

    if got["sequences"].shape != ref["sequences"].shape or not torch.equal(
            got["sequences"], ref["sequences"]):
        return {"sequences": float("inf")}
    return {k: ((got[k] - ref[k]).abs().max() / ref[k].abs().max()).item()
            if got[k].shape == ref[k].shape and got[k].numel() else float("inf")
            for k in ref if k != "sequences"}


def reference_gate(u_cfg, params, inputs) -> dict:
    """The built model on the card against the port's plain path in fp32 on
    the CPU, from the same weights and inputs (`greedy_readout`): the same
    tokens, and the [SEG] / [LOC] hidden rows, masks, boxes and IoU each
    within 5e-2 of its largest value (bf16 activations on the card, as
    `check_phase` holds them, over 4 LLaMA layers, 24 CLIP and 32 SAM
    blocks). Then one greedy run on the card per copy of a kernel source
    built with a deliberate bug (`INFERENCE_MUTANTS`): each must fail."""
    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench.stage2_grads import cpu_copy

    tol = 5e-2
    got = greedy_readout(params, u_cfg, inputs)
    t0 = time.perf_counter()
    ref = greedy_readout(cpu_copy(params), fp32_config(u_cfg), {k: v.cpu() for k, v in inputs.items()})
    cpu_s = time.perf_counter() - t0
    must("inference readout", got["low_res_masks"].shape[0] == 3 and got["pred_boxes"].shape[0] == 3,
         {k: tuple(v.shape) for k, v in got.items()})
    errs = readout_errs(got, ref)
    must("inference card against the CPU", all(e <= tol for e in errs.values()), errs)
    caught = {}
    for bug, src_define in INFERENCE_MUTANTS.items():
        with kernels.mutant(*src_define):
            m = readout_errs(greedy_readout(params, u_cfg, inputs), ref)
        caught[bug] = must_not("inference card against the CPU", bug,
                               all(e <= tol for e in m.values()), m)
    return {"rel_err": errs, "tol": tol, "cpu_reference_s": cpu_s, "mutant_rel_err": caught}


def inference_launches(steps: int) -> dict:
    """Launches of one `run_once` on the built model: the LLaMA's prefill
    (rotary on q and k, the flash forward and the int8 cache write per
    layer, and its 2 L + 1 RMSNorms) and `steps` decode steps (2 L + 1
    RMSNorms and one write-and-attend per layer; weight-only int8
    linears, no W8A8 kernel), and one SAM ViT-H encode with int8 weights
    (weight-only) in the resident layout without composite bias weights,
    as the stage-2 step's (`STAGE2_LAUNCHES`) at one image."""
    L = INFERENCE_LLAMA_LAYERS
    return {**{k: 0 for k in BF16_LAUNCHES}, "fused_rotary": 2 * L, "flash_attention_fwd_bsh": L,
            "prefill_quantize_write": L, "rms_norm_fwd": (2 * L + 1) * (1 + steps),
            "decode_attention_int8_fused_write": L * steps,
            "fused_window_attention_grid": 28, "fused_window_attention_rect": 28 * 2,
            "fused_global_attention_y": 4, "fused_ln_linear_wq": 28 * 6 + 4 * 2,
            "fused_mlp_block_wq": 4}


def sampling_gate(cfg, params, rows: int = 4, draws: int = 4096) -> dict:
    """Sampling on the card: the last-step logits of `rows` prompts (ids
    from `TOY_IDS` on, so the random model's own logits), then `draws`
    draws of each row at temperature 0.2, top-p 0.9 from a seeded CUDA
    generator. Every id drawn lies in the nucleus that the plain function
    computes on the CPU from the same logits, and the counts pass a
    chi-square test against the nucleus probabilities (bins under 5
    expected draws merged; all rows' statistics summed) at p >= 1e-3."""
    import numpy as np
    import torch

    from ullava_tpu_torch.models import generate, llama

    gc = generate.GenerateConfig(temperature=0.2, top_p=0.9)
    ids = torch.as_tensor(np.random.default_rng(3).integers(TOY_IDS, 32000, size=(rows, 64)),
                          device="cuda")
    with torch.no_grad():
        logits = llama.forward(params["core"]["llm"], cfg.core.llm, input_ids=ids)["logits"]
    logits = logits[:, -1].float()
    gen = torch.Generator(device="cuda").manual_seed(5)
    stat, df, per_row = 0.0, 0, []
    for r in range(rows):
        nucleus = generate.nucleus_logits(logits[r:r + 1].cpu(), gc)[0].double()
        support = torch.isfinite(nucleus)
        drawn = generate.sample_token(logits[r:r + 1].expand(draws, -1), gc, gen).long().cpu()
        must("sampling support", bool(support[drawn].all()),
             f"row {r}: ids drawn outside the CPU nucleus {sorted(set(drawn.tolist()))}")
        expected = draws * nucleus.softmax(-1)[support]
        counts = torch.bincount(drawn, minlength=nucleus.numel())[support].double()
        big = expected >= 5
        e = torch.cat([expected[big], expected[~big].sum().reshape(1)])
        o = torch.cat([counts[big], counts[~big].sum().reshape(1)])
        keep = e > 0
        e, o = e[keep], o[keep]
        chi2 = float(((o - e) ** 2 / e).sum())
        stat, df = stat + chi2, df + e.numel() - 1
        per_row.append({"nucleus": int(support.sum()), "chi2": chi2, "bins": int(e.numel()),
                        "top_share": float(counts.max() / draws)})
    must("sampling chi-square has bins to test", df >= 1, per_row)
    p = float(torch.special.gammaincc(torch.tensor(df / 2, dtype=torch.float64),
                                      torch.tensor(stat / 2, dtype=torch.float64)))
    must("sampling chi-square", p >= 1e-3, {"p": p, "chi2": stat, "df": df, "rows": per_row})
    return {"p": p, "chi2": stat, "df": df, "draws_per_row": draws, "rows": per_row,
            "temperature": gc.temperature, "top_p": gc.top_p}


def inference_phase(gen, card: str, root: str) -> dict:
    """The inference entry point end to end at full width: write the
    checkpoint set (`write_inference_checkpoints`) into a temporary
    directory, load and convert it (`check_converters`), then
    `inference_ullava.run_once` with `quantize: int8`, `kv_cache:
    int8`, `conv_type: conv_sep2` on a seeded 480 x 640 uint8 image with
    the toy tokenizer, temperature 0.2, top-p 0.9, a seeded CUDA generator
    and 32 new tokens: it builds through `build_ullava` (its result and
    time kept by `recording`) and answers. The launch counts are set to 0
    just before `run_once` and read just after; every kernel must have
    been launched exactly as `inference_launches` says. Then the kernels
    at the shapes of this path (`inference_kernel_gates`), the built model
    on `run_once`'s own inputs (`prepare_query`) on the card against the
    CPU's plain path (`reference_gate`), and `sampling_gate`. Gates:
    finite outputs, three masks of the image's own 480 x 640 shape and
    three boxes, the exact counts, the kernels, the comparison with the
    CPU, the sampler. `root` is the caller's directory: the files stay
    there for `train_clis_phase` (the line's `checkpoint_paths`)."""
    import os

    import numpy as np
    import torch

    from ullava_tpu_torch import inference_ullava, kernels
    from ullava_tpu_torch.config import Config
    from ullava_tpu_torch.models import build

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from toy_tokenizer import ToyLlamaTokenizer

    t0 = time.perf_counter()
    paths = write_inference_checkpoints(root, gen)
    write_s = time.perf_counter() - t0
    conv_line = check_converters(paths)
    torch.cuda.empty_cache()

    cfg = Config(cfg_dict={
        "model": {"arch": "ullava", "conv_type": "conv_sep2", "quantize": "int8",
                  "kv_cache": "int8", **paths},
        "task": {"type": "image_text_evaluate"}, "processor": {}, "training": {}})
    image = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    query = "Segment the dog ."
    tok = ToyLlamaTokenizer(model_max_length=2048)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen = {}
    with recording(build, "build_ullava", seen):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = inference_ullava.run_once(
            cfg, image, query, temperature=0.2, top_p=0.9,
            max_new_tokens=INFERENCE_NEW_TOKENS, tokenizer=tok,
            generator=torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    u_cfg, params = seen["build_ullava"]
    build_s = seen["build_ullava_s"]
    must("inference config", u_cfg.core.llm.kv_quant and u_cfg.core.llm.num_layers == 4
         and u_cfg.sam.vision.embed_dim == 1280 and u_cfg.core.vision.num_layers == 24,
         u_cfg)
    must("tokenizer ids", len(tok) <= TOY_IDS and u_cfg.seg_token_idx == SEG_ID
         and u_cfg.loc_token_idx == LOC_ID, (len(tok), u_cfg.seg_token_idx))
    steps = len(res["text"].split())
    must("text", res["text"].split() == ["[SEG]", "[LOC]"] * (steps // 2)
         and steps == INFERENCE_NEW_TOKENS, res["text"])
    must("masks", len(res["masks"]) == 3 and all(m.shape == (480, 640) and m.dtype == np.uint8
                                                 for m in res["masks"]),
         [m.shape for m in res["masks"]])
    must("boxes", len(res["boxes"]) == 3 and np.isfinite(np.asarray(res["boxes"])).all(),
         res["boxes"])
    _check_launches("inference", launches, inference_launches(steps))
    inputs, _, _ = inference_ullava.prepare_query(u_cfg, tok, image, query, "conv_sep2", "cuda")
    prompt_len = int(inputs["prompt_lens"][0])
    kernel_gates = inference_kernel_gates(gen, prompt_len)
    reference = reference_gate(u_cfg, params, inputs)
    sampling = sampling_gate(u_cfg, params)
    del params, seen, inputs
    torch.cuda.empty_cache()
    line = {"phase": "inference", "card": card, "checkpoint_paths": paths,
            "llama_layers": INFERENCE_LLAMA_LAYERS,
            "depth_cut": "LLaMA num_hidden_layers 32 -> 4; CLIP 24 and SAM 32 blocks whole",
            "write_s": write_s, **conv_line, "build_s": build_s, "run_s": run_s,
            "answer_s": run_s - build_s, "prompt_tokens": prompt_len, "peak_mem_gb": peak_gb,
            "new_tokens": steps, "masks": [list(m.shape) for m in res["masks"]],
            "mask_pixels": [int(m.sum()) for m in res["masks"]],
            "boxes": [[float(v) for v in box] for box in res["boxes"]],
            "kernel_gates": kernel_gates, "reference": reference,
            "sampling": sampling, "launches": launches}
    print(json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------------------
# train_clis: the training and eval CLIs from annotation files and images
# ---------------------------------------------------------------------------

TRAIN_CLIS_B = 2  # per_device_train_batch_size of both training CLIs
TRAIN_CLIS_HW = (480, 640)
TRAIN_CLIS_ITEMS = 8  # RES and chat items: 4 steps an epoch at B=2
TRAIN_CLIS_VAL_ITEMS = 4  # one eval batch: the harness pads it to its 8
TRAIN_CLIS_GIFS = 4  # tgif items of the stage-1 set: 6 steps an epoch at B=2 with the chat set's 8


def png_bytes(pixels, colour: int = 2, palette=None) -> bytes:
    """A PNG of uint8 `pixels` ([H, W] or [H, W, C]) at bit depth 8 in
    colour type `colour`, row y filtered with scanline filter y % 5, so
    that a reader meets all five (zlib and struct only)."""
    import struct
    import zlib

    import numpy as np

    a = np.asarray(pixels, np.uint8)
    a = a[..., None] if a.ndim == 2 else a
    h, w, c = a.shape
    rows = a.reshape(h, w * c).astype(np.int16)
    out = np.empty((h, w * c + 1), np.uint8)
    up = np.zeros(w * c, np.int16)
    for y in range(h):
        r = rows[y]
        left = np.concatenate([np.zeros(c, np.int16), r[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int16), up[:-c]])
        f = y % 5
        if f == 4:  # Paeth: p - left = up - upleft, and so on
            pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        else:
            pred = (0, left, up, (left + up) >> 1)[f]
        out[y, 0] = f
        out[y, 1:] = (r - pred) & 0xFF
        up = r

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    if palette is not None:
        png += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return png + chunk(b"IDAT", zlib.compress(out.tobytes(), 6)) + chunk(b"IEND", b"")


def write_train_clis_data(root, rng) -> dict:
    """The phase's files under `root`: 8 RES images of 480 x 640 (PNG),
    `res_train.jsonl` (COCO polygons of one or two parts, 1-3 sentences an
    item), `res_val.jsonl` (4 items, 2-3 sentences), a one-question
    `SEG.json`, a LLaVA chat set of 8 items (`chat.json`) on its own
    PNG images, and a TGIF set of 4 items (`tgif.json`) on GIFs of
    `write_gifs`, in the chat set's words."""
    import os

    import numpy as np

    H, W = TRAIN_CLIS_HW
    images = os.path.join(root, "images")
    os.makedirs(images)

    def image(name):
        with open(os.path.join(images, name), "wb") as f:
            f.write(png_bytes(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)))

    def res_item(i, n_sentences):
        x0, y0 = int(rng.integers(20, 200)), int(rng.integers(20, 150))
        w, h = int(rng.integers(100, 300)), int(rng.integers(80, 250))
        parts = [[x0, y0, x0 + w, y0 + 10, x0 + w - 15, y0 + h, x0 + 5, y0 + h - 20]]
        if i % 2:  # a second part: the mask is the union
            parts.append([x0 + w + 20, y0, x0 + w + 80, y0, x0 + w + 80, y0 + 60, x0 + w + 20, y0 + 60])
        xs = [v for p in parts for v in p[0::2]]
        ys = [v for p in parts for v in p[1::2]]
        name = f"res{i}.png"
        image(name)
        cat = ("Dog", "Cup", "Chair", "Kite")[i % 4]
        return {"image_path": name, "segmentation": parts, "category": cat,
                "bbox": [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)],
                "height": H, "width": W,
                "sentences": [f"the {cat.lower()} number {i}", f"object {i} on the left",
                              f"thing {i}"][:n_sentences]}

    paths = {"images": images}
    for split, first, n, sentences in (
            ("res_train", 0, TRAIN_CLIS_ITEMS, lambda i: 1 + i % 3),
            ("res_val", 100, TRAIN_CLIS_VAL_ITEMS, lambda i: 2 + i % 2)):
        items = [res_item(first + i, sentences(i)) for i in range(n)]
        paths[split] = os.path.join(root, f"{split}.jsonl")
        with open(paths[split], "w") as f:
            f.writelines(json.dumps(item) + "\n" for item in items)
    paths["seg"] = os.path.join(root, "SEG.json")
    with open(paths["seg"], "w") as f:
        json.dump(["<image> Where is the <class> in this picture ?"], f)
    chat = []
    for i in range(TRAIN_CLIS_ITEMS):
        image(f"chat{i}.png")
        chat.append({"image": f"chat{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nDescribe the picture ."},
            {"from": "gpt", "value": f"A picture of noise , number {i} ."}]})
    paths["chat"] = os.path.join(root, "chat.json")
    with open(paths["chat"], "w") as f:
        json.dump(chat, f)
    gifs = write_gifs(images, [f"clip{i}.gif" for i in range(TRAIN_CLIS_GIFS)], rng)
    tgif = [{"gif": os.path.basename(g), "conversations": [
        {"from": "human", "value": "Describe the picture ."},
        {"from": "gpt", "value": f"A picture of noise , number {i} ."}]}
        for i, g in enumerate(gifs)]
    paths["tgif"] = os.path.join(root, "tgif.json")
    with open(paths["tgif"], "w") as f:
        json.dump(tgif, f)
    return paths


def train_clis_configs(paths, data, out) -> dict:
    """The YAML configs of the phase (as dicts): stage 2 as
    `configs/train/ullava_lora.yaml` with `quantize: int8_towers` on the RES
    set with its val set, one epoch or two; eval on run 2's last
    checkpoint; stage 1 (pretraining) on the chat set and the TGIF set,
    whose entries are `configs/train/ullava_core.yaml`'s."""
    import os

    def res(anno):
        return {"data_type": "image", "image_token_len": 256, "vis_processor": "clip_image",
                "build_info": {"anno_dir": anno, "image_dir": data["images"],
                               "template_root": data["seg"]}}

    training = {"learning_rate": 2e-4, "lr_scheduler_type": "linear", "warmup_ratio": 0.03,
                "weight_decay": 0.0, "model_max_length": 512,
                "per_device_train_batch_size": TRAIN_CLIS_B, "logging_steps": 1,
                "save_total_limit": 1, "seed": 42, "dataloader_num_workers": 2}
    processor = {"clip_image": {"image_size": 224, "aspect_ratio": "pad"}}
    stage2 = {
        "model": {"arch": "ullava", "conv_type": "conv_sep2", "projector_type": "mlp",
                  "vision_hidden_layer": -2, "projector_from_scratch": False,
                  "quantize": "int8_towers", "lora_r": 8, "lora_alpha": 16, **paths},
        "task": {"type": "image_text_pretrain", "collator_type": "grounding_collator"},
        "processor": processor,
        "dataset": {"refcoco": res(data["res_train"])},
        "eval_dataset": {"refcoco_val": res(data["res_val"])},
        "training": {**training, "output_dir": out["stage2"], "num_train_epochs": 1,
                     "evaluation_strategy": "epoch", "save_steps": 2},
    }
    run2 = json.loads(json.dumps(stage2))
    run2["training"]["num_train_epochs"] = 2
    evaluate = json.loads(json.dumps(stage2))
    evaluate["model"]["pretrained_ullava"] = os.path.join(out["stage2"], "checkpoint-8")
    evaluate["training"]["output_dir"] = out["eval"]
    stage1 = {
        "model": {"arch": "ullava_core", "conv_type": "conv_simple", "projector_type": "mlp",
                  "vision_hidden_layer": -2, "projector_from_scratch": True,
                  "llm_path": paths["llm_path"], "vision_encoder": paths["vision_encoder"]},
        "task": {"type": "image_text_pretrain", "collator_type": "image_video_collator"},
        "processor": {**processor, "gif_train": {"n_frm": VIDEO_N_FRM, "image_size": 224}},
        "dataset": {"llava_cc3m": {
            "data_type": "image", "image_token_len": 256, "vis_processor": "clip_image",
            "build_info": {"anno_dir": data["chat"], "image_dir": data["images"]}},
            "tgif": {
                "data_type": "gif", "image_token_len": 256, "vis_processor": "gif_train",
                "build_info": {"anno_dir": data["tgif"], "image_dir": data["images"],
                               "portion": 1.0}}},
        "training": {**training, "output_dir": out["stage1"], "learning_rate": 2e-3,
                     "num_train_epochs": 1, "save_steps": 100},
    }
    return {"stage2_run1": stage2, "stage2_run2": run2, "eval": evaluate, "stage1": stage1}


def _llm_train_launches() -> dict:
    """One LLaMA forward and backward under remat at
    `INFERENCE_LLAMA_LAYERS` layers, as `TRAIN_LAUNCHES` counts them at
    32: K15 and two K9 a layer in the step and again in the recompute,
    the final norm's K9 once; the flash backward's three kernels a layer,
    two K18 a layer and one for the final norm."""
    L = INFERENCE_LLAMA_LAYERS
    return {"flash_attention_fwd_lse": 2 * L, **{k: L for k in FLASH_BWD_NAMES},
            "rms_norm_bwd": 2 * L + 1, "rms_norm_fwd": 4 * L + 1}


def _sam_wq_launches(mlp_classes: int) -> dict:
    """One weight-only ViT-H encode in the resident layout without
    composite weights (`STAGE2_LAUNCHES`'s): `mlp_classes` of each window
    block's three classes reach the fused MLP's gate (rows % 512 == 0)."""
    return {"fused_window_attention_grid": 28, "fused_window_attention_rect": 28 * 2,
            "fused_global_attention_y": 4, "fused_ln_linear_wq": 28 * 6 + 4 * 2,
            "fused_mlp_block_wq": 28 * mlp_classes + 4}


def train_clis_launches() -> dict:
    """Launches of one stage-2 step of `train_ullava` (B=2): the LLM as in
    `_llm_train_launches`, one encode whose classes hold 6272 (32 full
    windows of 196 rows), 1792 (16 of 112) and 128 rows (2 corners), none
    a multiple of 512, so the fused MLP runs in the 4 global blocks only;
    of one stage-1 step of `train_ullava_core` (B=2): the LLM alone; of
    one eval batch (the harness's 8, no gradient): K2 and two K9 a layer
    and the final norm's, one encode whose classes hold 25088, 7168 and
    512 rows, all three past the MLP's gate."""
    zero = {k: 0 for k in BF16_LAUNCHES}
    L = INFERENCE_LLAMA_LAYERS
    return {"stage2_step": {**zero, **_llm_train_launches(), **_sam_wq_launches(0)},
            "stage1_step": {**zero, **_llm_train_launches()},
            "eval_batch": {**zero, "flash_attention_fwd_bsh": L, "rms_norm_fwd": 2 * L + 1,
                           **_sam_wq_launches(3)}}


# The eval batch: the harness's 8, the val set's 4 items padded with the
# last. The row counts of the SAM encode's classes at the stage-2 step's
# B=2 and at the eval batch's B=8 (`INFERENCE_CLASS_ROWS` an image), and
# those that reach the fused MLP's 512-row gate.
TRAIN_CLIS_EVAL_B = 8
TRAIN_CLIS_CLASS_ROWS = tuple(r * b for b in (TRAIN_CLIS_B, TRAIN_CLIS_EVAL_B)
                              for r in INFERENCE_CLASS_ROWS)
TRAIN_CLIS_MLP_ROWS = tuple(r for r in TRAIN_CLIS_CLASS_ROWS if r % 512 == 0)


def train_clis_kernel_gates(gen, eval_lens, eval_seq: int) -> dict:
    """Kernels at the shapes the training and eval CLIs give them, each
    against its plain version by `row_rel_err` within 1e-2 and each
    rejecting its source's mutant copies, as `inference_kernel_gates`:
    K2 on the eval batch (`TRAIN_CLIS_EVAL_B` rows of `eval_seq` tokens,
    its ragged `eval_lens`, 32 heads of 128, causal), with both of its
    mutants where a row's kv_len ends inside a 64-key tile before the
    sequence's end (else the causal one alone); and `sam_encode_gates`
    with the weight-only K10 at `TRAIN_CLIS_CLASS_ROWS`, the weight-only
    K12 at `TRAIN_CLIS_MLP_ROWS`, and K3, K14 and K11 on the windows and
    global blocks of 2 and of 8 images."""
    import torch

    from ullava_tpu_torch.ops import attention

    tol = 1e-2
    out = {"tol": tol}
    gate = _kernel_gate(out, tol)
    lens = torch.as_tensor(eval_lens, dtype=torch.int32, device="cuda")
    q, k, v = ((torch.randn((len(eval_lens), eval_seq, 32, 128), generator=gen, device="cuda"))
               .to(torch.bfloat16) for _ in range(3))
    edge = any(0 < int(n) < eval_seq and int(n) % 64 for n in eval_lens)
    gate(f"flash_attention_fwd_bsh {len(eval_lens)} x {eval_seq}",
         lambda: attention.flash_attention_fwd_bsh(q, k, v, lens, causal=True, scale=128**-0.5),
         attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=128**-0.5),
         K2_MUTANTS if edge else {"causal_mask_shifted": K2_MUTANTS["causal_mask_shifted"]})
    out["flash_attention_fwd_bsh kv_lens"] = [int(n) for n in eval_lens]
    del q, k, v
    sam_encode_gates(gen, gate, TRAIN_CLIS_CLASS_ROWS, TRAIN_CLIS_MLP_ROWS,
                     (TRAIN_CLIS_B, TRAIN_CLIS_EVAL_B))
    return out


def _batch_fingerprint(batch) -> dict:
    return {k: _fingerprint(v) for k, v in sorted(batch.items()) if hasattr(v, "element_size")}


def _leaf_fingerprints(params) -> list:
    """(path, fingerprint) of every leaf of `params` in tree order (None
    for a leaf that is not a tensor)."""
    from ullava_tpu_torch.training import optim

    return [(n, _fingerprint(t) if hasattr(t, "element_size") else None)
            for n, t in optim.named_leaves(params)]


def frozen_and_moved(name, before, params, patterns) -> dict:
    """Gate: against the fingerprints `before`, every leaf that `patterns`
    freeze is bit-unchanged and every leaf they train has moved, but for
    the mask decoder's (its unused mask tokens and hypernetworks and its
    attention key biases get no gradient; their moved count is read)."""
    from ullava_tpu_torch.training import optim

    after = _leaf_fingerprints(params)
    labels = [lab for _, lab in optim.named_leaves(optim.trainable_labels(params, patterns))]
    rows = list(zip(before, after, labels, strict=True))
    changed = [n for (n, a), (_, b), lab in rows if lab == "freeze" and a != b]
    moved = [(n, a != b) for (n, a), (_, b), lab in rows if lab == "train"]
    stuck = [n for n, m in moved if not m and not n.startswith("sam/mask_decoder")]
    must(name, not changed and not stuck, {"frozen changed": changed, "not moved": stuck})
    decoder = [m for n, m in moved if n.startswith("sam/mask_decoder")]
    return {"frozen_unchanged": sum(lab == "freeze" for lab in labels),
            "trained_moved": sum(m for _, m in moved),
            "mask_decoder_moved": [sum(decoder), len(decoder)]}


def cli_recorder():
    """A `TrainerCallback` that keeps what the phase reads of one training
    CLI call: the step its loop starts at and its leaves' fingerprints
    there, each epoch it asks its loader for (epoch, first batch), each
    step (wall, loss, launches, batch fingerprint; the first three
    batches kept) and each eval (results, launches, wall)."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.training.trainer import TrainerCallback

    class Recorder(TrainerCallback):
        def __init__(self):
            self.start_step = self.fingerprints = None
            self.epochs, self.steps, self.evals, self.batches = [], [], [], []

        def on_train_begin(self, state):
            self.start_step = state.step
            self.fingerprints = _leaf_fingerprints(state.params)

        def on_epoch_begin(self, epoch, start_batch):
            self.epochs.append((epoch, start_batch))

        def _begin(self):
            torch.cuda.synchronize()
            self._before, self._t0 = kernels.launch_counts(), time.perf_counter()

        def _end(self):
            torch.cuda.synchronize()
            s, after = time.perf_counter() - self._t0, kernels.launch_counts()
            return s, {k: after[k] - self._before[k] for k in after}

        def on_step_begin(self, state, batch):
            self._begin()

        def on_step_end(self, state, batch, metrics):
            s, launches = self._end()
            self.steps.append({"s": s, "loss": metrics["loss"].detach().clone(),
                               "launches": launches, "fingerprint": _batch_fingerprint(batch)})
            if len(self.batches) < 3:
                self.batches.append(batch)

        def on_evaluate_begin(self):
            self._begin()

        def on_evaluate_end(self, results):
            s, launches = self._end()
            self.evals.append({"results": results, "s": s, "launches": launches})

    return Recorder()


def train_clis_phase(paths, card: str, device: str = "cuda") -> dict:
    """The training and eval CLIs end to end at full width from files:
    the `inference` phase's checkpoint set (`paths`: LLaMA at Vicuna-7B's
    widths, 4 of 32 layers; CLIP ViT-L/14; SAM ViT-H) and the data of
    `write_train_clis_data` (numpy seed 23), each CLI called as a user
    calls it from Python with YAML files the phase writes and the toy
    tokenizer: `train_ullava` (`quantize: int8_towers`, LoRA r=8, B=2, one
    epoch of 4 steps, the per-epoch eval on the val set, `save_steps: 2`),
    `train_ullava` again with two epochs (it resumes at step 4 and takes 4
    more), `eval_ullava` on that run's last checkpoint, `train_ullava_core`
    (pretraining on the chat and TGIF sets, B=2, 6 steps). The training
    CLIs are read through a `TrainerCallback`
    (`cli_recorder`), the builds' walls through `recording`. The native
    host library must be loaded before the first fetch. Gates: the
    launches of the first stage-2 step, the first stage-1 step, each of
    the trainer's evals and the whole `eval_ullava` call (its build
    launches nothing) exactly as `train_clis_launches` says; after run 1's
    four steps every leaf `STAGE2_LORA` freezes bit-unchanged and every
    leaf it trains moved (`frozen_and_moved`); the first stage-2 step's
    loss bit-equal to `train.make_stage2_step` run directly on the
    loader's first batch from a second build of the same files, the
    second and third within 1e-3 relative (the schedule's first lr is 0,
    so the third is the first loss that reads an update: of the
    policy's leaves, by AdamW), and the same freeze gate after the three
    direct steps; the resumed run starting at step 4, asking its loader
    for epoch 1 from batch 0 only, taking 4 steps, its first batch
    bit-equal (by fingerprint) to batch 4 of a straight run;
    `eval_ullava`'s metrics equal to the trainer's last per-epoch eval;
    every loss finite; then `train_clis_kernel_gates` (torch seed 23) at
    the path's shapes. The launch counts are set to 0 before the first
    CLI call and read after the last; the direct steps' and the gates'
    launches (comparisons) come after. `device` other than "cuda" is for
    rehearsals off the card, without the kernel gates."""
    import math
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ullava_tpu_torch import eval_ullava, kernels, train, train_ullava, train_ullava_core
    from ullava_tpu_torch.config import Config
    from ullava_tpu_torch.constants import MM_TOKENS, STAGE2_TOKENS
    from ullava_tpu_torch.data.collators import GroundingCollator
    from ullava_tpu_torch.data.loader import DataLoader
    from ullava_tpu_torch.data.tools import native
    from ullava_tpu_torch.evaluation import harness
    from ullava_tpu_torch.models import build
    from ullava_tpu_torch.tasks import setup_task
    from ullava_tpu_torch.training import optim, train_step

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from toy_tokenizer import ToyLlamaTokenizer

    t_phase = time.perf_counter()
    expect = train_clis_launches()
    root = tempfile.mkdtemp(prefix="ullava_train_clis_")
    try:
        t0 = time.perf_counter()
        data = write_train_clis_data(root, np.random.default_rng(23))
        write_s = time.perf_counter() - t0
        out = {k: os.path.join(root, k) for k in ("stage2", "eval", "stage1")}
        cfg_paths = {}
        for name, cfg in train_clis_configs(paths, data, out).items():
            cfg_paths[name] = os.path.join(root, f"{name}.yaml")
            with open(cfg_paths[name], "w") as f:
                f.write(json.dumps(cfg, indent=1))  # JSON is YAML
        must("native host library", native.available(), "libullava_native did not load")

        # The tokenizer as the builds leave it, then every text of both RES
        # sets once, so that the loader's two threads add no word.
        tok = ToyLlamaTokenizer(model_max_length=2048)
        tok.add_tokens(MM_TOKENS)
        tok.add_tokens(STAGE2_TOKENS)
        cfg1 = Config(cfg_paths["stage2_run1"])
        model_cfg1 = cfg1.assign_config()[0]
        train_ds = setup_task(cfg1.task_cfg).build_datasets(
            cfg1.dataset_cfg, tok, cfg1.processor_cfg, "conv_sep2")
        val_sets = harness.build_eval_datasets(cfg1.eval_dataset_cfg, tok, cfg1.processor_cfg,
                                               "conv_sep2")
        for ds in (train_ds, *val_sets.values()):
            for i in range(len(ds)):
                ds[i]

        kernels.reset_launch_counts()
        runs = {}
        for name, call, cfg in (
                ("stage2_run1", train_ullava.train, cfg_paths["stage2_run1"]),
                ("stage2_run2", train_ullava.train, cfg_paths["stage2_run2"]),
                ("eval", eval_ullava.evaluate, cfg_paths["eval"]),
                ("stage1", train_ullava_core.train, cfg_paths["stage1"])):
            rec = None if name == "eval" else cli_recorder()
            build_name = "build_ullava_core" if name == "stage1" else "build_ullava"
            sink: dict = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, t0 = kernels.launch_counts(), time.perf_counter()
            with recording(build, build_name, sink):
                res = call(Config(cfg), tokenizer=tok, device=device,
                           **({} if rec is None else {"callbacks": [rec]}))
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            runs[name] = {"rec": rec, "s": time.perf_counter() - t0,
                          "build_s": sink[build_name + "_s"],
                          "launches": {k: after[k] - before[k] for k in after},
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          # a trained state's step (the state itself is freed)
                          "result": getattr(res, "step", res)}
            if name == "stage2_run1":
                runs[name]["u_cfg"] = sink["build_ullava"][0]
                runs[name]["freeze"] = frozen_and_moved(
                    "train_clis run 1's leaves", rec.fingerprints, res.params, optim.STAGE2_LORA)
            del res, sink
            torch.cuda.empty_cache()
        launches = kernels.launch_counts()

        r1, r2, s1 = (runs[n]["rec"] for n in ("stage2_run1", "stage2_run2", "stage1"))
        _check_launches("train_clis stage-2 step", r1.steps[0]["launches"], expect["stage2_step"])
        _check_launches("train_clis stage-1 step", s1.steps[0]["launches"], expect["stage1_step"])
        for e in [*r1.evals, *r2.evals, {"launches": runs["eval"]["launches"]}]:
            _check_launches("train_clis eval batch", e["launches"], expect["eval_batch"])
        losses = {n: [s["loss"].item() for s in runs[n]["rec"].steps]
                  for n in ("stage2_run1", "stage2_run2", "stage1")}
        must("train_clis steps", [len(v) for v in losses.values()] == [4, 4, 6]
             and runs["stage2_run2"]["result"] == 8, losses)
        must("train_clis losses finite", all(math.isfinite(x) for v in losses.values() for x in v),
             losses)

        # Resume: run 2 starts at step 4, asks for epoch 1 from batch 0 only
        # and takes its 4 steps; its first batch is batch 4 of a straight
        # run (the loader alone over epoch 0 and into epoch 1).
        u_cfg1 = runs["stage2_run1"]["u_cfg"]
        collator = setup_task(cfg1.task_cfg).build_collator(
            tok.pad_token_id, model_max_length=512, max_masks=u_cfg1.max_masks,
            mask_frame=u_cfg1.mask_loss_frame)
        straight = DataLoader(train_ds, TRAIN_CLIS_B, collator, num_workers=2, seed=42,
                              device=device)
        fetch_s, t0 = [], time.perf_counter()
        for batch in straight:
            torch.cuda.synchronize()
            fetch_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        straight.set_epoch(1)
        batch4 = next(iter(straight))
        must("train_clis resume", r2.start_step == 4 and r2.epochs == [(1, 0)]
             and r2.steps[0]["fingerprint"] == _batch_fingerprint(batch4),
             {"start_step": r2.start_step, "epochs": r2.epochs})

        # Eval: eval_ullava on checkpoint-8 gives the trainer's last eval.
        must("train_clis eval", len(r1.evals) == 1 and len(r2.evals) == 1
             and runs["eval"]["result"] == r2.evals[-1]["results"],
             {"cli": runs["eval"]["result"], "trainer": r2.evals[-1]["results"]})
        metrics = runs["eval"]["result"]["refcoco_val"]
        must("train_clis eval metrics", metrics["n_masks"] > 0 and metrics["n_boxes"] > 0
             and all(math.isfinite(metrics[k]) for k in ("ciou", "giou", "prec@0.5")), metrics)

        # The first steps: the CLI's wiring against train.make_stage2_step
        # run directly on the loader's first three batches from a second
        # build of the same files (the launches of this comparison are not
        # counted). The first lr is 0: the third loss reads the second
        # step's update.
        u_cfg, params = build.build_ullava(model_cfg1, tok, device=device)
        built = _leaf_fingerprints(params)
        schedule = optim.make_lr_schedule(2e-4, 4, warmup_ratio=0.03, schedule="linear")
        tx = optim.make_optimizer(schedule, weight_decay=0.0)
        state, labels = train_step.make_train_state(params, tx, optim.STAGE2_LORA)
        step = train.make_stage2_step(u_cfg, tx, labels)
        direct = []
        for batch in r1.batches:
            state, m = step(state, batch)
            direct.append(m["loss"].detach())
        first_equal = torch.equal(direct[0], r1.steps[0]["loss"])
        later_rel = [abs(d.item() - c) / abs(c) for d, c in zip(direct[1:], losses["stage2_run1"][1:])]
        must("train_clis first steps", first_equal and len(later_rel) == 2
             and max(later_rel) <= 1e-3,
             {"direct": [d.item() for d in direct], "cli": losses["stage2_run1"][:3]})
        direct_freeze = frozen_and_moved("train_clis direct steps' leaves", built, state.params,
                                         optim.STAGE2_LORA)
        del params, state, step, direct
        torch.cuda.empty_cache()

        # The kernels at this path's shapes against their plain versions,
        # K2 on the eval batch's own kv_lens.
        gates_s, kernel_gates = 0.0, None
        if device == "cuda":
            val = next(iter(val_sets.values()))
            samples = [val[i] for i in range(len(val))]
            samples += [samples[-1]] * (TRAIN_CLIS_EVAL_B - len(samples))
            eval_batch = GroundingCollator(tok.pad_token_id, model_max_length=512, max_masks=10,
                                           mask_frame=u_cfg1.mask_loss_frame)(samples)
            t0 = time.perf_counter()
            kernel_gates = train_clis_kernel_gates(
                torch.Generator(device="cuda").manual_seed(23), eval_batch["attn_lens"].tolist(),
                eval_batch["input_ids"].shape[1])
            gates_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def steps_s(rec):
        return [s["s"] for s in rec.steps]

    line = {"phase": "train_clis", "card": card, "llama_layers": INFERENCE_LLAMA_LAYERS,
            "seconds": time.perf_counter() - t_phase, "write_data_s": write_s,
            "run_s": {n: r["s"] for n, r in runs.items()},
            "build_s": {n: r["build_s"] for n, r in runs.items()},
            "peak_mem_gb": {n: r["peak_mem_gb"] for n, r in runs.items()},
            "step_s": {n: steps_s(runs[n]["rec"]) for n in ("stage2_run1", "stage2_run2", "stage1")},
            "fetch_collate_s_a_batch": fetch_s,
            "eval_s": [e["s"] for e in r1.evals + r2.evals],
            "losses": losses, "eval": metrics,
            "first_steps": {"bit_equal": first_equal, "second_third_rel": later_rel},
            "freeze": {"cli_run1": runs["stage2_run1"]["freeze"], "direct": direct_freeze},
            "resume": {"start_step": r2.start_step, "epochs": r2.epochs},
            "launches_stage2_step": {k: v for k, v in r1.steps[0]["launches"].items() if v},
            "launches_stage1_step": {k: v for k, v in s1.steps[0]["launches"].items() if v},
            "launches_eval_batch": {k: v for k, v in r1.evals[0]["launches"].items() if v},
            "kernel_gates_s": gates_s, "kernel_gates": kernel_gates,
            "launches": launches}
    print(json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------------------
# The sam_predictor phase: the public SAM surface (`SamPredictor`, the
# automatic mask generator, the decoder export) at ViT-L and ViT-B widths,
# whose 64-lane heads take the hd 64 forms of K3, K14, K4 and K11.
# ---------------------------------------------------------------------------
SAM_PRED_HW = (480, 640)
SAM_PRED_POINTS_PER_SIDE = 16  # 256 points decoded in one batch
SAM_PRED_KEEP = 32  # candidates above the generator gate's IoU threshold
# (name, size, weights): ViT-L bf16 (the JAX predictor's defaults), ViT-L
# with int8 towers and composite bias weights (`mlp_w8a8`), ViT-B bf16, and
# ViT-B's int8 towers, both sizes' int8 towers with int8 scores
# (`attn_dots_i8`) and both sizes' bf16 weights packed to 128 lanes a head
# (`pack_sam_attention`).
SAM_PRED_PATHS = (("vit_l_bf16", "vit_l", "bf16"), ("vit_l_int8", "vit_l", "int8"),
                  ("vit_b_bf16", "vit_b", "bf16"), ("vit_b_int8", "vit_b", "int8"),
                  ("vit_l_int8_i8", "vit_l", "int8_i8"), ("vit_b_int8_i8", "vit_b", "int8_i8"),
                  ("vit_l_packed", "vit_l", "packed"), ("vit_b_packed", "vit_b", "packed"))
# The paths that take the whole surface (every prompt, the generator and,
# in bf16, the export); the others encode and answer one prompt.
SAM_PRED_SURFACE = ("vit_l_bf16", "vit_l_int8", "vit_b_bf16")
# The prompts of each path's `predict` calls, in the 480 x 640 image's pixels.
SAM_PRED_PROMPTS = {
    "one_point": dict(point_coords=[[320.0, 240.0]], point_labels=[1]),
    "two_points_and_box": dict(point_coords=[[300.0, 200.0], [120.0, 90.0]],
                               point_labels=[1, 0], box=[80.0, 60.0, 500.0, 400.0]),
    "box_single": dict(box=[200.0, 100.0, 600.0, 450.0], multimask_output=False),
}


def sam_predictor_launches(depth: int, n_global: int, weights: str) -> dict:
    """Every kernel's launches in one B=1 encode of a 64 x 64 grid.
    `weights` "bf16", the resident layout (16 full windows, 4 right, 4
    bottom, 1 corner): a window block launches K3 on the full class and K14
    on each other class, a global block K4. "int8", int8 towers with
    composite bias weights: a window block takes K13 and K10's proj form on
    the full class, the merged edge pair and the corner, K3 on the full
    windows stored as 200 rows and K14 on the pair and the corner; a global
    block K10 twice (LN1 + qkv, proj), K11 and K12 (4096 rows; no window
    class reaches the fused MLP's 512-row gate at B=1: 3200, 896 and 64
    rows). "int8_i8" (`attn_dots_i8`): the same with the `dots_i8` forms of
    K3, K14 and K11, K11's pre-pass before each K11. "packed", the block
    layout: K19 once a window block (25 windows), K20 once a global block."""
    from ullava_tpu_torch import kernels

    nw = depth - n_global
    if weights in ("int8", "int8_i8"):
        i8 = "_i8" if weights == "int8_i8" else ""
        own = {"fused_ln_linear_dual": 3 * nw, f"fused_window_attention_grid{i8}_hd64": nw,
               f"fused_window_attention_rect{i8}_hd64": 2 * nw,
               "fused_ln_linear": 3 * nw + 2 * n_global,
               f"fused_global_attention_y{i8}_hd64": n_global, "fused_mlp_block": n_global,
               **({"global_attention_y_quant_i8_hd64": n_global} if i8 else {})}
    elif weights == "packed":
        own = {"fused_window_attention_packed": nw, "fused_global_attention_packed": n_global}
    else:
        own = {"fused_window_attention_grid_hd64": nw, "fused_window_attention_rect_hd64": 3 * nw,
               "fused_global_attention_hd64": n_global}
    return {k: own.get(k, 0) for k in kernels.KERNELS}


def sam_hd64_kernel_gates(gen, results: dict, forms: dict) -> dict:
    """The hd 64 forms against their plain versions at the shapes of one
    ViT-L and one ViT-B image (B=1), each by `row_rel_err` within 1e-2
    (the bf16-exponential K11 2e-2) and failing under each mutant copy of
    its source: K3 on 16 full windows of 196 rows (bf16) and of 200 rows
    (int8 towers: the pad rows finite), K14 on the right, bottom and corner
    classes one at a time (bf16) and on the merged edge pair and the corner
    (int8 towers), K4 on the 16 or 12 (image, head) pairs with fp32
    exponentials, K11 on ViT-L's 16 heads with bf16 ones; and, at ViT-L's
    widths (C 1024, F 4096), the W8A8 K13 on the full class (rows2 196),
    the pair and the corner, K10's proj form on the same rows and its LN1 +
    qkv form and K12 on a global block's 4096 rows (`sam_w8a8_width_gates`,
    timed into `forms`). Adds the four hd 64 forms' lines (timed at ViT-L
    bf16's shapes; K11 at the int8 path's) to `results`; returns the gate
    readings."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import sam_attention

    dev, bf, W, G = "cuda", torch.bfloat16, 14, 64
    tol, hd = 1e-2, 64
    sc = hd**-0.5
    out = {"tol": tol}
    gate = _kernel_gate(out, tol)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    quad = {"quad_max_dropped": QUAD_MAX_MUTANTS["sam_window_attention.cu"]}
    rect_bugs = {"pad_out_of_sum": RECT_PAD_MUTANT,
                 "quad_max_dropped": QUAD_MAX_MUTANTS["sam_rect_attention.cu"]}
    for size, H in (("vit_l", 16), ("vit_b", 12)):
        C = H * hd
        kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc)
        for rows in ((196, 200) if size == "vit_l" else (196,)):
            y = randn(16, rows, 3 * C)
            a, bb = (randn(16, rows, H * W, scale=2.0 / sc) for _ in range(2))
            a[:, 196:], bb[:, 196:] = 0, 0
            run = lambda y=y, a=a, bb=bb, r=rows: sam_attention.fused_window_attention_grid(  # noqa: E731
                y, a, bb, **kw, total_rows=0 if r == 196 else r)
            ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, H, hd, W, sc)
            gate(f"{size} fused_window_attention_grid_hd64 16 x {rows}",
                 lambda run=run: run()[:, :196], ref[:, :196], quad)
            must(f"{size} K3 hd64 pad rows finite", bool(torch.isfinite(run()).all()), rows)
            if size == "vit_l" and rows == 196:
                lib = window_sdpa_inputs(y, a, bb, y, torch.ones(196, dtype=torch.bool, device=dev),
                                         (C, H, hd, W))
                got = run()
                line = kernel_line(
                    "fused_window_attention_grid_hd64", (got.float() - ref.float()).abs().max().item(),
                    {"row_rel_err":
                     out[f"{size} fused_window_attention_grid_hd64 16 x {rows}"]["row_rel_err"],
                     "tol": tol}, run,
                    lambda: sam_attention.fused_window_attention_grid_plain(y, a, bb, H, hd, W, sc),
                    lambda l=lib: window_sdpa(*l), nbytes(y, a, bb, got), 4.0 * 16 * H * 196 * 196 * hd)
                line.update(shape=[16, 196, 3 * C], kernel=kernels.kernel_attrs(
                    "sam_window_attention.cu", "ullava_window_attention_grid_hd64_attrs", 0))
                results["fused_window_attention_grid_hd64"] = line
                del lib, got
            del y, a, bb, ref
        qkv_bias = randn(3 * C, scale=0.5)
        rect_forms = ((("right", [(14, 8)], 4), ("bottom", [(8, 14)], 4), ("corner", [(8, 8)], 1))
                      + ((("edge_pair", [(14, 8), (8, 14)], 4),) if size == "vit_l" else ()))
        for form, geoms, per in rect_forms:
            y, a, bb, tables, padded, is_real = rect_case(gen, geoms, per, qkv_bias, (C, H, hd, W))
            geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
            run = lambda y=y, a=a, bb=bb, t=tables, g_=geometry: (  # noqa: E731
                sam_attention.fused_window_attention_rect(y, a, bb, *t, **kw, geometry=g_))
            ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, H, hd, W, sc)
            name = f"{size} fused_window_attention_rect_hd64 {form}"
            gate(name, run, ref, rect_bugs)
            if size == "vit_l" and form in ("right", "corner"):
                lib = window_sdpa_inputs(y, a, bb, padded, torch.ones(W * W, dtype=torch.bool,
                                                                      device=dev), (C, H, hd, W))
                got = run()
                N, T = y.shape[:2]
                line = kernel_line(
                    "fused_window_attention_rect_hd64", (got.float() - ref.float()).abs().max().item(),
                    {"row_rel_err": out[name]["row_rel_err"], "tol": tol}, run,
                    lambda y=y, a=a, bb=bb, t=tables: sam_attention.fused_window_attention_rect_plain(
                        y, a, bb, *t, H, hd, W, sc),
                    lambda l=lib: window_sdpa(*l), nbytes(y, a, bb, *tables, got),
                    4.0 * N * H * T * W * W * hd)
                line.update(shape=[N, T, 3 * C], kernel=kernels.kernel_attrs(
                    "sam_rect_attention.cu", "ullava_window_attention_rect_hd64_attrs", 0,
                    *geoms[0], *geoms[-1]))
                if form == "right":
                    results["fused_window_attention_rect_hd64"] = line
                else:
                    results["fused_window_attention_rect_hd64"]["corner_form"] = {
                        k: v for k, v in line.items() if k not in ("name", "route", "source", "replaces")}
                del lib, got
            del y, a, bb, tables, padded, ref

        # K4 on the global block's H (image, head) pairs, fp32 exponentials.
        S = G * G
        q, k, v = (randn(H, S, hd) for _ in range(3))
        rel_h, rel_w = (randn(2 * G - 1, hd, scale=0.25) for _ in range(2))
        a, bb = (t.reshape(H, S, G).to(bf) for t in sam_attention.decomposed_bias_terms(
            q.reshape(1, H, G, G, hd), rel_h, rel_w, G))
        run = lambda: sam_attention.fused_global_attention(q, k, v, a, bb, G, sc)  # noqa: E731
        ref = sam_attention.fused_global_attention_plain(q, k, v, a, bb, G, sc)
        gate(f"{size} fused_global_attention_hd64 {H} x 4096", run, ref, K4_MUTANTS)
        if size == "vit_l":
            gmask = (a.float()[:, :, :, None] + bb.float()[:, :, None, :]).reshape(H, S, S).to(bf)
            got = run()
            flops = 4.0 * H * S * S * hd
            line = kernel_line(
                "fused_global_attention_hd64", (got.float() - ref.float()).abs().max().item(),
                {"row_rel_err": out[f"{size} fused_global_attention_hd64 {H} x 4096"]["row_rel_err"],
                 "tol": tol},
                run, lambda: sam_attention.fused_global_attention_plain(q, k, v, a, bb, G, sc),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=gmask, scale=sc),
                nbytes(q, k, v, a, bb, got), flops, iters=10)
            line.update(shape=[H, S, hd], tflops=flops / line["ms"] / 1e9,
                        kernel=kernels.kernel_attrs("sam_global_attention.cu",
                                                    "ullava_fused_global_attention_hd64_attrs", 0))
            results["fused_global_attention_hd64"] = line
            del gmask, got
        del q, k, v, a, bb, ref
        torch.cuda.empty_cache()

    # K11 on ViT-L's 16 heads with bf16 exponentials (the int8 towers' form).
    H, C, S = 16, 1024, G * G
    y = randn(1, S, 3 * C)
    a, bb = (randn(1, S, H, G, scale=2.0 / sc) for _ in range(2))
    kw = dict(num_heads=H, head_dim=hd, window=G, scale=sc, exp_bf16=True)
    run = lambda: sam_attention.fused_global_attention_y(y, a, bb, head_group=16, **kw)  # noqa: E731
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw)
    out_y = {}
    _kernel_gate(out_y, 2e-2)("vit_l fused_global_attention_y_hd64 1 x 4096 exp_bf16", run, ref,
                              GLOBAL_Y_MUTANTS)
    out.update(out_y)
    y5, mask = global_sdpa_inputs(y, a, bb)
    got = run()
    flops = 4.0 * H * S * S * hd
    line = kernel_line(
        "fused_global_attention_y_hd64", (got.float() - ref.float()).abs().max().item(),
        {"row_rel_err": out_y["vit_l fused_global_attention_y_hd64 1 x 4096 exp_bf16"]["row_rel_err"],
         "tol": 2e-2}, run,
        lambda: sam_attention.fused_global_attention_y_plain(y, a, bb, **kw),
        lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=mask, scale=sc),
        nbytes(y, a, bb, got), flops, iters=10)
    line.update(shape=[1, S, 3 * C], tflops=flops / line["ms"] / 1e9,
                kernel=kernels.kernel_attrs("sam_global_attention_y.cu",
                                            "ullava_fused_global_attention_y_hd64_attrs", 1))
    results["fused_global_attention_y_hd64"] = line
    del y, a, bb, ref, y5, mask, got
    torch.cuda.empty_cache()

    sam_w8a8_width_gates(gen, gate, "vit_l", 1024, 4096, 16, forms)
    return out


def sam_w8a8_width_gates(gen, gate, size: str, C: int, F_: int, H: int, forms: dict) -> None:
    """The W8A8 K13, K10 and K12 at one SAM width (`size`: C, F_, H heads)
    against their plain versions at a B=1 encode's shapes, through `gate`
    (`_kernel_gate`), each failing under its source's mutant copies: K13
    on the full class (16 windows stored as 200 rows, rows2 196), the
    merged edge pair (8 x 112) and the corner (1 x 64) with the composite
    bias weight's 2 x H x 27 columns (ViT-B's 648 = 5 x 128 + 8); K10's
    proj form on those classes' rows and a global block's 4096, its LN1 +
    qkv form and K12 on the 4096. The full class's K13, K10's LN1 + qkv
    and K12 are timed into `forms[kernel][f"{size}_c{C}_form"]`."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch.ops import mlp_kernel, quant

    dev, bf, eps, W = "cuda", torch.bfloat16, 1e-6, 14
    F2, key = 2 * H * (2 * W - 1), f"{size}_c{C}_form"

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(bf)

    def weight(K, N):
        leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * 0.05)
        return leaf["q"], leaf["scale"]

    def int8_rows(x, g_, b_):
        xf = F.layer_norm(x, (C,), g_, b_, eps).float().reshape(-1, C)
        amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
        return torch.round(xf * (127.0 / amax)).to(torch.int8), amax * (1.0 / 127.0)

    def timed(name, info, run, plain, library, io, ops, shape):
        got, ref = run(), plain()
        pairs = zip(got, ref) if isinstance(got, tuple) else ((got, ref),)
        line = kernel_line(name, max((g_.float() - r_.float()).abs().max().item() for g_, r_ in pairs),
                           info, run, plain, library, io, ops, iters=10, flops_per_s=INT8_OPS_PER_S)
        forms.setdefault(name, {})[key] = {
            **{k: v for k, v in line.items() if k not in ("name", "route", "source", "replaces")},
            "shape": shape}

    g_, b_ = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
    wq, ws = weight(C, 3 * C)
    w2, s2 = weight(C, F2)
    bias, bias2 = randn(3 * C, scale=0.5), torch.randn(F2, generator=gen, device=dev) * 0.5
    wargs = (g_, b_, wq, ws, bias, w2, s2, bias2, eps)
    for cls, N, T, rows2 in (("full", 16, 200, 196), ("edge_pair", 8, 112, 112), ("corner", 1, 64, 64)):
        x = randn(N, T, C, scale=2.0, shift=0.3)
        plain = lambda x=x, r2=rows2: mlp_kernel._ln_linear_dual_parts_plain(  # noqa: E731
            x, *wargs, True, r2)[:2]
        ry, rp = plain()
        run = lambda x=x, r2=0 if rows2 == T else rows2: mlp_kernel.fused_ln_linear_dual(  # noqa: E731
            x, *wargs, w8a8=True, rows2=r2)
        gate(f"{size} fused_ln_linear_dual y {cls} {N} x {T}", lambda run=run: run()[0], ry, {})
        info = gate(f"{size} fused_ln_linear_dual bias terms {cls} {N} x {T} x {F2}",
                    lambda run=run: run()[1], rp, K13_MUTANTS)
        if cls == "full":
            def library(x=x, N=N, T=T, rows2=rows2):
                xq_, xs_ = int8_rows(x, g_, b_)
                y_ = (torch._int_mm(xq_, wq).float() * (xs_ * ws) + bias.float()).to(bf)
                p_ = (torch._int_mm(xq_, w2).float() * (xs_ * s2) + bias2).to(bf)
                return y_.reshape(N, T, 3 * C), p_.reshape(N, T, F2)[:, :rows2]

            timed("fused_ln_linear_dual", info, run, plain, library,
                  nbytes(x, g_, b_, wq, ws, bias, w2, s2, bias2, ry, rp),
                  2.0 * C * (N * T * 3 * C + N * rows2 * F2), [N, T, C, 3 * C, F2, rows2])
        del x, ry, rp
    wp, sp = weight(C, C)
    bp = randn(C, scale=0.5)
    for rows in (3200, 896, 64, 4096):
        x, res = randn(rows, C, scale=2.0, shift=0.3), randn(rows, C)
        gate(f"{size} fused_linear proj {rows}",
             lambda x=x, r=res: mlp_kernel.fused_linear(x, wp, sp, bp, residual=r, w8a8=True),
             mlp_kernel._ln_linear_parts_plain(x, None, None, wp, sp, bp, 0.0, True, res)[0],
             K10_MUTANTS)
    x = randn(4096, C, scale=2.0, shift=0.3)
    run = lambda: mlp_kernel.fused_ln_linear(x, g_, b_, wq, ws, bias, eps, w8a8=True)  # noqa: E731
    plain = lambda: mlp_kernel._ln_linear_parts_plain(x, g_, b_, wq, ws, bias, eps, True, None)[0]  # noqa: E731
    info = gate(f"{size} fused_ln_linear ln_qkv 4096", run, plain(), {})

    def library_qkv():
        xq_, xs_ = int8_rows(x, g_, b_)
        return (torch._int_mm(xq_, wq).float() * (xs_ * ws) + bias.float()).to(bf)

    timed("fused_ln_linear", info, run, plain, library_qkv,
          nbytes(x, g_, b_, wq, ws, bias) + 4096 * 3 * C * 2, 2.0 * 4096 * C * 3 * C,
          [4096, C, 3 * C])
    (w1, s1), (w2, s2) = weight(C, F_), weight(F_, C)
    b1, b2 = randn(F_, scale=0.5), randn(C, scale=0.5)
    args = (x, g_, b_, w1, s1, b1, w2, s2, b2, eps)
    fc = mlp_kernel.default_f_chunk(F_)
    run = lambda: mlp_kernel.fused_mlp_block(*args, w8a8=True)  # noqa: E731
    plain = lambda: mlp_kernel._mlp_block_parts_plain(*args, fc, True)[0]  # noqa: E731
    info = gate(f"{size} fused_mlp_block 4096", run, plain(), K12_MUTANTS)
    timed("fused_mlp_block", info, run, plain, lambda: library_mlp(*args, fc),
          nbytes(x, g_, b_, w1, s1, b1, w2, s2, b2, x), 4.0 * 4096 * C * F_, [4096, C, F_])
    del x, args
    torch.cuda.empty_cache()


def sam_hd64_i8_kernel_gates(gen, results: dict, forms: dict) -> dict:
    """The SAM kernel forms of the `sam_predictor` phase's int8-score,
    ViT-B int8 and packed paths against their plain versions at those
    paths' B=1 shapes, each by `row_rel_err` within the limit of its hd 80
    form (1e-2; 2e-2 with bf16 exponentials; the pre-pass bit for bit) and
    failing under each mutant copy of its source and the input mutants: at
    ViT-L (16 heads) and ViT-B (12) each, K3's `dots_i8` form on 16 full
    windows of 196 and of 200 rows, K14's on the merged edge pair and the
    corner, K11's pre-pass and its `dots_i8` form in both exponential
    forms, K11's bf16-score form at 12 heads, K19 on the 25 padded windows
    and K20 on the global grid at hp 128 over 64 real lanes; the W8A8 K10,
    K12, K13 at ViT-B's widths (`sam_w8a8_width_gates`: C 768, F 3072, K13's
    648 bias-term columns). Adds the four new kernels' lines to `results`
    (timed at both sizes) and the other forms' timed lines to `forms`
    ({kernel: {form: line}}); returns the gate readings."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import sam_attention

    dev, bf, W, G, hd = "cuda", torch.bfloat16, 14, 64, 64
    sc, real, S = hd**-0.5, W * W, G * G
    out: dict = {}
    gate, gate_exp = _kernel_gate(out, 1e-2), _kernel_gate(out, 2e-2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def max_abs(got, ref, rows=slice(None)):
        return (got[:, rows].float() - ref[:, rows].float()).abs().max().item()

    def form_of(line):
        return {k: v for k, v in line.items() if k not in ("name", "route", "source", "replaces")}

    quad = {"quad_max_dropped": QUAD_MAX_MUTANTS["sam_window_attention.cu"]}
    win_bugs = {"one_key_scale_a_tile": I8_MUTANTS["sam_window_attention.cu"], **quad}
    rect_bugs = {"one_key_scale_a_tile": I8_MUTANTS["sam_rect_attention.cu"],
                 "pad_out_of_sum": RECT_PAD_MUTANT,
                 "quad_max_dropped": QUAD_MAX_MUTANTS["sam_rect_attention.cu"]}
    glob_bugs = {"one_key_scale_a_tile": I8_MUTANTS["sam_global_attention_y.cu"],
                 **GLOBAL_Y_MUTANTS}
    lines: dict = {}
    for size, H in (("vit_l", 16), ("vit_b", 12)):
        C = H * hd
        kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc)

        # K3, int8 scores: 16 full windows of 196 rows and as the resident
        # layout stores them beside composite weights (200, pad rows zero
        # in the bias terms as `_assemble_bias_terms` makes them).
        name = "fused_window_attention_grid_i8_hd64"
        for rows in (196, 200):
            y = randn(16, rows, 3 * C)
            a, bb = (randn(16, rows, H * W, scale=2.0 / sc) for _ in range(2))
            a[:, real:], bb[:, real:] = 0, 0
            tr = 0 if rows == real else rows
            run = lambda y=y, a=a, bb=bb, tr=tr: sam_attention.fused_window_attention_grid(  # noqa: E731
                y, a, bb, **kw, total_rows=tr, dots_i8=True)
            plain = lambda y=y, a=a, bb=bb: sam_attention.fused_window_attention_grid_plain(  # noqa: E731
                y, a, bb, H, hd, W, sc, dots_i8=True)
            ref = plain()
            info = gate(f"{size} {name} 16 x {rows}", lambda run=run: run()[:, :real],
                        ref[:, :real], win_bugs,
                        {"bias_swapped": lambda run=run, a=a, bb=bb: run(a=bb, bb=a)[:, :real]})
            got = run()
            must(f"{size} {name} pad rows finite", bool(torch.isfinite(got).all()), rows)
            if rows == 200:  # the paths' form
                lib = window_sdpa_inputs(y, a, bb, y, torch.arange(rows, device=dev) < real,
                                         (C, H, hd, W))
                io, flops = nbytes(y, a, bb, got), 4.0 * 16 * H * rows * real * hd
                line = kernel_line(name, max_abs(got, ref, slice(0, real)), info, run, plain,
                                   lambda l=lib: window_sdpa(*l), io, flops,
                                   bound=bound_i8_ms(io, flops))
                line.update(shape=[16, rows, 3 * C], kernel=kernels.kernel_attrs(
                    "sam_window_attention.cu", "ullava_window_attention_grid_hd64_attrs", 1))
                lines[(name, size)] = line
                del lib
            del y, a, bb, got, ref

        # K14, int8 scores: the merged edge pair and the corner.
        name = "fused_window_attention_rect_i8_hd64"
        qkv_bias = randn(3 * C, scale=0.5)
        for form, geoms, per in (("edge_pair", [(14, 8), (8, 14)], 4), ("corner", [(8, 8)], 1)):
            y, a, bb, tables, padded, _ = rect_case(gen, geoms, per, qkv_bias, (C, H, hd, W))
            geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
            run = lambda y=y, a=a, bb=bb, t=tables, g_=geometry: (  # noqa: E731
                sam_attention.fused_window_attention_rect(y, a, bb, *t, **kw, dots_i8=True,
                                                          geometry=g_))
            plain = lambda y=y, a=a, bb=bb, t=tables: sam_attention.fused_window_attention_rect_plain(  # noqa: E731
                y, a, bb, *t, H, hd, W, sc, dots_i8=True)
            ref = plain()
            info = gate(f"{size} {name} {form}", run, ref, rect_bugs, {
                "pad_v_dropped": lambda run=run, t=tables: run(t=(*t[:2], torch.zeros_like(t[2])))})
            got = run()
            lib = window_sdpa_inputs(y, a, bb, padded, torch.ones(real, dtype=torch.bool,
                                                                  device=dev), (C, H, hd, W))
            N, T = y.shape[:2]
            io, flops = nbytes(y, a, bb, *tables, got), 4.0 * N * H * T * real * hd
            line = kernel_line(name, max_abs(got, ref), info, run, plain,
                               lambda l=lib: window_sdpa(*l), io, flops,
                               bound=bound_i8_ms(io, flops))
            line.update(shape=[N, T, 3 * C], kernel=kernels.kernel_attrs(
                "sam_rect_attention.cu", "ullava_window_attention_rect_hd64_attrs", 1,
                *geoms[0], *geoms[-1]))
            lines[(name, size, form)] = line
            del y, a, bb, tables, padded, got, ref, lib

        # K11's pre-pass and its int8 and bf16 score forms on one global
        # block (B=1), both exponential forms.
        y = randn(1, S, 3 * C)
        a, bb = (randn(1, S, H, G, scale=2.0 / sc) for _ in range(2))
        gkw = dict(num_heads=H, head_dim=hd, window=G, scale=sc)
        pre_name = "global_attention_y_quant_i8_hd64"
        pre = sam_attention.global_y_quant_i8(y, a, bb, H, hd)
        pre_ref = sam_attention.global_y_quant_i8_plain(y, a, bb, H, hd)
        exact = [bool(torch.equal(g_, r_)) for g_, r_ in zip(pre, pre_ref)]
        must(f"{size} {pre_name}", all(exact), exact)
        swapped = sam_attention.global_y_quant_i8(y, bb, a, H, hd)
        caught = not (torch.equal(swapped[2], pre_ref[2]) and torch.equal(swapped[3], pre_ref[3]))
        must_not(f"{size} {pre_name}", "bias_swapped", not caught, caught)
        out[f"{size} {pre_name}"] = {"bit_equal": exact, "mutant_bit_equal": {"bias_swapped": not caught}}
        pre_io = nbytes(y) * 2 // 3 + nbytes(a, bb, *pre)
        line = kernel_line(
            pre_name, max(float((g_.float() - r_.float()).abs().max()) for g_, r_ in zip(pre, pre_ref)),
            out[f"{size} {pre_name}"], lambda: sam_attention.global_y_quant_i8(y, a, bb, H, hd),
            lambda: sam_attention.global_y_quant_i8_plain(y, a, bb, H, hd), None, pre_io, 0.0,
            iters=10)
        line["shape"] = [1, S, 3 * C]
        lines[(pre_name, size)] = line
        del pre, pre_ref, swapped
        y5, mask = global_sdpa_inputs(y, a, bb)
        flops = 4.0 * H * S * S * hd
        for dots_i8 in (True, False):
            name = "fused_global_attention_y" + ("_i8" if dots_i8 else "") + "_hd64"
            if not dots_i8 and size == "vit_l":
                continue  # 16 heads in bf16: `sam_hd64_kernel_gates` times it
            for exp_bf16 in (True, False):
                run = lambda a_=a, b_=bb, e=exp_bf16, d=dots_i8: sam_attention.fused_global_attention_y(  # noqa: E731
                    y, a_, b_, **gkw, head_group=16 if H == 16 else 4, exp_bf16=e, dots_i8=d)
                plain = lambda e=exp_bf16, d=dots_i8: sam_attention.fused_global_attention_y_plain(  # noqa: E731
                    y, a, bb, **gkw, exp_bf16=e, dots_i8=d)
                ref = plain()
                exp = "exp_bf16" if exp_bf16 else "exp_fp32"
                bugs = glob_bugs if dots_i8 else GLOBAL_Y_MUTANTS
                info = (gate_exp if exp_bf16 else gate)(
                    f"{size} {name} {H} heads {exp}", run, ref, bugs,
                    {"bias_swapped": lambda run=run: run(a_=bb, b_=a)})
                got = run()
                io = nbytes(y, a, bb) + nbytes(y) // 3
                line = kernel_line(
                    name, max_abs(got, ref), info, run, plain,
                    lambda: F.scaled_dot_product_attention(y5[0], y5[1], y5[2], attn_mask=mask,
                                                           scale=sc),
                    io, flops, iters=10, bound=bound_i8_ms(io, flops) if dots_i8 else None)
                line.update(shape=[1, S, 3 * C], tflops=flops / line["ms"] / 1e9,
                            kernel=kernels.kernel_attrs(
                                "sam_global_attention_y.cu",
                                f"ullava_fused_global_attention_y{'_i8' if dots_i8 else ''}_hd64_attrs",
                                int(exp_bf16)))
                if dots_i8:
                    line["pre_pass_ms"] = lines[(pre_name, size)]["ms"]
                lines[(name, size, exp)] = line
                del got, ref
        del y, a, bb, y5, mask

        # K19 and K20 at hp 128 over 64 real lanes, the pad lanes zero as
        # `pack_sam_attention` makes them.
        for name, N, Wn in (("fused_window_attention_packed", 25, W),
                            ("fused_global_attention_packed", 1, G)):
            Sn = Wn * Wn
            y = torch.zeros((N, Sn, 3, H, SAM_HP), dtype=bf, device=dev)
            y[..., :hd] = randn(N, Sn, 3, H, hd)
            y = y.reshape(N, Sn, 3 * H * SAM_HP)
            a, bb = (randn(N, H, Sn, Wn, scale=2.0) for _ in range(2))
            fn, plain_fn = getattr(sam_attention, name), getattr(sam_attention, f"{name}_plain")
            run = lambda a_=a, b_=bb, y=y, fn=fn, Wn=Wn: fn(y, a_, b_, H, SAM_HP, Wn, sc)  # noqa: E731
            plain = lambda y=y, a=a, bb=bb, f=plain_fn, Wn=Wn: f(y, a, bb, H, SAM_HP, Wn, sc)  # noqa: E731
            ref = plain()
            bugs = {b_: PACKED_MUTANTS[b_] for b_ in ("bias_read_prescaled", "k_one_head_over") + (
                ("quad_max_dropped",) if Wn == W else ("a_term_one_grid_row",))}
            info = gate(f"{size} {name} hd64", run, ref, bugs,
                        {"bias_swapped": lambda run=run, a=a, bb=bb: run(a_=bb, b_=a)})
            got = run()
            info["pad_lanes_zero"] = bool(torch.all(got.reshape(N, Sn, H, SAM_HP)[..., hd:] == 0))
            must(f"{size} {name} hd64", info["pad_lanes_zero"], "pad lanes of the output are not zero")
            y5, mask = packed_sdpa_inputs(y, a, bb, H, SAM_HP)
            flops, io = 4.0 * N * H * Sn * Sn * SAM_HP, nbytes(y, a, bb, got)
            line = kernel_line(
                name, max_abs(got, ref), info, run, plain,
                lambda y5=y5, m=mask: F.scaled_dot_product_attention(y5[0], y5[1], y5[2],
                                                                     attn_mask=m, scale=sc),
                io, flops, iters=10)
            line.update(bound_ms_real_lanes=bound_ms(io, flops * hd / SAM_HP)[0],
                        shape=[N, Sn, 3 * H * SAM_HP], heads=H, head_dim=hd)
            forms.setdefault(name, {})[f"hd64_{size}_form"] = form_of(line)
            del y, a, bb, got, ref, y5, mask
        torch.cuda.empty_cache()

    # The four new kernels' lines: ViT-L's form, ViT-B's beside it.
    for name, key in (("fused_window_attention_grid_i8_hd64", ()),
                      ("fused_window_attention_rect_i8_hd64", ("edge_pair",)),
                      ("global_attention_y_quant_i8_hd64", ()),
                      ("fused_global_attention_y_i8_hd64", ("exp_bf16",))):
        line = dict(lines[(name, "vit_l", *key)])
        line["vit_b_form"] = form_of(lines[(name, "vit_b", *key)])
        if name == "fused_window_attention_rect_i8_hd64":
            line["corner_form"] = form_of(lines[(name, "vit_l", "corner")])
            line["vit_b_form"]["corner_form"] = form_of(lines[(name, "vit_b", "corner")])
        if name == "fused_global_attention_y_i8_hd64":
            line["exp_fp32_form"] = form_of(lines[(name, "vit_l", "exp_fp32")])
            line["vit_b_form"]["exp_fp32_form"] = form_of(lines[(name, "vit_b", "exp_fp32")])
        results[name] = line
    forms["fused_global_attention_y_hd64"] = {
        "vit_b_12_heads_form": {**form_of(lines[("fused_global_attention_y_hd64", "vit_b",
                                                  "exp_bf16")]),
                                "exp_fp32_form": form_of(lines[("fused_global_attention_y_hd64",
                                                                "vit_b", "exp_fp32")])}}
    del lines
    torch.cuda.empty_cache()

    sam_w8a8_width_gates(gen, gate, "vit_b", 768, 3072, 12, forms)
    return out


def write_sam_checkpoint(root, size: str, gen) -> str:
    """Meta's `sam_<size>` state dict at full width (`sam_meta_specs`,
    `SAM_SIZES`), drawn on the card (`_draw`), saved as an fp32 `.pth`."""
    import os

    import torch

    path = os.path.join(root, f"sam_{size}.pth")
    torch.save({s[0]: _draw(s, torch.float32, gen) for s in sam_meta_specs(*SAM_SIZES[size])},
               path)
    return path


def _iou_threshold(iou, keep: int) -> tuple:
    """A threshold halfway in the widest gap of the sorted IoU predictions
    between ranks keep / 2 and 2 keep, so that the card's and the CPU's
    fp32 sums land on the same side of it: (threshold, gap)."""
    s = sorted(iou, reverse=True)
    lo, hi = max(1, keep // 2), min(len(s) - 1, 2 * keep)
    i = max(range(lo, hi), key=lambda j: s[j - 1] - s[j])
    return (s[i - 1] + s[i]) / 2, s[i - 1] - s[i]


def sam_predictor_phase(gen, card: str, root: str) -> dict:
    """The SAM public surface at full width on the card (`SAM_PRED_PATHS`):
    Meta-named ViT-L and ViT-B checkpoints written to `root` from `gen`,
    converted on the card; for each path `SamPredictor.set_image` on one
    480 x 640 uint8 image with exact launch counts (`sam_predictor_launches`,
    counts zeroed just before) and the embedding held within 5e-2 by
    `row_rel_err` to the port's plain path on the card (the wrappers swapped
    for their plain versions, no kernel launched), then `predict` with each
    of `SAM_PRED_PROMPTS` (the paths outside `SAM_PRED_SURFACE`: two points
    and a box, and no generator), its IoU predictions and low-res logits held to the
    same prompt encoding, decoding and host post-processing on the CPU from
    the same embedding (1e-3 of the largest logit, IoU 1e-3 absolute; the
    masks' pixel agreement recorded), `SamAutomaticMaskGenerator.generate`
    at 16 points a side (256 points decoded in one batch) and, for the two
    checkpoints' bf16 paths (the int8 path shares ViT-L's prompt encoder
    and decoder), the generator's kept set equal to the CPU's from the same
    embedding at an IoU threshold placed in a gap of the candidates' scores
    (their areas and RLEs recorded), and the decoder exported with
    `export_sam_decoder`, loaded and run with a mask input and
    `has_mask_input` 1 and 0 (within 1e-5 of the largest logit of
    `make_decoder_fn` on the same inputs). Each step's time goes out on a
    line of its own; then `sam_hd64_kernel_gates` and
    `sam_hd64_i8_kernel_gates`."""
    import os

    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.data.tools import rle as rle_codec
    from ullava_tpu_torch.microbench import stage2_grads
    from ullava_tpu_torch.models import weights
    from ullava_tpu_torch.models.sam import automatic, build, export, image_encoder, predictor
    from ullava_tpu_torch.models.sam.convert import convert_sam
    from ullava_tpu_torch.ops import quant

    t_phase = time.perf_counter()
    tol, dec_tol, exp_tol = 5e-2, 1e-3, 1e-5
    image = np.random.default_rng(24).integers(0, 256, (*SAM_PRED_HW, 3), dtype=np.uint8)

    def step(path, name, seconds, **kw):
        print(json.dumps({"phase": "sam_predictor_step", "path": path, "step": name, "s": seconds,
                          **kw, "card": card}), flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    files, converted, write_s, convert_s = {}, {}, {}, {}
    for size in ("vit_l", "vit_b"):
        files[size], write_s[size] = timed(lambda s_=size: write_sam_checkpoint(root, s_, gen))
        sd = weights.load_state_dict(files[size])
        converted[size], convert_s[size] = timed(lambda s_=size, sd=sd: convert_sam(
            sd, getattr(build, f"sam_{s_}")(torch.bfloat16), device="cuda"))
        del sd
        step(size, "write_checkpoint", write_s[size])
        step(size, "convert", convert_s[size])

    paths, launches_total, int8_encoders = {}, {k: 0 for k in kernels.KERNELS}, {}
    for path, size, weights_ in SAM_PRED_PATHS:
        cfg = getattr(build, f"sam_{size}")(torch.bfloat16)
        params = dict(converted[size])
        if weights_ in ("int8", "int8_i8"):
            if size not in int8_encoders:  # both score forms serve the same weights
                enc = quant.quantize_tree(params["image_encoder"], ("qkv", "proj", "fc1", "fc2"))
                int8_encoders[size] = image_encoder.precompute_window_bias_weights(enc, cfg.vision)
                del enc
            params["image_encoder"] = int8_encoders[size]
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
                cfg.vision, mlp_w8a8=True, attn_dots_i8=weights_ == "int8_i8"))
        elif weights_ == "packed":
            params["image_encoder"] = image_encoder.pack_sam_attention(params["image_encoder"],
                                                                      cfg.vision)
        v = cfg.vision
        pred = predictor.SamPredictor(params, cfg, device="cuda")
        pred.set_image(image)  # first call: host buffers, the kernels' attributes
        kernels.reset_launch_counts()
        _, set_s = timed(lambda: pred.set_image(image))
        launches = kernels.launch_counts()
        expect = sam_predictor_launches(v.depth, v.num_groups, weights_)
        must(f"{path} launches", launches == expect,
             {k: (launches[k], expect[k]) for k in launches if launches[k] != expect[k]})
        for k_, n in launches.items():
            launches_total[k_] += n
        step(path, "set_image", set_s)
        emb = pred._embedding
        pre = torch.as_tensor(pred.seg_tool.preprocess(pred.seg_tool.apply_image(image))[None],
                              device="cuda")
        with stage2_grads.plain_on_card("all"):
            before = kernels.launch_counts()
            plain = image_encoder.encode(params["image_encoder"], v, pre)
            torch.cuda.synchronize()
            ran = {k_: n - before[k_] for k_, n in kernels.launch_counts().items() if n != before[k_]}
        must(f"{path} plain witness launched nothing", not ran, ran)
        enc_err = row_rel_err(emb, plain)
        must(f"{path} encoder against the plain path", enc_err <= tol, enc_err)
        del plain, pre

        # Prompt encoding, decoding and host post-processing: card and CPU
        # from the same embedding.
        cpu_params = {k_: stage2_grads.cpu_copy(params[k_])
                      for k_ in ("prompt_encoder", "mask_decoder")}
        cpu = predictor.SamPredictor(cpu_params, cfg, device="cpu")
        cpu._embedding, cpu.original_size, cpu.input_size = (
            emb.cpu(), pred.original_size, pred.input_size)
        pred.predict(**SAM_PRED_PROMPTS["one_point"])  # first call
        predicts = {}
        surface = path in SAM_PRED_SURFACE
        for name, prompt in SAM_PRED_PROMPTS.items():
            if not surface and name != "two_points_and_box":
                continue
            kw = {k_: (np.asarray(v_) if isinstance(v_, list) else v_) for k_, v_ in prompt.items()}
            (m, i, lo), pred_s = timed(lambda kw=kw: pred.predict(**kw))
            cm, ci, clo = cpu.predict(**kw)
            logit_err = float(np.abs(lo - clo).max() / max(np.abs(clo).max(), 1e-30))
            iou_err = float(np.abs(i - ci).max())
            agree = float((m == cm).mean())
            must(f"{path} predict {name}", logit_err <= dec_tol and iou_err <= dec_tol,
                 (logit_err, iou_err))
            must(f"{path} predict {name} shapes", m.shape == (len(i), *SAM_PRED_HW), m.shape)
            predicts[name] = {"s": pred_s, "masks": len(i), "low_res_rel_err": logit_err,
                              "iou_abs_err": iou_err, "mask_pixel_agreement": agree,
                              "iou": i.tolist()}
            step(path, f"predict {name}", pred_s, masks=len(i))
        paths[path] = {
            "size": size, "weights": weights_, "set_image_s": set_s,
            "encoder_row_rel_err": enc_err, "encoder_tol": tol,
            "launches": {k_: n for k_, n in launches.items() if n}, "predict": predicts,
            "decode_tol": dec_tol}
        if not surface:
            del pred, cpu, params, emb
            torch.cuda.empty_cache()
            continue
        one_point_low = torch.as_tensor(pred.predict(**{
            k_: np.asarray(v_) for k_, v_ in SAM_PRED_PROMPTS["one_point"].items()})[2][:1])

        # The automatic generator: one batch of 256 points; its kept set
        # against the CPU's from the same embedding.
        gkw = dict(points_per_side=SAM_PRED_POINTS_PER_SIDE, stability_score_thresh=-1.0)
        probe = automatic.SamAutomaticMaskGenerator(params, cfg, device="cuda", **gkw)
        pts = probe.grid * np.array([pred.input_size[1], pred.input_size[0]])
        _, ious = probe._decode_all(emb, torch.as_tensor(pts, dtype=torch.float32, device="cuda"),
                                    torch.ones(len(pts), dtype=torch.int32, device="cuda"))
        thresh, gap = _iou_threshold(ious.float().flatten().tolist(), SAM_PRED_KEEP)
        # The card's and the CPU's fp32 IoU predictions agree within 1e-5.
        must(f"{path} generator threshold gap", gap > 1e-4, gap)
        gen_card = automatic.SamAutomaticMaskGenerator(params, cfg, device="cuda",
                                                       pred_iou_thresh=thresh, **gkw)
        gen_card.generate(image)  # first call
        records, gen_s = timed(lambda: gen_card.generate(image))
        step(path, "generate", gen_s, kept=len(records), points=len(pts))
        paths[path]["generate"] = {"s": gen_s, "points": len(pts), "kept": len(records),
                                   "iou_thresh": thresh, "iou_gap": gap}
        if weights_ == "int8":
            # The int8 towers change the encoder only: the prompt encoder and
            # the decoder are the bf16 path's, held to the CPU and exported there.
            del pred, cpu, probe, gen_card, params, emb
            torch.cuda.empty_cache()
            continue
        args = (emb, pred.input_size, pred.original_size)
        card_kept = gen_card._generate_from(*args)
        gen_cpu = automatic.SamAutomaticMaskGenerator(cpu_params, cfg, device="cpu",
                                                      pred_iou_thresh=thresh, **gkw)
        cpu_kept, cpu_gen_s = timed(lambda: gen_cpu._generate_from(emb.cpu(), *args[1:]))
        # The kept set: the same candidates (their points, in NMS order) on
        # both sides. A mask's pixels at its edge may differ (logits within
        # fp32 noise of 0), so areas and RLEs are recorded, not gated.
        card_pts = [r["point_coords"] for r in card_kept]
        cpu_pts = [r["point_coords"] for r in cpu_kept]
        must(f"{path} generate kept set", card_pts == cpu_pts and len(card_kept) > 0,
             {"card": card_pts, "cpu": cpu_pts})
        must(f"{path} generate from the same image",
             [r["point_coords"] for r in records] == card_pts, len(records))
        iou_gen_err = max(abs(a["predicted_iou"] - b["predicted_iou"])
                          for a, b in zip(card_kept, cpu_kept))
        must(f"{path} generate predicted IoU", iou_gen_err <= dec_tol, iou_gen_err)
        rle_equal = sum(a["segmentation"] == b["segmentation"]
                        for a, b in zip(card_kept, cpu_kept)) / len(card_kept)
        agree = min(float((rle_codec.decode(a["segmentation"]) == rle_codec.decode(
            b["segmentation"])).mean()) for a, b in zip(card_kept, cpu_kept))
        area_rel = max(abs(a["area"] - b["area"]) / max(b["area"], 1)
                       for a, b in zip(card_kept, cpu_kept))

        # The decoder export: two points, a mask input, has_mask 1 and 0.
        dec = {k_: params[k_] for k_ in ("prompt_encoder", "mask_decoder")}
        blob, export_s = timed(lambda: export.export_sam_decoder(dec, cfg, num_points=2))
        fn, load_s = timed(lambda: export.load_sam_decoder(blob))
        direct = export.make_decoder_fn(dec, cfg)
        g = cfg.prompt.image_embedding_size
        coords = torch.as_tensor(pred._scale_coords(np.asarray(
            SAM_PRED_PROMPTS["two_points_and_box"]["point_coords"]))[None], device="cuda")
        labels = torch.tensor([[1, 0]], dtype=torch.int32, device="cuda")
        mask_in = one_point_low.reshape(1, 4 * g, 4 * g, 1).to("cuda")
        exported = {}
        for has in (1.0, 0.0):
            ins = (emb.float(), coords, labels, mask_in, torch.full((1,), has, device="cuda"))
            (em, ei, el), call_s = timed(lambda ins=ins: fn(*ins))
            dm, di, dl = direct(*ins)
            err = ((el - dl).abs().max() / dl.abs().max()).item()
            must(f"{path} export has_mask={has:g}", err <= exp_tol and em.shape == dm.shape
                 and (ei - di).abs().max().item() <= exp_tol, err)
            exported[f"has_mask_{has:g}"] = {"low_res_rel_err": err, "call_s": call_s,
                                             "iou": ei.flatten().tolist(),
                                             "masks_shape": list(em.shape)}
        must(f"{path} export mask input counts",
             exported["has_mask_1"]["iou"] != exported["has_mask_0"]["iou"], exported)
        step(path, "export", export_s, bytes=len(blob), load_s=load_s)

        paths[path]["generate"].update(
            cpu_s=cpu_gen_s, rle_equal_share=rle_equal, min_mask_pixel_agreement=agree,
            max_area_rel_diff=area_rel, predicted_iou_abs_err=iou_gen_err)
        paths[path]["export"] = {"s": export_s, "load_s": load_s, "bytes": len(blob),
                                 "tol": exp_tol, **exported}
        del pred, cpu, probe, gen_card, gen_cpu, fn, direct, params, emb
        torch.cuda.empty_cache()

    del int8_encoders
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results, forms = {}, {}
    gates = sam_hd64_kernel_gates(gen, results, forms)
    gates.update(sam_hd64_i8_kernel_gates(gen, results, forms))
    gates_s = time.perf_counter() - t0
    for name in SAM_HD64_NAMES:
        step("kernels", name, results[name]["ms"] / 1e3, ms=results[name]["ms"],
             bound_ms=results[name]["bound_ms"], library_ms=results[name]["library_ms"])
    line = {"phase": "sam_predictor", "card": card, "seconds": time.perf_counter() - t_phase,
            "image": list(SAM_PRED_HW), "write_s": write_s, "convert_s": convert_s,
            "file_gb": {k: os.path.getsize(f) / 1e9 for k, f in files.items()},
            "paths": paths, "kernel_gates_s": gates_s, "kernel_gates": gates,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches_total, "kernel_lines": results, "form_lines": forms}
    print(json.dumps({k: v for k, v in line.items() if k not in ("kernel_lines", "form_lines")}),
          flush=True)
    return line


# ---------------------------------------------------------------------------
# The video path, the web chat, the SAM encoder's "xla" route and the trace
# summary tool: GIFs the phases write go through the video processors into
# `generate(videos=)` (inside the serves) and into the stage-1 step (inside
# the stage-1 phase); `Chat` and the "xla" encode run on the inference
# phase's checkpoint files; `tools/trace_summary` reads the video serve's
# profile.
# ---------------------------------------------------------------------------
VIDEO_B = 16  # GIFs of the video serve
VIDEO_N_FRM = 8  # frames a clip: the temporal tokens, and B x T CLIP frames
VIDEO_GIF_FRAMES, VIDEO_GIF_HW = 12, (240, 320)
# stage1_config's video markers; the video serve's config takes the same.
VIDEO_START, VIDEO_END = 32004, 32005
# Launches of one `generate(videos=)` on the int8 LLM: the int8 serve's
# LLM kernels (the prefill and NEW_TOKENS decode steps), no SAM kernel
# (generation alone), and no CLIP kernel (the tower's plain attention).
VIDEO_SERVE_LAUNCHES = {**INT8_LAUNCHES, **{k: 0 for k in SAM_LAUNCHES}}
# The spliced embeddings (CLIP over B x T frames, the pooling, the
# projector, the splice) against fp32: row-relative, the SAM encoder's gate.
VIDEO_EMBED_TOL = 5e-2
# The first position's logits, the card's kernels against their plain
# versions at full depth, a check of gross faults only: row-relative
# max(5e-2, twice the model's own spread under one bf16 ulp of its input
# embeddings), the plain route on embeddings moved by one ulp in random
# places. At 32 random layers with W8A8 prefill that spread is 0.39 and the
# kernels' error 0.25 on text prompts (`microbench/logits_depth.py`): an
# int8 activation that rounds one step apart moves the next layer's
# output, and random weights carry the move on through the depth. Each
# kernel is held tightly by its own gate at this path's shapes.
VIDEO_LOGITS_TOL = 5e-2
VIDEO_PROFILE_TOKENS = 8  # new tokens of the profiled call whose trace is summarized
TRACE_TOTAL_TOL = 0.01  # the summary's total against the profiler's busy sum


def write_gifs(root, names, rng) -> list:
    """GIFs of `VIDEO_GIF_FRAMES` noise frames of `VIDEO_GIF_HW` under
    `root`, written by Pillow from palette frames (no quantization pass),
    each file with a palette of its own."""
    import os

    import numpy as np
    from PIL import Image

    paths = []
    for name in names:
        palette = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
        frames = []
        for _ in range(VIDEO_GIF_FRAMES):
            im = Image.fromarray(rng.integers(0, 256, VIDEO_GIF_HW, dtype=np.uint8), "P")
            im.putpalette(palette)
            frames.append(im)
        paths.append(os.path.join(root, name))
        frames[0].save(paths[-1], save_all=True, append_images=frames[1:], duration=100, loop=0)
    return paths


def video_serve_phase(cfg, params, card: str) -> tuple:
    """Video captioning at full width on the int8 serve's model (Vicuna-7B,
    32 layers, W8A8 prefill, int8 KV cache; CLIP ViT-L/14 at 224): B=16
    GIFs the phase writes (Pillow), read by `video_eval`'s pipeline with
    the GIF reader (uniform sampling of 8 frames, shortest side to 224,
    center crop, CLIP normalization; its host seconds apart), 320-token
    prompts whose video span holds 8 temporal and 256 spatial tokens,
    greedy `generate(videos=)` for 32 new tokens: 128 CLIP frames. The
    launch counts are set to 0 just before the first call and read just
    after (exactly `VIDEO_SERVE_LAUNCHES`). Gates: the prompts are the
    sequences' prefixes and every token in the vocabulary; the splice
    reached the model (the answer without videos differs);
    `make_generate_fn` gives the same tokens; the spliced embeddings equal
    the same function's in fp32 on the card outside the video span and lie
    within `VIDEO_EMBED_TOL` (row-relative) inside it; the first generated
    position's logits within `VIDEO_LOGITS_TOL`, or twice the model's
    one-ulp spread where larger (the limit applied is printed), of the same
    call with every kernel swapped for its plain version on the card
    (`stage2_grads.plain_on_card("int8_llm")`, which launches nothing).
    Then one profiled call of `VIDEO_PROFILE_TOKENS` new tokens, whose
    Chrome trace `tools/trace_summary` reads: its device self-time total
    within `TRACE_TOTAL_TOL` of the profiler's busy sum.
    Returns (the video serve line, the trace summary line)."""
    import os

    import numpy as np
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench import stage2_grads
    from ullava_tpu_torch.data.processors import video_processor
    from ullava_tpu_torch.models import generate, llama, ullava_core
    from ullava_tpu_torch.ops.quant import apply_linear
    from ullava_tpu_torch.tools import trace_summary

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, core=dataclasses.replace(
        cfg.core, vid_start_id=VIDEO_START, vid_end_id=VIDEO_END))
    core = params["core"]
    T, P = VIDEO_N_FRM, cfg.core.vision.num_patches
    root = tempfile.mkdtemp(prefix="ullava_video_serve_")
    try:
        rng = np.random.default_rng(27)
        t0 = time.perf_counter()
        paths = write_gifs(root, [f"clip{i}.gif" for i in range(VIDEO_B)], rng)
        write_s = time.perf_counter() - t0
        proc = video_processor.VideoEvalProcessor(image_size=224, n_frm=T)
        proc.media_loader = video_processor.load_gif_frames  # video_eval's pipeline on GIFs
        t0 = time.perf_counter()
        clips = np.stack([proc(p) for p in paths])
        host_s = time.perf_counter() - t0
        must("video clips", clips.shape == (VIDEO_B, T, 224, 224, 3)
             and clips.dtype == np.float32 and np.isfinite(clips).all(), clips.shape)

        ids = rng.integers(5, 1000, size=(VIDEO_B, PROMPT))
        ids[:, 1], ids[:, 2:2 + T + P], ids[:, 2 + T + P] = VIDEO_START, 3, VIDEO_END
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        input_ids = torch.as_tensor(ids, device="cuda")
        lens = torch.full((VIDEO_B,), PROMPT, dtype=torch.int32, device="cuda")
        videos = torch.from_numpy(clips).pin_memory().to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        gc = generate.GenerateConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)

        def run(videos=videos, gen_cfg=gc):
            return generate.generate(core, cfg.core, gen_cfg, input_ids=input_ids,
                                     prompt_lens=lens, videos=videos)

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out, first_s = timed(run)
        launches = kernels.launch_counts()
        _check_launches("video_serve", launches, VIDEO_SERVE_LAUNCHES)
        seqs = out["sequences"].cpu()
        must("video_serve sequences", tuple(seqs.shape) == (VIDEO_B, PROMPT + NEW_TOKENS)
             and torch.equal(seqs[:, :PROMPT], torch.as_tensor(ids).to(seqs.dtype))
             and int(seqs.min()) >= 0 and int(seqs.max()) < cfg.core.llm.vocab_size
             and bool((out["lengths"] == PROMPT + NEW_TOKENS).all()),
             {"shape": tuple(seqs.shape), "lengths": out["lengths"].tolist()})
        by_fn = generate.make_generate_fn(cfg.core, gc)(core, input_ids, lens, videos=videos)
        must("video_serve make_generate_fn", torch.equal(by_fn["sequences"], out["sequences"]),
             "the serving closure's tokens differ from generate's")
        no_video = run(videos=None, gen_cfg=dataclasses.replace(gc, max_new_tokens=1))
        must("video_serve splice", not torch.equal(no_video["hidden_last"][:, :PROMPT],
                                                   out["hidden_last"][:, :PROMPT]),
             "the prompt's hidden states without the videos are those with them")
        del by_fn, no_video

        # What the LLM is fed: the spliced embeddings against the same
        # function in fp32 on the card from the same weights. This model's
        # CLIP runs no kernel, and neither route launches one.
        span = torch.zeros(PROMPT, dtype=torch.bool)
        span[2:2 + T + P] = True
        f32 = torch.float32
        cfg32 = dataclasses.replace(
            cfg.core, llm=dataclasses.replace(cfg.core.llm, dtype=f32),
            vision=dataclasses.replace(cfg.core.vision, dtype=f32))
        core32 = stage2_grads.cpu_copy({"vision": core["vision"], "projector": core["projector"],
                                        "llm": {"embed_tokens": core["llm"]["embed_tokens"]}},
                                       device="cuda")
        with torch.no_grad():
            emb, emb_launched = stage2_grads._launched(
                lambda: ullava_core.embed_multimodal(core, cfg.core, input_ids, None, videos))
            emb32, emb32_launched = stage2_grads._launched(
                lambda: ullava_core.embed_multimodal(core32, cfg32, input_ids, None, videos))
        embed_err = row_rel_err(emb[:, span], emb32[:, span])
        must("video_serve embeddings launch nothing", not emb_launched and not emb32_launched,
             (emb_launched, emb32_launched))
        must("video_serve spliced embeddings against fp32",
             torch.equal(emb[:, ~span].float(), emb32[:, ~span]) and embed_err <= VIDEO_EMBED_TOL,
             {"video_rows_row_rel_err": embed_err})
        del core32, emb, emb32

        # The first generated position: logits of the last prompt row.
        rows = torch.arange(VIDEO_B, device="cuda")

        def first_logits(o):
            h = o["hidden_last"][rows, lens.long() - 1].to(cfg.core.llm.dtype)
            return apply_linear(h, core["llm"]["lm_head"]).float()

        def prefill_logits(bump):
            # generate's prefill on the video embeddings, each moved by one
            # bf16 ulp where `bump` is 1.
            emb = ullava_core.embed_multimodal(core, cfg.core, input_ids, None, videos)
            emb = (emb.float() * (1 + bump * 2.0**-8)).to(emb.dtype)
            cache = llama.init_kv_cache(cfg.core.llm, VIDEO_B, PROMPT + 1, device="cuda")
            pre = llama.forward(core["llm"], cfg.core.llm, inputs_embeds=emb, kv_lens=lens,
                                kv_cache=cache, compute_logits=False)
            return first_logits({"hidden_last": pre["hidden_states"]})

        with stage2_grads.plain_on_card("int8_llm"), torch.no_grad():
            plain, plain_launched = stage2_grads._launched(
                lambda: run(gen_cfg=dataclasses.replace(gc, max_new_tokens=1)))
            bump = torch.randint(0, 2, (VIDEO_B, PROMPT, cfg.core.llm.hidden_size),
                                 generator=torch.Generator(device="cuda").manual_seed(27),
                                 device="cuda").float()
            floor_ref, floor_launched = stage2_grads._launched(lambda: prefill_logits(0 * bump))
            floor_bumped, _ = stage2_grads._launched(lambda: prefill_logits(bump))
        must("video_serve plain route", not plain_launched and not floor_launched,
             (plain_launched, floor_launched))
        ref_logits, plain_logits = first_logits(out), first_logits(plain)
        logits_err = row_rel_err(ref_logits, plain_logits)
        ulp_spread = row_rel_err(floor_bumped, floor_ref)
        logits_limit = max(VIDEO_LOGITS_TOL, 2 * ulp_spread)
        argmax_equal = float((ref_logits.argmax(-1) == plain_logits.argmax(-1)).float().mean())
        must("video_serve plain prefill", torch.equal(floor_ref, plain_logits),
             "the floor's unmoved prefill is not generate's")
        must("video_serve first logits", logits_err <= logits_limit,
             {"row_rel_err": logits_err, "one_ulp_spread": ulp_spread, "limit": logits_limit})
        del plain, bump, floor_ref, floor_bumped

        runs = [timed(run)[1] for _ in range(3)]
        generate_s = sorted(runs)[1]
        with torch.no_grad():
            _, embed_s = timed(lambda: ullava_core.embed_multimodal(
                core, cfg.core, input_ids, None, videos))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        t_trace = time.perf_counter()
        trace = os.path.join(root, "video_serve_trace.json")
        prof = profile_serve(lambda: timed(lambda: run(gen_cfg=dataclasses.replace(
            gc, max_new_tokens=VIDEO_PROFILE_TOKENS))), trace_path=trace)
        profile_s = time.perf_counter() - t_trace
        t0 = time.perf_counter()
        summary = trace_summary.summarize(trace, n=8)
        summary_s = time.perf_counter() - t0
        trace_mb = os.path.getsize(trace) / 1e6
    finally:
        shutil.rmtree(root, ignore_errors=True)
    busy = prof["device_busy_s"]
    must("video_serve profile", isinstance(busy, float) and busy > 0, busy)
    trace_err = abs(summary["total_ms"] - busy * 1e3) / (busy * 1e3)
    must("trace_summary total", trace_err <= TRACE_TOTAL_TOL,
         {"summary_ms": summary["total_ms"], "profiler_busy_ms": busy * 1e3})
    line = {
        "phase": "video_serve", "card": card, "batch": VIDEO_B, "frames": T,
        "clip_frames": VIDEO_B * T, "video_tokens": T + P, "prompt_tokens": PROMPT,
        "new_tokens": NEW_TOKENS, "gif_frames_hw": [VIDEO_GIF_FRAMES, *VIDEO_GIF_HW],
        "write_gifs_s": write_s, "host_decode_crop_s": host_s, "h2d_s": h2d_s,
        "first_generate_s": first_s, "generate_s": generate_s, "generate_runs_s": runs,
        "videos_per_s": VIDEO_B / generate_s, "clip_projector_splice_s": embed_s,
        "embeddings_row_rel_err": embed_err, "embeddings_tol": VIDEO_EMBED_TOL,
        "first_logits_row_rel_err": logits_err, "first_logits_limit": logits_limit,
        "first_logits_one_ulp_spread": ulp_spread, "first_argmax_equal": argmax_equal,
        "make_generate_fn_tokens_equal": True, "peak_mem_gb": peak_gb,
        "profiled_new_tokens": VIDEO_PROFILE_TOKENS,
        "device_busy_s": busy, "profiled_wall_s": prof["wall_s"],
        "device_idle_share": prof["device_idle_share"],
        "top_device_ms": dict(list(prof["top_device_ms"].items())[:8]),
        "seconds": time.perf_counter() - t_phase, "launches": launches,
    }
    trace_line = {"phase": "trace_summary", "card": card, "trace_mb": trace_mb,
                  "profile_s": profile_s, "summary_s": summary_s,
                  "total_ms": summary["total_ms"], "profiler_busy_ms": busy * 1e3,
                  "rel_diff": trace_err, "tol": TRACE_TOTAL_TOL,
                  "seconds": profile_s + summary_s}
    print(json.dumps(line), flush=True)
    print(json.dumps(trace_line), flush=True)
    # The tool's own top lines, as it prints them.
    for key, ms, count in summary["ops"]:
        print(f"{ms:9.2f} ms x{count:5d}  {key[:120]}", flush=True)
    return line, trace_line


def write_video_stage1_data(root, rng) -> dict:
    """The video stage-1 step's files under `root`: 2 chat PNGs of 480 x
    640 with `chat.json`, and 2 GIFs (`write_gifs`) with `tgif.json`."""
    import os

    import numpy as np

    images = os.path.join(root, "images")
    os.makedirs(images)
    chat, tgif = [], []
    for i in range(2):
        with open(os.path.join(images, f"chat{i}.png"), "wb") as f:
            f.write(png_bytes(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)))
        chat.append({"image": f"chat{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nDescribe the picture ."},
            {"from": "gpt", "value": f"A picture of noise , number {i} ."}]})
        tgif.append({"gif": f"clip{i}.gif", "conversations": [
            {"from": "human", "value": "What happens in the clip ?"},
            {"from": "gpt", "value": f"Noise moves , clip {i} ."}]})
    write_gifs(root, [t["gif"] for t in tgif], rng)
    paths = {"images": images, "gifs": root}
    for name, items in (("chat", chat), ("tgif", tgif)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(items, f)
    return paths


def video_stage1_configs(data) -> tuple:
    """(dataset, processor) configs of the step: `configs/train/
    ullava_core.yaml`'s `llava_cc3m` and `tgif` entries and processors,
    pointed at the phase's files."""
    dataset = {
        "llava_cc3m": {"data_type": "image", "image_token_len": 256,
                       "vis_processor": "clip_image",
                       "build_info": {"anno_dir": data["chat"], "image_dir": data["images"],
                                      "portion": 1.0}},
        "tgif": {"data_type": "gif", "image_token_len": 256, "vis_processor": "gif_train",
                 "build_info": {"anno_dir": data["tgif"], "image_dir": data["gifs"],
                                "portion": 1.0}},
    }
    processor = {"clip_image": {"image_size": 224},
                 "gif_train": {"n_frm": VIDEO_N_FRM, "image_size": 224}}
    return dataset, processor


def video_stage1_phase(cfg, core_params, training_cfg, card: str) -> dict:
    """A stage-1 step on a batch of GIF and image rows at full width, on
    the stage-1 phase's weights: one B=4 batch (2 GIF rows, 2 image rows)
    from files the phase writes, through the `tgif` and `llava_cc3m`
    builders, `image_video_collator` and the loader (to the card as the
    training CLIs send batches), the toy tokenizer, whose marker ids the
    model's config takes. Each row's missing medium is zeros, and a row
    without its marker is not spliced: B x T = 32 CLIP frames and 4 images
    are encoded. A fresh optimizer state (the pretraining policy, the
    phase's schedule over 4 steps): one warm step with the launch counts
    set to 0 just before it and read just after (exactly `TRAIN_LAUNCHES`),
    then three timed steps. Gates: S <= 1024; finite losses and gradient
    norms; the projector moved; every frozen leaf bit-unchanged; the first
    loss within 5e-2 (relative) of the same batch's loss with the kernels
    swapped for their plain versions on the card (which launches nothing)."""
    import math
    import os
    import random

    import numpy as np
    import torch

    from ullava_tpu_torch import kernels, train
    from ullava_tpu_torch.config import ConfigNode
    from ullava_tpu_torch.constants import MM_TOKENS
    from ullava_tpu_torch.data.loader import DataLoader
    from ullava_tpu_torch.microbench.stage2_grads import _launched, plain_on_card
    from ullava_tpu_torch.models import ullava_core
    from ullava_tpu_torch.tasks import setup_task
    from ullava_tpu_torch.training import optim

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from toy_tokenizer import ToyLlamaTokenizer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ullava_video_stage1_")
    try:
        data = write_video_stage1_data(root, np.random.default_rng(28))
        tok = ToyLlamaTokenizer(model_max_length=2048)
        tok.add_tokens(MM_TOKENS)
        marker = tok.convert_tokens_to_ids
        cfg = dataclasses.replace(
            cfg, img_start_id=marker("<img_beg>"), img_end_id=marker("</img_end>"),
            vid_start_id=marker("<vid_beg>"), vid_end_id=marker("</vid_end>"))
        dataset_cfg, processor_cfg = video_stage1_configs(data)
        task = setup_task(ConfigNode({"type": "image_text_pretrain",
                                      "collator_type": "image_video_collator"}))
        dataset = task.build_datasets(ConfigNode(dataset_cfg), tok, ConfigNode(processor_cfg),
                                      "conv_simple")
        collator = task.build_collator(tok.pad_token_id, model_max_length=1024)
        random.seed(27)  # the crop windows and the headtail frames
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(iter(DataLoader(dataset, 4, collator, num_workers=2, seed=42,
                                     device="cuda")))
        torch.cuda.synchronize()
        fetch_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    S = batch["input_ids"].shape[1]
    has_video = (batch["input_ids"] == cfg.vid_start_id).any(1)
    has_image = (batch["input_ids"] == cfg.img_start_id).any(1)
    must("video stage-1 batch", S <= 1024 and tuple(batch["videos"].shape[1:]) == (
        VIDEO_N_FRM, 224, 224, 3) and int(has_video.sum()) == 2 and int(has_image.sum()) == 2
         and not bool((has_video & has_image).any())
         and float(batch["videos"][~has_video].abs().max()) == 0.0
         and float(batch["images"][~has_image].abs().max()) == 0.0,
         {"S": S, "video_rows": has_video.tolist(), "image_rows": has_image.tolist()})

    with torch.no_grad(), plain_on_card("llm"):
        plain_loss, plain_launched = _launched(lambda: ullava_core.forward(
            core_params, cfg, input_ids=batch["input_ids"], labels=batch["labels"],
            attn_lens=batch["attn_lens"], images=batch["images"],
            videos=batch["videos"])["loss"].item())
    must("video stage-1 plain route", not plain_launched, plain_launched)

    state, step, _ = train.build_stage1(cfg, core_params, training_cfg, total_steps=4)
    leaves = list(optim.named_leaves(state.params))
    frozen = [(n, t) for n, t in leaves if not t.requires_grad]
    frozen_before = [(n, _fingerprint(t)) for n, t in frozen]
    proj_before = [t.detach().clone() for n, t in leaves if "projector" in n]

    def timed_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].float().item()
        return (loss, gnorm), time.perf_counter() - t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (loss0, gnorm0), first_s = timed_step()
    launches = kernels.launch_counts()
    _check_launches("video_stage1_step", launches, TRAIN_LAUNCHES)
    runs = [timed_step() for _ in range(3)]
    losses = [loss0] + [r[0][0] for r in runs]
    gnorms = [gnorm0] + [r[0][1] for r in runs]
    must("video stage-1 losses", all(math.isfinite(x) for x in losses + gnorms)
         and min(gnorms) > 0, {"losses": losses, "grad_norms": gnorms})
    plain_rel = abs(loss0 - plain_loss) / abs(plain_loss)
    must("video stage-1 first loss against the plain path", plain_rel <= 5e-2,
         {"kernels": loss0, "plain": plain_loss})
    proj_after = [t for n, t in optim.named_leaves(state.params) if "projector" in n]
    moved = [not torch.equal(a, b) for a, b in zip(proj_before, proj_after)]
    frozen_after = [(n, _fingerprint(t)) for n, t in frozen]
    must("video stage-1 leaves", moved and all(moved) and frozen_after == frozen_before,
         {"projector_moved": moved,
          "frozen_changed": [n for (n, a), (_, b) in zip(frozen_before, frozen_after) if a != b]})
    line = {"phase": "video_stage1_step", "card": card, "batch": 4, "seq": S,
            "gif_rows": 2, "image_rows": 2, "clip_frames": 4 * VIDEO_N_FRM, "images": 4,
            "fetch_collate_s": fetch_s, "first_step_s": first_s,
            "step_s": sorted(r[1] for r in runs)[1], "step_runs_s": [r[1] for r in runs],
            "losses": losses, "grad_norms": gnorms, "plain_first_loss": plain_loss,
            "first_loss_rel_to_plain": plain_rel, "projector_leaves_moved": len(moved),
            "frozen_leaves_unchanged": len(frozen_before),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t_phase, "launches": launches}
    print(json.dumps(line), flush=True)
    del state, step, leaves, frozen, proj_before, proj_after, batch
    torch.cuda.empty_cache()
    return line


CHAT_QUERY = "Segment the dog ."
# The canvas route's model inputs (`ops/image_ops` on the card) against the
# same canvas through the same functions on the host: SAM's normalization
# within 1e-5 (the JAX package's device-against-host bound); CLIP's
# antialiased bicubic resize, whose card and host kernels sum their taps in
# other orders, within a hundredth of one uint8 step of its input in
# normalized units, over CLIP_STD's least (1.5e-4; 1.6e-5 measured on one H100).
CHAT_SAM_TOL, CHAT_CLIP_TOL = 1e-5, 0.01 / (255 * 0.26130258)
CHAT_READOUT_TOL = 5e-2  # reference_gate's: each readout against its largest value
XLA_ROUTE_TOL = 5e-2  # the SAM encoder's gate: row-relative, against the kernels' route


def chat_phase(paths, card: str) -> tuple:
    """`webui.gradio_chat.Chat` over the inference phase's checkpoint files
    (the same config, image, query and toy tokenizer), answering at
    temperature 0 for 32 new tokens on both preprocess routes, each call
    with the launch counts set to 0 just before it and read just after
    (exactly `inference_launches(32)`). The host route's text, masks and
    boxes must equal `inference_ullava.run_once`'s at temperature 0. The
    canvas route (`ops/image_ops` on the card) is held on its own inputs:
    those inputs against the same canvas preprocessed on the host
    (`CHAT_SAM_TOL`, `CHAT_CLIP_TOL`); its greedy readouts against the
    port's plain path in fp32 on the card, every kernel swapped for its
    plain version, as `reference_gate` holds the host route against it on
    the CPU (`greedy_readout`, `readout_errs`: the same tokens, each readout
    within `CHAT_READOUT_TOL`; the masks at the image's size equal wherever
    the reference's logit lies outside that band); the same answer on that
    plain path with the same text. Its agreement with run_once (other
    resizes) is a reading. Then the "xla" route: one encode of the query's
    SAM input by the chat model's encoder with `attn_kernel="xla"` on the
    card's tensors, which launches no kernel, within `XLA_ROUTE_TOL` of the
    kernels' route. Returns (the chat line, the xla route line)."""
    import os

    import numpy as np
    import torch

    from ullava_tpu_torch import inference_ullava, kernels
    from ullava_tpu_torch.config import Config
    from ullava_tpu_torch.microbench import stage2_grads
    from ullava_tpu_torch.models import build  # noqa: F401  (registers the archs)
    from ullava_tpu_torch.models.sam import image_encoder
    from ullava_tpu_torch.models.sam.build import postprocess_masks_host
    from ullava_tpu_torch.ops import image_ops
    from ullava_tpu_torch.webui.gradio_chat import Chat

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from toy_tokenizer import ToyLlamaTokenizer

    t_phase = time.perf_counter()
    cfg = Config(cfg_dict={
        "model": {"arch": "ullava", "conv_type": "conv_sep2", "quantize": "int8",
                  "kv_cache": "int8", **paths},
        "task": {"type": "image_text_evaluate"}, "processor": {}, "training": {}})
    image = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    H, W = image.shape[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chat = Chat(cfg, tokenizer=ToyLlamaTokenizer(model_max_length=2048))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    u_cfg, tok = chat.u_cfg, chat.tokenizer
    ref = inference_ullava.run_once(cfg, image, CHAT_QUERY, temperature=0.0,
                                    max_new_tokens=INFERENCE_NEW_TOKENS,
                                    tokenizer=ToyLlamaTokenizer(model_max_length=2048))
    torch.cuda.empty_cache()

    def agreement(got, want):
        boxes = len(got["boxes"]) == len(want["boxes"]) > 0
        return {"text_equal": got["text"] == want["text"],
                "mask_agreement": [float((g == r).mean())
                                   for g, r in zip(got["masks"], want["masks"])],
                "box_err": float(np.abs(np.subtract(got["boxes"], want["boxes"])).max())
                / max(H, W) if boxes else float("inf")}

    routes, answers = {}, {}
    for route, device_preprocess in (("host", False), ("canvas", True)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = chat.seg(image, CHAT_QUERY, temperature=0.0, max_new_tokens=INFERENCE_NEW_TOKENS,
                       device_preprocess=device_preprocess)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        steps = len(got["text"].split())
        _check_launches(f"chat {route}", launches, inference_launches(steps))
        must(f"chat {route} answer", len(got["masks"]) == 3 and len(got["boxes"]) == 3
             and all(m.shape == (H, W) for m in got["masks"]), got["text"])
        answers[route] = got
        routes[route] = {"seg_s": seg_s, "new_tokens": steps,
                         "against_run_once": agreement(got, ref), "launches": launches}
    host = routes["host"]["against_run_once"]
    must("chat host route equals run_once", host["text_equal"]
         and min(host["mask_agreement"]) == 1.0 and host["box_err"] == 0.0, host)

    # The canvas route on its own inputs.
    t0 = time.perf_counter()
    inputs, _, hw = inference_ullava.prepare_query(u_cfg, tok, image, CHAT_QUERY, "conv_sep2",
                                                   "cuda", device_preprocess=True)
    canvas, hw_host = image_ops.make_canvas(image, u_cfg.sam.vision.img_size)
    clip_host, sam_host = image_ops.preprocess_canvas(
        torch.as_tensor(canvas[None]), torch.tensor([hw_host], dtype=torch.int32),
        u_cfg.core.vision.image_size)
    clip_d = (inputs["images"].cpu() - clip_host).abs()
    sam_err = float((inputs["images_sam"].cpu() - sam_host).abs().max())
    pre = {"clip_max": float(clip_d.max()), "clip_mean": float(clip_d.mean()), "sam_max": sam_err}
    must("chat canvas inputs against the host", tuple(hw) == tuple(hw_host)
         and pre["clip_max"] <= CHAT_CLIP_TOL and sam_err <= CHAT_SAM_TOL, pre)
    got = greedy_readout(chat.params, u_cfg, inputs)
    params32, cfg32 = stage2_grads.cpu_copy(chat.params, device="cuda"), fp32_config(u_cfg)
    with stage2_grads.plain_on_card("all"):
        plain, plain_launched = stage2_grads._launched(
            lambda: greedy_readout(params32, cfg32, inputs))
        plain_answer, answer_launched = stage2_grads._launched(lambda: inference_ullava.answer(
            cfg32, params32, tok, image, CHAT_QUERY, temperature=0.0,
            max_new_tokens=INFERENCE_NEW_TOKENS, device="cuda", device_preprocess=True))
    del params32
    must("chat plain route launches nothing", not plain_launched and not answer_launched,
         (plain_launched, answer_launched))
    errs = readout_errs(got, plain)

    def post(low_res):
        return np.stack(postprocess_masks_host(low_res.numpy(), input_size=hw, original_size=(H, W),
                                               img_size=u_cfg.sam.vision.img_size))

    must("chat canvas masks", got["low_res_masks"].shape == plain["low_res_masks"].shape
         and got["low_res_masks"].shape[0] > 0, errs)
    m_got, m_ref = post(got["low_res_masks"]), post(plain["low_res_masks"])
    sure = np.abs(m_ref) > CHAT_READOUT_TOL * np.abs(m_ref).max()
    same = (m_got > 0) == (m_ref > 0)
    canvas_line = {"inputs": pre, "readout_rel_err": errs, "tol": CHAT_READOUT_TOL,
                   "mask_pixels_outside_band": float(sure.mean()),
                   "masks_equal_outside_band": bool(same[sure].all()),
                   "mask_agreement": float(same.mean()),
                   "plain_answer": agreement(answers["canvas"], plain_answer),
                   "s": time.perf_counter() - t0}
    must("chat canvas route against the plain path",
         all(e <= CHAT_READOUT_TOL for e in errs.values())
         and canvas_line["masks_equal_outside_band"]
         and canvas_line["plain_answer"]["text_equal"], canvas_line)
    routes["canvas"]["plain_path"] = canvas_line
    del got, plain, plain_answer, m_got, m_ref

    # The SAM encoder's "xla" route on the card's tensors.
    t_xla = time.perf_counter()
    inputs, _, _ = inference_ullava.prepare_query(u_cfg, tok, image, CHAT_QUERY, "conv_sep2",
                                                  "cuda")
    enc = chat.params["sam"]["image_encoder"]
    x = inputs["images_sam"]
    kernel_route = image_encoder.encode(enc, u_cfg.sam.vision, x)
    xla_cfg = dataclasses.replace(u_cfg.sam.vision, attn_kernel="xla")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, xla_launched = stage2_grads._launched(lambda: image_encoder.encode(enc, xla_cfg, x))
    xla_s = time.perf_counter() - t0
    xla_err = row_rel_err(got, kernel_route)
    must("xla route launches nothing", not xla_launched, xla_launched)
    must("xla route against the kernels' route", bool(torch.isfinite(got).all())
         and got.shape == kernel_route.shape and xla_err <= XLA_ROUTE_TOL, xla_err)
    xla_line = {"phase": "xla_route", "card": card, "encoder": "SAM ViT-H, int8 weights",
                "batch": 1, "encode_s": xla_s, "row_rel_err": xla_err, "tol": XLA_ROUTE_TOL,
                "kernel_launches": 0, "seconds": time.perf_counter() - t_xla}
    del chat, inputs, enc, x, kernel_route, got
    torch.cuda.empty_cache()
    chat_line = {"phase": "chat", "card": card, "build_s": build_s,
                 "seconds": time.perf_counter() - t_phase - xla_line["seconds"],
                 "run_once_text": ref["text"], "routes": routes,
                 "launches": routes["host"]["launches"]}
    print(json.dumps(chat_line), flush=True)
    print(json.dumps(xla_line), flush=True)
    return chat_line, xla_line


def check_draws(seeds) -> int:
    """The training checks (`check_stage1`, `check_stage2`) on other draws:
    each seed's own generator in place of the run's shared one. Prints
    each draw's readings, then the stage-2 check's draw again leaf by leaf
    with the witnesses of `microbench.stage2_grads`; 1 if any reading
    exceeds the tolerance."""
    import torch

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench import stage2_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    tol, bad = 5e-2, 0
    for seed in seeds:
        errs: dict = {}
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        check_stage1(gen, errs)
        drawn = gen.get_state()
        check_stage2(gen, errs)
        over = {k: v for k, v in errs.items() if not v <= tol}
        bad += bool(over)
        print(json.dumps({"phase": "check_draw", "seed": seed, "rel_err": errs, "tol": tol,
                          "over": over, "seconds": time.perf_counter() - t0}), flush=True)
        gen.set_state(drawn)
        stage2_grads.read_draw(gen, seed)
    return 1 if bad else 0


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
        return 2
    from ullava_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    timeline, t_mark = {}, [time.perf_counter()]

    def mark(name):  # the wall seconds of each phase, for the timeline line
        now = time.perf_counter()
        timeline[name] = now - t_mark[0]
        t_mark[0] = now

    t0 = time.perf_counter()
    built = kernels.build_all(verbose=True, mutants=[
        *TRAIN_MUTANTS.values(), K15_MASK_MUTANT, *WQ_MUTANTS.values(), *I8_MUTANTS.values(),
        *PACKED_MUTANTS.values(), *V2_MUTANTS.values(), *GLOBAL_Y_MUTANTS.values(),
        *QUAD_MAX_MUTANTS.values(), RECT_PAD_MUTANT, *K2_MUTANTS.values(),
        *K12_MUTANTS.values(), *K13_MUTANTS.values(), *K8_MUTANTS.values(),
        *BWD_MUTANTS.values(), *K9_MUTANTS.values(), *K10_MUTANTS.values(),
        *K1_MUTANTS.values(), *K7_MUTANTS.values(), *WQ_WIDEN_MUTANTS.values(),
        *WQ_EPILOGUE_MUTANTS.values(), WQ_DUAL_MUTANT, *K4_MUTANTS.values(),
        *K18_MUTANTS.values()])
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "sources": sorted(built)}), flush=True)
    mark("build")

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_results = kernel_phases(gen)
    int8_results = int8_kernel_phases(gen)
    sam_int8_results = sam_int8_kernel_phases(gen)
    results = {**bf16_results, **int8_results, **sam_int8_results}
    # Its own generator: the phases after it draw the inputs they drew
    # before it existed (the check phase's small stage-2 model is
    # sensitive to its draw, PERF.md section 7).
    mlp_microbench = mlp_v2_phase(torch.Generator(device="cuda").manual_seed(9), results)
    resident_kernel_phases(gen, results)
    resident_names = ("fused_ln_linear_dual", "fused_window_attention_rect")
    train_kernel_phases(gen, results)
    weight_only_kernel_phases(gen, results)
    all_int8_kernel_phases(gen, results)
    packed_kernel_phases(gen, results)
    mark("kernels")

    from ullava_tpu_torch.models import ullava
    from ullava_tpu_torch.models.sam import image_encoder

    # The first three serves hold the block window layout, as they did
    # before the resident one became the default; the fourth serves it.
    resident_cfg = full_config()
    cfg = dataclasses.replace(resident_cfg, sam=dataclasses.replace(
        resident_cfg.sam, vision=dataclasses.replace(
            resident_cfg.sam.vision, window_layout="block")))
    t0 = time.perf_counter()
    params = ullava.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve_line, profile_line = serve_phase("serve", cfg, params, B, BF16_LAUNCHES)

    # The same bf16 weights with the SAM image encoder packed head-major
    # (`bench.py`'s BENCH_QUANT=0 BENCH_PACKED=1); the packed copy is freed
    # before the next serve.
    t0 = time.perf_counter()
    packed = {**params, "sam": {**params["sam"], "image_encoder": image_encoder.pack_sam_attention(
        params["sam"]["image_encoder"], cfg.sam.vision)}}
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    packed_line, packed_profile = serve_phase("packed_serve", cfg, packed, B, PACKED_LAUNCHES)
    packed_line["pack_s"] = pack_s
    packed_line["block_serve_sam_encode_s"] = serve_line["sam_encode_s"]
    del packed
    torch.cuda.empty_cache()

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
    parallel_serve_line = parallel_serve(cfg8, params)
    # Video captioning on the same int8-LLM model; its profile's trace
    # goes through `tools/trace_summary`.
    video_line, trace_line = video_serve_phase(cfg8, params, card_name_and_power_limit())

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

    # What is served by default: the same fully int8 model with the
    # composite bias weights and the default (resident) window layout.
    t0 = time.perf_counter()
    ullava.precompute_window_bias_weights(params, cfg88)
    torch.cuda.synchronize()
    bias_weights_s = time.perf_counter() - t0
    cfg_res = dataclasses.replace(cfg88, sam=dataclasses.replace(
        sam8, vision=dataclasses.replace(
            sam8.vision, window_layout=resident_cfg.sam.vision.window_layout)))
    resident_line, resident_profile = serve_phase(
        "sam_resident_serve", cfg_res, params, B_INT8, SAM_RESIDENT_LAUNCHES)

    # The all-int8 serve on the same parameters: int8 scores in the SAM
    # attention kernels (`attn_dots_i8`), CLIP's linears W8A8 and its
    # attention through the flash kernel (`bench.py`'s BENCH_ATTN_I8=1
    # BENCH_CLIP_A8=1 BENCH_CLIP_ATTN=flash).
    cfg_i8 = dataclasses.replace(
        cfg_res,
        core=dataclasses.replace(cfg_res.core, vision=dataclasses.replace(
            cfg_res.core.vision, a8=True, attn_impl="flash")),
        sam=dataclasses.replace(cfg_res.sam, vision=dataclasses.replace(
            cfg_res.sam.vision, attn_dots_i8=True)))
    all_int8_line, all_int8_profile = serve_phase(
        "all_int8_serve", cfg_i8, params, B_INT8, ALL_INT8_LAUNCHES)
    all_int8_line["clip_knobs_s"] = clip_knob_split(cfg_i8, params)
    del params
    torch.cuda.empty_cache()
    mark("serves")

    # The training path, on fresh stage-1 weights once the serving model
    # is freed.
    train_line = stage1_train_phase(gen)
    video_stage1_line = train_line.pop("video_stage1_step")
    # Stage 2 on fresh weights, then the weight-only encode with composite
    # bias weights on its encoder.
    stage2_line, wq_encode_line = stage2_train_phase(gen)
    mark("training")
    parallel_line = {"phase": "parallel", "card": card_name_and_power_limit(),
                     "parts": [train_line["parallel"], stage2_line["parallel"],
                               parallel_serve_line]}
    parallel_line["s"] = sum(p["s"] for p in parallel_line["parts"])
    print(json.dumps(parallel_line), flush=True)
    smi = card_name_and_power_limit()
    # The inference entry point from checkpoint files, on its own generator
    # so that the check phase draws what it drew before it existed; then
    # the training and eval CLIs from the same files (data from numpy's
    # seed 23, the model's new leaves from the build's own generator).
    ckpt_root = tempfile.mkdtemp(prefix="ullava_inference_")
    try:
        inference_line = inference_phase(torch.Generator(device="cuda").manual_seed(22), smi,
                                         ckpt_root)
        mark("inference")
        # The web chat and the SAM encoder's "xla" route on the same files.
        chat_line, xla_line = chat_phase(inference_line["checkpoint_paths"], smi)
        mark("chat")
        train_clis_line = train_clis_phase(inference_line["checkpoint_paths"], smi)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    mark("train_clis")
    # The SAM public surface at ViT-L and ViT-B (the hd 64 kernel forms),
    # on its own generator so that the check phase draws as before.
    sam_root = tempfile.mkdtemp(prefix="ullava_sam_")
    try:
        sam_pred_line = sam_predictor_phase(torch.Generator(device="cuda").manual_seed(24), smi,
                                            sam_root)
    finally:
        shutil.rmtree(sam_root, ignore_errors=True)
    results.update(sam_pred_line.pop("kernel_lines"))
    # The forms of earlier kernels that the phase adds (ViT-B's widths, the
    # packed kernels at hd 64) ride in those kernels' lines.
    for name, extra in sam_pred_line.pop("form_lines").items():
        results[name].update(extra)
    mark("sam_predictor")

    # Each kernel's count on the main path that it was written for: the
    # bf16 serve for the bf16 path's four, the int8 serve for the int8
    # LLM's five, the fully int8 serve for the int8 SAM encoder's three,
    # the resident serve for the resident layout's two, one stage-1 step
    # for the training path's four, one stage-2 step for the weight-only
    # K10 and K12, the weight-only encode with composite weights for K13's,
    # the all-int8 serve for its four forms, the packed serve for the two
    # packed kernels, the MLP microbenchmark for the chunk-pipelined MLP;
    # the two kernels that no path calls report the bf16 serve's count, 0,
    # as they do every serve's; the hd 64 forms the sam_predictor phase's
    # three encodes.
    for name, r in results.items():
        own = (mlp_microbench if name == "fused_mlp_block_v2" else
               sam_pred_line if name in SAM_HD64_NAMES else
               serve_line if name in bf16_results or name in UNCALLED_NAMES else
               packed_line if name in PACKED_NAMES else
               int8_line if name in int8_results else
               resident_line if name in resident_names else
               all_int8_line if name in I8_NAMES else
               train_line if name in TRAIN_MUTANTS or name in FLASH_BWD_NAMES else
               wq_encode_line if name == "fused_ln_linear_dual_wq" else
               stage2_line if name in WQ_NAMES else sam_int8_line)
        r["launches"] = own["launches"][name]
        if name in UNCALLED_NAMES:
            r["launches_note"] = "no path of either package calls this kernel: 0 in every serve"
        r["launches_bf16_serve"] = serve_line["launches"][name]
        r["launches_packed_serve"] = packed_line["launches"][name]
        r["launches_int8_serve"] = int8_line["launches"][name]
        r["launches_sam_int8_serve"] = sam_int8_line["launches"][name]
        r["launches_sam_resident_serve"] = resident_line["launches"][name]
        r["launches_all_int8_serve"] = all_int8_line["launches"][name]
        r["launches_stage1_step"] = train_line["launches"][name]
        r["launches_stage2_step"] = stage2_line["launches"][name]
        r["launches_weight_only_encode"] = wq_encode_line["launches"][name]
        r["launches_mlp_microbench"] = mlp_microbench["launches"][name]
        r["launches_inference"] = inference_line["launches"][name]
        r["launches_train_clis"] = train_clis_line["launches"][name]
        r["launches_sam_predictor"] = sam_pred_line["launches"][name]
        r["launches_video_serve"] = video_line["launches"][name]
        r["launches_video_stage1_step"] = video_stage1_line["launches"][name]
        r["launches_chat"] = chat_line["launches"][name]
    for r in results.values():
        print(json.dumps({"phase": "kernel", **{k: v for k, v in r.items()
                                                if k not in ("route", "source", "replaces")}}),
              flush=True)
    check_phase(gen)
    mark("check")
    # The serve and profile numbers again, short, next to the result.
    for line, prof in ((serve_line, profile_line), (packed_line, packed_profile),
                       (int8_line, int8_profile),
                       (sam_int8_line, sam_int8_profile), (resident_line, resident_profile),
                       (all_int8_line, all_int8_profile)):
        line = {k: v for k, v in line.items() if k != "launches"}
        top = sorted(prof["top_device_ms"].items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({**line, "phase": line["phase"] + "_summary",
                          "init_s": init_s, "quantize_s": quantize_s,
                          "quantize_towers_s": quantize_towers_s,
                          "bias_weights_s": bias_weights_s,
                          "device_busy_s": prof["device_busy_s"],
                          "profiled_wall_s": prof["wall_s"],
                          "watched_device_ms_calls": prof["watched_device_ms_calls"],
                          "top_device_ms_calls": [[name[:60], ms, prof["top_device_calls"][name]]
                                                  for name, ms in top]}), flush=True)
    print(json.dumps({**parallel_line, "phase": "parallel_summary"}), flush=True)
    for line in (train_line, stage2_line, wq_encode_line, inference_line, train_clis_line,
                 sam_pred_line, video_line, video_stage1_line, chat_line, xla_line, trace_line):
        print(json.dumps({**{k: v for k, v in line.items()
                             if k not in ("launches", "top_device_calls", "sampling", "boxes",
                                          "kernel_gates", "checkpoint_paths", "losses", "paths",
                                          "routes")},
                          "phase": line["phase"] + "_summary"}), flush=True)
    # The phases of the video path, the chat and the tools, inside the
    # timeline's serves, training and chat entries.
    new_phases = {line["phase"]: line["seconds"] for line in (
        video_line, trace_line, video_stage1_line, chat_line, xla_line)}
    print(json.dumps({"phase": "timeline", "seconds": timeline,
                      "new_phases_s": new_phases,
                      "new_phases_share": sum(new_phases.values()) / sum(timeline.values())}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check-draws"]:  # --check-draws SEED ...
        import torch

        if not torch.cuda.is_available():
            sys.exit(2)
        sys.exit(check_draws([int(a) for a in sys.argv[2:]]))
    sys.exit(main())
