"""The weight-only kernels of a stage-2 step (K10's LN+qkv and proj+residual
forms and K12, `w8a8=False`), for one checkout of the port: each timed at
the rows of a B=4 ViT-H encode's classes (12544 full-window rows, the
3584-row merged edge pair, the 256 corner rows, the 16384 global-block
rows; C 1280, qkv 3840, MLP 5120) by `chip_smoke.time_ms` (CUDA events
around each call after a 256 MB write that evicts the L2, the mean of 10),
beside its bound and the kernels of a call by the profiler; K13's
weight-only form (the dual LN1+qkv of the encode with composite bias
weights) the same way at its three classes (64 x 200 rows, 196 with bias
terms; 32 x 112; 4 x 64; 864 bias-term columns); then one full-width
stage-2 training step through
`chip_smoke.stage2_train_phase` (one warm step with exact launch counts,
three timed, one profiled, then the weight-only encode with composite
weights, whose `encode_s` is K13's path).

    python ullava_tpu_torch/microbench/stage2_ab.py [--root DIR]

`--root` imports `ullava_tpu_torch` from DIR instead of this checkout (the
parent commit unpacked beside it, say); `chip_smoke.py` always comes from
this checkout, so both versions are read by the same timers and the same
profile watch. Run parent, this, this, parent in one call to compare two
versions on one card. After the stage-2 phase's own lines it prints one
`stage2_ab` line (the class-row times, the profiled step's busy seconds,
the device ms and calls of the weight-only kernels: the wgmma + TMA
core's GEMMs and the bf16 LayerNorm row pass, and their sum; the
weight-only encode's `encode_s` with and without composite weights, and
the profiled encode's busy seconds and K13's GEMM and row pass device ms),
then the card's name and power limit. Weights are random,
from a generator seeded 0 on the device. It needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# K13's classes by rows: (windows, rows a window, rows with bias terms).
K13_CLASSES = {12800: (64, 200, 196), 3584: (32, 112, 112), 256: (4, 64, 64)}
F2 = 2 * 16 * 27  # the composite bias-term columns: 2 H (2 W - 1)
# The profile watch's labels of the weight-only kernels (chip_smoke.PROFILE_WATCH).
WEIGHT_ONLY_WATCH = ("wq_gemm_sm90", "wq_ln_rows")
# K13's GEMM in the profiled encode with composite weights: on the wgmma +
# TMA core (its `DualForm`), or on the retired mma.sync core.
K13_WATCH = ("fused_ln_linear_dual_wq_gemm", "wq_gemm_mma_sync", "wq_ln_rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("stage2_ab: needs a card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.PROFILE_WATCH["wq_gemm_mma_sync"] = "wq::gemm_kernel"  # K13's GEMM on the mma.sync core

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import mlp_kernel, quant

    kernels.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, C, F, eps = torch.bfloat16, 1280, 5120, 1e-6

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(bf)

    def weight(K, N):
        leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device="cuda") * 0.05)
        return leaf["q"], leaf["scale"]

    rows = max(cs.STAGE2_CLASS_ROWS)
    x = randn(rows, C, scale=2.0, shift=0.3)
    g, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
    line = {"phase": "stage2_ab", "root": args.root}
    forms = {}
    for form, N, ln in (("ln_qkv", 3 * C, True), ("proj_residual", C, False)):
        wq, ws = weight(C, N)
        bias = randn(N, scale=0.5)
        res = None if ln else randn(rows, N)
        lg, lb = (g, b) if ln else (None, None)
        forms[f"fused_ln_linear_wq_{form}"] = (
            lambda n, lg=lg, lb=lb, wq=wq, ws=ws, bias=bias, res=res:
            mlp_kernel._ln_linear_wq_cuda(x[:n], lg, lb, wq, ws, bias, eps,
                                          None if res is None else res[:n])[0],
            lambda n, lg=lg, lb=lb, wq=wq, ws=ws, bias=bias, res=res:
            mlp_kernel._ln_linear_parts_plain(x[:n], lg, lb, wq, ws, bias, eps, False,
                                              None if res is None else res[:n])[0],
            lambda n, N=N, ln=ln: cs.nbytes(x[:n]) + n * N * (2 if ln else 4) + C * N,
            lambda n, N=N: 2.0 * n * C * N)
    (w1, s1), (w2, s2) = weight(C, F), weight(F, C)
    b1, b2 = randn(F, scale=0.5), randn(C, scale=0.5)
    mlp = (g, b, w1, s1, b1, w2, s2, b2, eps)
    forms["fused_mlp_block_wq"] = (
        lambda n: mlp_kernel._mlp_block_wq_cuda(x[:n], *mlp)[0],
        lambda n: mlp_kernel._mlp_block_parts_plain(x[:n], *mlp, 1024, False)[0],
        lambda n: 2 * cs.nbytes(x[:n]) + 2 * C * F,
        lambda n: 4.0 * n * C * F)
    # K13 from its own generator: the stage-2 step draws its weights from
    # `gen` as it did before K13 was timed here.
    kgen = torch.Generator(device="cuda").manual_seed(13)
    (wd, sd), (w2d, s2d) = (quant.quantize_int8(torch.randn((C, n), generator=kgen, device="cuda")
                                                * 0.05).values() for n in (3 * C, F2))
    dual = (g, b, wd, sd, (torch.randn(3 * C, generator=kgen, device="cuda") * 0.5).to(bf),
            w2d, s2d, torch.randn(F2, generator=kgen, device="cuda") * 0.5, eps)

    def k13(n):  # (x as [windows, T, C], rows2) of the class of n rows
        N, T, rows2 = K13_CLASSES[n]
        return x[:n].reshape(N, T, C), rows2

    forms["fused_ln_linear_dual_wq"] = (
        lambda n: mlp_kernel._ln_linear_dual_wq_cuda(k13(n)[0], *dual, k13(n)[1])[1],
        lambda n: mlp_kernel._ln_linear_dual_parts_plain(k13(n)[0], *dual, False, k13(n)[1])[1],
        lambda n: (cs.nbytes(x[:n]) + 2 * n * 3 * C + 2 * K13_CLASSES[n][0] * k13(n)[1] * F2
                   + C * (3 * C + F2)),
        lambda n: 2.0 * C * (n * 3 * C + K13_CLASSES[n][0] * k13(n)[1] * F2))
    for name, (kern, plain, in_out, flops) in forms.items():
        line[name] = {}
        for n in (K13_CLASSES if name == "fused_ln_linear_dual_wq" else cs.STAGE2_CLASS_ROWS):
            b_ms, b_by = cs.bound_ms(in_out(n), flops(n))
            line[name][str(n)] = {"row_rel_err": cs.row_rel_err(kern(n), plain(n)),
                                  "ms": cs.time_ms(lambda n=n: kern(n), 10),
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "kernels_a_call": cs.kernels_of_a_call(lambda n=n: kern(n))}
    del forms, x, w1, w2, wd, w2d
    torch.cuda.empty_cache()

    step, encode = cs.stage2_train_phase(gen)
    watched = step["watched_device_ms_calls"]
    line.update(
        step_s=step["step_s"], device_busy_s=step["device_busy_s"],
        profiled_step_wall_s=step["profiled_step_wall_s"],
        weight_only_device_ms_calls={k: watched[k] for k in WEIGHT_ONLY_WATCH},
        weight_only_device_ms=sum(watched[k][0] for k in WEIGHT_ONLY_WATCH),
        encode_s=encode["encode_s"], encode_runs_s=encode["encode_runs_s"],
        encode_without_composite_s=encode["encode_without_composite_s"],
        encode_device_busy_s=encode["device_busy_s"],
        encode_k13_device_ms_calls={k: encode["watched_device_ms_calls"][k] for k in K13_WATCH},
        top_device_ms=step["top_device_ms"])
    print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
