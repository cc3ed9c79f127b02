"""The weight-only kernels of a stage-2 step (K10's LN+qkv and proj+residual
forms and K12, `w8a8=False`), for one checkout of the port: each timed at
the rows of a B=4 ViT-H encode's classes (12544 full-window rows, the
3584-row merged edge pair, the 256 corner rows, the 16384 global-block
rows; C 1280, qkv 3840, MLP 5120) by `chip_smoke.time_ms` (CUDA events
around each call after a 256 MB write that evicts the L2, the mean of 10),
beside its bound; then one full-width stage-2 training step through
`chip_smoke.stage2_train_phase` (one warm step with exact launch counts,
three timed, one profiled, then the weight-only encode with composite
weights).

    python ullava_tpu_torch/microbench/stage2_ab.py [--root DIR]

`--root` imports `ullava_tpu_torch` from DIR instead of this checkout (the
parent commit unpacked beside it, say); `chip_smoke.py` always comes from
this checkout, so both versions are read by the same timers and the same
profile watch. Run parent, this, this, parent in one call to compare two
versions on one card. After the stage-2 phase's own lines it prints one
`stage2_ab` line (the class-row times, the profiled step's busy seconds,
the device ms and calls of the weight-only kernels: the wgmma + TMA
core's GEMMs, the mma.sync core's and the bf16 LayerNorm row pass, and
their sum), then the card's name and power limit. Weights are random,
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
# The profile watch's labels of the weight-only kernels (chip_smoke.PROFILE_WATCH).
WEIGHT_ONLY_WATCH = ("wq_gemm_sm90", "wq_gemm_mma_sync", "wq_ln_rows")


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
    for name, (kern, plain, in_out, flops) in forms.items():
        line[name] = {}
        for n in cs.STAGE2_CLASS_ROWS:
            b_ms, b_by = cs.bound_ms(in_out(n), flops(n))
            line[name][str(n)] = {"row_rel_err": cs.row_rel_err(kern(n), plain(n)),
                                  "ms": cs.time_ms(lambda n=n: kern(n), 10),
                                  "bound_ms": b_ms, "bound_by": b_by}
    del forms, x, w1, w2
    torch.cuda.empty_cache()

    step, _ = cs.stage2_train_phase(gen)
    watched = step["watched_device_ms_calls"]
    line.update(
        step_s=step["step_s"], device_busy_s=step["device_busy_s"],
        profiled_step_wall_s=step["profiled_step_wall_s"],
        weight_only_device_ms_calls={k: watched[k] for k in WEIGHT_ONLY_WATCH},
        weight_only_device_ms=sum(watched[k][0] for k in WEIGHT_ONLY_WATCH),
        top_device_ms=step["top_device_ms"])
    print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
