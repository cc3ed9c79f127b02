"""K23 (`mlp_kernel.fused_mlp_block_v2`, the chunk-pipelined W8A8 MLP)
beside K12 (`fused_mlp_block(w8a8=True)`, the same function in three
launches) for one checkout of the port: at the MLP microbenchmark's shape
and inputs ([150528, 1280] x 5120, `mlp_variants.inputs`) and at K12's
phase shape in `chip_smoke.py` (one B=16 ViT-H encode's 65536 rows, its
inputs), each at f_chunk 1024 and 512. Each kernel is timed by
`chip_smoke.time_ms` (CUDA events around each call after a 256 MB write
that evicts the L2, the mean of 10); K23's output is held against its
plain version (`chip_smoke.row_rel_err`) and against K12's bits, beside
its bound at the int8 peak.

    python ullava_tpu_torch/microbench/mlp_v2_ab.py [--root DIR]

`--root` imports `ullava_tpu_torch` from DIR instead of this checkout (the
parent commit unpacked beside it, say); `chip_smoke.py` always comes from
this checkout, so both versions are read by the same timers. Run parent,
this, this, parent in one call to compare two versions on one card. One
JSON line, then the card's name and power limit. It needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("mlp_v2_ab: needs a card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench import mlp_variants
    from ullava_tpu_torch.ops import mlp_kernel

    kernels.build_all()
    C, Fw, eps = 1280, 5120, 1e-6
    gen = torch.Generator(device="cuda").manual_seed(9)

    line = {"phase": "mlp_v2_ab", "root": args.root}
    shapes = (("microbench", cs.MICROBENCH_T,
               lambda T: (*mlp_variants.inputs(T, C, Fw, "cuda"), eps)),
              ("k12_shape", cs.B_INT8 * 4096, lambda T: cs.k12_phase_inputs(gen, T, C, Fw, eps)))
    for label, T, make in shapes:
        margs = make(T)
        for f_chunk in (1024, 512):
            v2 = lambda: mlp_kernel._mlp_block_v2_cuda(*margs, f_chunk)[0]  # noqa: E731
            k12 = lambda: mlp_kernel._mlp_block_cuda(*margs, f_chunk)[0]  # noqa: E731
            got, ref12 = v2(), k12()
            plain = mlp_kernel.fused_mlp_block_v2_plain(*margs, f_chunk)
            line[f"{label}_f{f_chunk}"] = {
                "shape": [T, C, Fw],
                "v2_ms": cs.time_ms(v2, 10), "k12_ms": cs.time_ms(k12, 10),
                "v2_row_rel_err": cs.row_rel_err(got, plain),
                "bit_equal_share_vs_k12": cs.bit_equal_share(got, ref12),
                "bound_ms": cs.bound_ms(cs.nbytes(*margs[:-1], got), 4.0 * T * C * Fw,
                                        cs.INT8_OPS_PER_S)[0]}
            del got, ref12, plain
        del margs
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
