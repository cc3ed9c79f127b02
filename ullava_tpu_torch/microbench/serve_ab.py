"""The resident int8 RES serve (the main path: LLaMA-7B int8 with W8A8
prefill, the fused norm + quantize and the int8 KV cache; CLIP and the SAM
ViT-H encoder int8 with the composite bias weights and the resident window
layout) at full width and B=16, or with `--serve bf16` the bf16 serve at
B=4 (the SAM encoder in the block layout, its global blocks through K4),
for one checkout of the port, through `chip_smoke.py`'s `serve_phase`:
exact launch counts, three timed serves, each phase alone, four profiled
decode steps and one profiled serve.

    python ullava_tpu_torch/microbench/serve_ab.py [--root DIR] [--serve resident|bf16]

`--root` imports `ullava_tpu_torch` from DIR instead of this checkout (the
parent commit unpacked beside it, say); `chip_smoke.py` always comes from
this checkout, so both versions are read through the same profile watch
(`PROFILE_WATCH`, here with every form of the RMSNorm row kernel and K4's
kernel on the `mma.sync` core, `flash_fwd_kernel` over `DecomposedAttn<64>`,
added).
Run parent, this, this, parent in one call to compare two versions on one
card. After `serve_phase`'s own two lines it prints one `serve_ab` line
(the serve wall, the decode step's wall and device ms, the profiled serve's
busy seconds and its watched kernels' device ms and calls), then the
card's name and power limit. Weights are random, from a generator seeded
0 on the device. It needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--serve", choices=("resident", "bf16"), default="resident")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: needs a card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.PROFILE_WATCH["rms_row_kernel_every_form"] = "rms_row_kernel"
    cs.PROFILE_WATCH["fused_global_attention_mma_sync"] = "DecomposedAttn<64>"

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models import ullava

    kernels.build_all()
    cfg = cs.full_config()
    if args.serve == "bf16":  # chip_smoke's first serve: the block window layout
        cfg = dataclasses.replace(cfg, sam=dataclasses.replace(
            cfg.sam, vision=dataclasses.replace(cfg.sam.vision, window_layout="block")))
    params = ullava.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    if args.serve == "bf16":
        return report(args, *cs.serve_phase("serve", cfg, params, cs.B, cs.BF16_LAUNCHES))
    ullava.quantize_llm(params)
    ullava.quantize_towers(params)
    llm8 = dataclasses.replace(cfg.core.llm, a8_prefill=True, kv_quant=True,
                               fused_norm_quant=True)
    cfg = dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, llm=llm8),
        sam=dataclasses.replace(cfg.sam, vision=dataclasses.replace(cfg.sam.vision,
                                                                     mlp_w8a8=True)))
    ullava.precompute_window_bias_weights(params, cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report(args, *cs.serve_phase("sam_resident_serve", cfg, params, cs.B_INT8,
                                        cs.SAM_RESIDENT_LAUNCHES))


def report(args, line, prof) -> int:
    print(json.dumps({
        "phase": "serve_ab", "root": args.root, "serve": args.serve, "serve_s": line["serve_s"],
        "sam_encode_s": line["sam_encode_s"], "decode_step_wall_ms": line["decode_step_wall_ms"],
        "decode_step_device_ms": line["decode_step_device_ms"],
        "device_busy_s": prof["device_busy_s"], "profiled_wall_s": prof["wall_s"],
        "watched_device_ms_calls": prof["watched_device_ms_calls"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
