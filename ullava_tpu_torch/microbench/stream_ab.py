"""K1 (`rope.fused_rotary`) and K7 (`decode_attention.prefill_quantize_write`)
at the serves' shapes, and K18 (`norms.rms_norm_bwd`) at the stage-1 step's,
for one checkout of the port: K1 on [1280, 4096] (the bf16 serve's prefill)
and [5120, 4096] (the int8 serves'), K7 on k, v [16, 320, 32, 128] into
layer 17 of a [32, 16, 352, 4096] int8 cache, K18 on [4096, 4096] without
and with dw. Each is timed by `chip_smoke.time_ms` (CUDA events around
each call after a 256 MB write that evicts the L2, the mean of 20) and by
`chip_smoke.device_ms_a_call` (the profiler's device time a launch over 50
back-to-back calls, L2-warm), beside its bound; K18's dw form gives its
main kernel's and its dw reduce's device times apart.

    python ullava_tpu_torch/microbench/stream_ab.py [--root DIR]

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
        print("stream_ab: needs a card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.ops import decode_attention, norms, rope

    kernels.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    line = {"phase": "stream_ab", "root": args.root}
    hd, width = 128, 4096
    for rows in (cs.B * cs.PROMPT, cs.B_INT8 * cs.PROMPT):
        x = torch.randn((rows, width), generator=gen, device="cuda").to(torch.bfloat16)
        cos, sin = rope.rope_cos_sin(
            torch.arange(cs.PROMPT, device="cuda").repeat(rows // cs.PROMPT), hd)
        run = lambda: rope.fused_rotary(x, cos, sin, hd)  # noqa: E731
        line[f"fused_rotary_{rows}"] = {
            "row_rel_err": cs.row_rel_err(run(), rope.fused_rotary_plain(x, cos, sin, hd)),
            "ms": cs.time_ms(run, 20), "device_ms": cs.device_ms_a_call(run, "rope_kernel"),
            "bound_ms": cs.bound_ms(2 * cs.nbytes(x) + cs.nbytes(cos, sin), 6.0 * x.numel(),
                                    cs.FP32_FLOPS_PER_S)[0]}
        del x, cos, sin
    L, H, maxS, layer = 32, 32, cs.PROMPT + cs.NEW_TOKENS, 17
    cache = [torch.zeros((L, cs.B_INT8, maxS, H * hd), dtype=torch.int8, device="cuda")
             for _ in range(2)]
    cache += [torch.zeros((L, cs.B_INT8, maxS, H), device="cuda") for _ in range(2)]
    k, v = (torch.randn((cs.B_INT8, cs.PROMPT, H, hd), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    run = lambda: decode_attention.prefill_quantize_write(k, v, *cache, layer)  # noqa: E731
    run()
    expect = decode_attention.prefill_quantize_write_plain(
        k, v, *(c.clone() for c in cache), layer)
    line["prefill_quantize_write"] = {
        "int8_exact_share": min(
            (cache[i][layer, :, :cs.PROMPT] == expect[i][layer, :, :cs.PROMPT]).float().mean().item()
            for i in (0, 1)),
        "ms": cs.time_ms(run, 20), "device_ms": cs.device_ms_a_call(run, "kv_quant_write_kernel"),
        "bound_ms": cs.bound_ms(cs.nbytes(k, v) + k.numel() * 2 + 2 * 4 * cs.B_INT8 * cs.PROMPT * H,
                                6.0 * k.numel(), cs.FP32_FLOPS_PER_S)[0]}
    del cache, k, v, expect
    torch.cuda.empty_cache()
    rows, D = 4096, 4096
    x = (2.0 * torch.randn((rows, D), generator=gen, device="cuda")).to(torch.bfloat16)
    dy = (0.5 * x.float() + torch.randn((rows, D), generator=gen, device="cuda")).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    dx_ref, dw_ref = norms.rms_norm_bwd_plain(x, w, dy, 1e-6)
    for dw in (False, True):
        run = lambda dw=dw: norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=dw)  # noqa: E731
        got = run()
        # One timing left out: the first after another kernel's reads ran
        # 10% slow.
        cs.time_ms(run, 20)
        line[f"rms_norm_bwd{'_dw' if dw else ''}"] = {
            "row_rel_err": cs.row_rel_err(got[0], dx_ref),
            "dw_row_rel_err": cs.row_rel_err(got[1][None], dw_ref[None]) if dw else None,
            "ms": cs.time_ms(run, 20),
            "device_ms": cs.device_ms_a_call(run, "rms_bwd_kernel"),
            "dw_reduce_device_ms": cs.device_ms_a_call(run, "rms_dw_reduce_kernel") if dw else None,
            "bound_ms": cs.bound_ms(cs.nbytes(x, w, dy, x) + (2 * D if dw else 0),
                                    (13.0 if dw else 10.0) * x.numel(),
                                    cs.FP32_FLOPS_PER_S)[0]}
    print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
