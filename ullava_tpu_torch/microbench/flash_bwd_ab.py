"""The flash backward at the training steps' attention shapes, for one
checkout of the port: `attention.flash_attention_bwd` (delta's einsum and
the kernels, as the step's autograd Function calls it) at the stage-1
step's [4, 1024, 32, 128] and the stage-2 step's [4, 512, 32, 128], causal
with full kv_lens (what `train.make_batch` and `train.make_stage2_batch`
give), and at the kernel line's ragged kv_lens 1024/1000/777/513 of
`chip_smoke.py`; beside it SDPA's backward under autograd on the same
inputs, and each kernel's device time in one call by the profiler.

    python ullava_tpu_torch/microbench/flash_bwd_ab.py [--root DIR]

`--root` imports `ullava_tpu_torch` from DIR instead of this checkout (the
parent commit unpacked beside it, say), so that two versions are compared
on one card in one call: run parent, this, this, parent. One JSON line a
shape, then the card's name and power limit. Times are CUDA events around
each call after a 256 MB write that evicts the L2, the mean of 20. It needs
a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {
    "stage1": (4, 1024, None),
    "stage1_ragged": (4, 1024, (1024, 1000, 777, 513)),
    "stage2": (4, 512, None),
}
H, HD = 32, 128


def _ms(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def _device_ms_by_kernel(torch, fn, calls: int = 5) -> dict:
    """{kernel name: device ms a call} of every device entry in `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if "CUDA" in str(getattr(e, "device_type", "")) and us > 0:
            out[e.key[:70]] = out.get(e.key[:70], 0.0) + us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (B, S, lens) in SHAPES.items():
        q, k, v, do = ((torch.randn((B, S, H, HD), generator=gen, device="cuda")).to(
            torch.bfloat16) for _ in range(4))
        kv = torch.tensor(lens or (S,) * B, device="cuda", dtype=torch.int32)
        kw = dict(causal=True, scale=HD**-0.5)
        o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
        run = lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)  # noqa: E731
        qr, kr, vr = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, scale=HD**-0.5)
        sdpa = lambda: torch.autograd.grad(ref, (qr, kr, vr), dot, retain_graph=True)  # noqa: E731
        line = {"shape": name, "B": B, "S": S, "kv_lens": kv.tolist(), "root": args.root,
                "ms": _ms(torch, run), "sdpa_backward_ms": _ms(torch, sdpa),
                "device_ms_by_kernel": _device_ms_by_kernel(torch, run)}
        print(json.dumps(line), flush=True)
        del q, k, v, do, o, lse, qr, kr, vr, dot, ref
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
