"""Flash against the plain path on the card, the measurement behind
`attention(impl="auto")` taking flash at every length on CUDA tensors:
the causal attention of one LLaMA-7B layer
(B=4, 32 heads of 128, bf16, full kv_lens) at growing query lengths,
through `ops.attention.attention` with `impl="xla"` and `impl="flash"`,
for a serving forward (K2) and a training forward and backward (K15, K16,
K17 under autograd).

    python -m ullava_tpu_torch.microbench.attention_crossover

One JSON line a length: each route's ms (CUDA events around `iters`
calls after two, no L2 flush: a layer's attention finds its q, k, v just
written), and which is faster. The JAX package's crossover (`auto` takes
flash from Sq 512) was measured on a TPU v5e and is not used here. It
needs a card.
"""

from __future__ import annotations

import json
import sys

import torch

from ullava_tpu_torch.ops import attention

B, H, HD = 4, 32, 128
LENGTHS = (16, 32, 64, 128, 256, 512, 1024)


def _ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_crossover: needs a card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    for S in LENGTHS:
        q, k, v = (torch.randn((B, S, H, HD), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        w = torch.randn((B, S, H, HD), generator=gen, device="cuda").to(torch.bfloat16)
        line = {"Sq": S}
        for impl in ("xla", "flash"):
            with torch.no_grad():
                line[f"serve_{impl}_ms"] = _ms(lambda i=impl: attention.attention(
                    q, k, v, causal=True, kv_lens=lens, impl=i))
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

            def step(i=impl):
                out = attention.attention(qg, kg, vg, causal=True, kv_lens=lens, impl=i)
                torch.autograd.grad((out.float() * w.float()).sum(), (qg, kg, vg))

            line[f"train_{impl}_ms"] = _ms(step, 10)
        line["serve_flash_faster"] = line["serve_flash_ms"] < line["serve_xla_ms"]
        line["train_flash_faster"] = line["train_flash_ms"] < line["train_xla_ms"]
        print(json.dumps(line), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
