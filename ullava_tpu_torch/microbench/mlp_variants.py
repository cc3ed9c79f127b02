"""The W8A8 SAM MLP's variants at the ViT-H serving shape: the port's
counterpart of `tools/microbench/mlp_variants.py`, and the one caller of
`fused_mlp_block_v2` in either package.

    python -m ullava_tpu_torch.microbench.mlp_variants   # on the card
    python -c "from ullava_tpu_torch.microbench import mlp_variants as m; \
m.main(device='cpu', T=64, C=64, F=512, iters=1)"

Variants: `fused_mlp_block(w8a8=True)` (K12) at its default f_chunk (the
base) and at 512, `fused_mlp_block_v2` (K23) at its default and at 512, and
each at 2560 and 5120, which the JAX tool also times. A wrapper that
refuses a variant's f_chunk (the CUDA kernels take at most 1024) gives a
`skipped` line with its ValueError's text, where the JAX tool skips what it
cannot tile. The JAX tool's block_t variants collapse: the port has no
block_t.

Inputs are the JAX tool's: x standard normal, LN scale 1 and bias 0, int8
weights uniform in [-127, 127), scales 0.01, biases 0, from a generator
seeded 0 on the device. Each variant prints one JSON line: ms a call (CUDA
events around `iters` back-to-back calls after two, as the JAX tool times
a loop), TOP/s over the two products (2 x 2 x T x C x F), the share of the
H100's dense int8 peak, the largest difference from the base output, and
the kernels the variant launched. On the CPU (`device="cpu"`) the wrappers
run their plain versions and nothing is timed.
"""

from __future__ import annotations

import json

import torch

from ullava_tpu_torch import kernels, resolve_device
from ullava_tpu_torch.ops import mlp_kernel

INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
EPS = 1e-6


def _k12(args, f_chunk):
    return mlp_kernel.fused_mlp_block(*args, EPS, f_chunk=f_chunk, w8a8=True)


def _v2(args, f_chunk):
    return mlp_kernel.fused_mlp_block_v2(*args, EPS, f_chunk=f_chunk)


# (name, call, f_chunk); the first is the base every other is compared with.
VARIANTS = (
    ("base", _k12, 0), ("k12_f512", _k12, 512), ("k12_f2560", _k12, 2560),
    ("k12_f5120", _k12, 5120),
    ("v2", _v2, 0), ("v2_f512", _v2, 512), ("v2_f2560", _v2, 2560), ("v2_f5120", _v2, 5120),
)


def inputs(T: int, C: int, F: int, device) -> tuple:
    """(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2), the
    int8 weights column-major as every int8 leaf of the port."""
    gen = torch.Generator(device=device).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.randn((T, C), generator=gen, device=device).to(bf)
    w1 = torch.randint(-127, 127, (F, C), generator=gen, device=device, dtype=torch.int8).t()
    w2 = torch.randint(-127, 127, (C, F), generator=gen, device=device, dtype=torch.int8).t()
    return (x, torch.ones(C, dtype=bf, device=device), torch.zeros(C, dtype=bf, device=device),
            w1, torch.full((1, F), 0.01, dtype=f32, device=device),
            torch.zeros(F, dtype=bf, device=device),
            w2, torch.full((1, C), 0.01, dtype=f32, device=device),
            torch.zeros(C, dtype=bf, device=device))


def _loop_ms(fn, iters: int) -> float:
    """Device ms a call of `fn` over `iters` calls in a row, after one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(device=None, T: int = 150528, C: int = 1280, F: int = 5120, iters: int = 20) -> list:
    """Run every variant once more than `iters` + 1 times, print one JSON
    line each and return the lines."""
    dev = resolve_device(device)
    args = inputs(T, C, F, dev)
    ops = 2.0 * 2 * T * C * F
    on_card = dev.type == "cuda"
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"
    lines, base = [], None
    for name, call, f_chunk in VARIANTS:
        line = {"phase": "mlp_variant", "variant": name,
                "f_chunk": f_chunk or mlp_kernel.default_f_chunk(F)}
        before = kernels.launch_counts()
        try:
            out = call(args, f_chunk)
        except ValueError as e:
            line["skipped"] = str(e)
        else:
            run = lambda c=call, fc=f_chunk: c(args, fc)  # noqa: E731
            if on_card:
                ms = _loop_ms(run, iters)
                per_s = ops / (ms * 1e-3)
                line.update(ms=ms, tops=per_s / 1e12, int8_peak_share=per_s / INT8_OPS_PER_S)
            else:
                for _ in range(iters + 1):
                    run()
                line.update(ms=None, tops=None, int8_peak_share=None)
            base = out if base is None else base
            line["max_abs_diff_from_base"] = (out.float() - base.float()).abs().max().item()
            line["launches"] = {k: n - before[k] for k, n in kernels.launch_counts().items()
                                if n != before[k]}
            del out
        line.update(shape=[T, C, F], device=where)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
