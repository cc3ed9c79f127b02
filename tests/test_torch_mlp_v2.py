"""Parity of the port's `fused_mlp_block_v2` (the chunk-pipelined W8A8 SAM
MLP) with the JAX package on the CPU, and its microbenchmark driven at a
tiny shape. The same numpy inputs go through the JAX Pallas kernel in
interpret mode and the port's plain version.

Tolerance: `_close_w8a8` of `test_torch_sam_int8.py`, the W8A8 outputs'
gate there: the largest error within 2e-3 of the largest output value
(one int8 step flipped by fp32 reassociation moves an output by about 1/127
of one term of its sum) and the median within 1e-5 of it.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sam_int8 import _close_w8a8, _linear_inputs
from ullava_tpu.ops import mlp_kernel as jmlp
from ullava_tpu_torch.microbench import mlp_variants
from ullava_tpu_torch.ops import mlp_kernel, quant

T, C, F = 32, 64, 512
EPS = 1e-6


def setup_module():
    torch.set_num_threads(1)


def _inputs(dtype):
    """(JAX arguments, port arguments) of one MLP block; x, the LN
    parameters and the biases in `dtype` ("float32" or "bfloat16")."""
    rng = np.random.default_rng(9)
    d1, d2 = _linear_inputs(rng, (T,), C, F), _linear_inputs(rng, (T,), F, C)
    vals = (d1["x"], d1["g"], d1["b"], d1["wq"], d1["ws"], d1["bias"], d2["wq"], d2["ws"],
            d2["bias"])
    cast = {0, 1, 2, 5, 8}  # x, LN scale and bias, b1, b2
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) if i in cast else jnp.asarray(a)
             for i, a in enumerate(vals)]
    targs = []
    for i, a in enumerate(vals):
        t = torch.from_numpy(np.array(a))
        if i in cast:
            t = t.to(getattr(torch, dtype))
        elif i in (3, 6):
            t = quant.column_major(t)
        targs.append(t)
    return jargs, targs


@pytest.mark.parametrize("f_chunk", [128, 256, 512], ids=["chunks4", "chunks2", "chunks1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_block_v2_matches_jax(dtype, f_chunk):
    jargs, targs = _inputs(dtype)
    ref = jmlp.fused_mlp_block_v2(*jargs, EPS, block_t=16, f_chunk=f_chunk, interpret=True)
    got = mlp_kernel.fused_mlp_block_v2(*targs, EPS, f_chunk=f_chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, C)
    _close_w8a8(got.float(), np.asarray(ref, np.float32))


def test_fused_mlp_block_v2_is_fused_mlp_block():
    """One function: the port's v2 is bit for bit its `fused_mlp_block`
    (w8a8) at each f_chunk, as the JAX package's two kernels are."""
    jargs, targs = _inputs("float32")
    for f_chunk in (128, 256, 512):
        got = mlp_kernel.fused_mlp_block_v2(*targs, EPS, f_chunk=f_chunk)
        assert torch.equal(got, mlp_kernel.fused_mlp_block(*targs, EPS, f_chunk=f_chunk, w8a8=True))
        jv2 = jmlp.fused_mlp_block_v2(*jargs, EPS, block_t=16, f_chunk=f_chunk, interpret=True)
        jk12 = jmlp.fused_mlp_block(*jargs, EPS, block_t=16, f_chunk=f_chunk, w8a8=True,
                                    interpret=True)
        np.testing.assert_array_equal(np.asarray(jv2), np.asarray(jk12))
    # The default chunk is fused_mlp_block's: 512 when 1024 does not divide F.
    assert torch.equal(mlp_kernel.fused_mlp_block_v2(*targs, EPS),
                       mlp_kernel.fused_mlp_block_v2(*targs, EPS, f_chunk=512))


def test_fused_mlp_block_v2_refuses_bad_shapes():
    _, targs = _inputs("float32")
    with pytest.raises(ValueError, match="T, C"):
        mlp_kernel.fused_mlp_block_v2(targs[0].reshape(2, T // 2, C), *targs[1:], EPS)
    with pytest.raises(ValueError, match="not a multiple of f_chunk 384"):
        mlp_kernel.fused_mlp_block_v2(*targs, EPS, f_chunk=384)


def test_mlp_variants_microbench_on_cpu(capsys):
    lines = mlp_variants.main(device="cpu", T=64, C=64, F=512, iters=1)
    printed = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    assert [ln["variant"] for ln in lines] == [v[0] for v in mlp_variants.VARIANTS]
    by = {ln["variant"]: ln for ln in lines}
    for name in ("v2", "v2_f512"):
        assert by[name]["max_abs_diff_from_base"] == 0.0
        assert by[name]["ms"] is None and by[name]["launches"] == {}  # nothing timed on the CPU
    for name in ("k12_f2560", "k12_f5120", "v2_f2560", "v2_f5120"):
        assert "not a multiple of f_chunk" in by[name]["skipped"]  # F = 512
    assert all(ln["shape"] == [64, 64, 512] and ln["device"] == "cpu" for ln in lines)
