"""On the card: the weight-only (`w8a8=False`) CUDA forms of
`fused_ln_linear` / `fused_linear` (K10), `fused_ln_linear_dual` (K13) and
`fused_mlp_block` (K12), on their shared bf16 x int8-weight GEMM core,
against the plain PyTorch versions in bf16. Every test here needs an
NVIDIA GPU and skips without one. The file imports torch only, so it runs
on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_weight_only.py -q

Gate: bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there is at most 2^-7; the kernel and the plain version sum their fp32
products in other orders, and the LN'd rows may round to a neighbouring
bf16 value).
"""

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.ops import mlp_kernel, quant

_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)


def _weight(gen, K, N):
    leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device="cuda") * 0.05)
    return leaf["q"], leaf["scale"]


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,K,N", [(200, 96, 72), (129, 1280, 136), (1, 16, 8), (4096, 1280, 3840)])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "no_ln_residual"])
def test_fused_ln_linear_weight_only_matches_plain(cuda, rows, K, N, ln):
    x = _rand(cuda, rows, K, scale=2.0, shift=0.3)
    wq, ws = _weight(cuda, K, N)
    bias = _rand(cuda, N, scale=0.5)
    g, b = (_rand(cuda, K, scale=0.1, shift=1.0), _rand(cuda, K, scale=0.1)) if ln else (None, None)
    res = None if ln else _rand(cuda, rows, N)
    got = mlp_kernel.fused_ln_linear(x, g, b, wq, ws, bias, 1e-6, w8a8=False, residual=res)
    ref = mlp_kernel.fused_ln_linear_plain(x, g, b, wq, ws, bias, 1e-6, w8a8=False, residual=res)
    torch.cuda.synchronize()
    assert _row_rel_err(got, ref) <= _TOL
    if not ln:  # fused_linear is the same entry without the LayerNorm
        lin = mlp_kernel.fused_linear(x, wq, ws, bias, residual=res, w8a8=False)
        assert torch.equal(lin, got)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,rows2", [(16, 200, 196), (8, 112, 112), (3, 64, 64)])
def test_fused_ln_linear_dual_weight_only_matches_plain(cuda, N, T, rows2):
    C, F1, F2 = 1280, 3840, 864
    x = _rand(cuda, N, T, C, scale=2.0, shift=0.3)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)
    (wq, ws), (w2, s2) = _weight(cuda, C, F1), _weight(cuda, C, F2)
    bias, bias2 = _rand(cuda, F1, scale=0.5), _rand(cuda, F2, scale=0.5, dtype=torch.float32)
    args = (g, b, wq, ws, bias, w2, s2, bias2, 1e-6)
    y, p = mlp_kernel.fused_ln_linear_dual(x, *args, w8a8=False, rows2=rows2)
    ry, rp = mlp_kernel.fused_ln_linear_dual_plain(x, *args, w8a8=False, rows2=rows2)
    torch.cuda.synchronize()
    assert p.shape == (N, rows2, F2)
    assert _row_rel_err(y, ry) <= _TOL and _row_rel_err(p, rp) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 300])
def test_fused_mlp_block_weight_only_matches_plain(cuda, T):
    C, F = 1280, 5120
    x = _rand(cuda, T, C, scale=2.0, shift=0.3)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)
    (w1, s1), (w2, s2) = _weight(cuda, C, F), _weight(cuda, F, C)
    b1, b2 = _rand(cuda, F, scale=0.5), _rand(cuda, C, scale=0.5)
    args = (x, g, b, w1, s1, b1, w2, s2, b2, 1e-6)
    got = mlp_kernel.fused_mlp_block(*args, w8a8=False)
    ref = mlp_kernel.fused_mlp_block_plain(*args, w8a8=False)
    torch.cuda.synchronize()
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
def test_weight_widened_as_unsigned_fails_the_gate(cuda):
    """A copy of the GEMM core built with the int8 weight widened as
    unsigned bytes (`-DULLAVA_MUTANT_WQ_UNSIGNED`) must fail the gate."""
    x = _rand(cuda, 256, 1280)
    wq, ws = _weight(cuda, 1280, 1280)
    bias = _rand(cuda, 1280)
    ref = mlp_kernel.fused_ln_linear_plain(x, None, None, wq, ws, bias, 0.0, w8a8=False)
    kernels.build_all(mutants=[("ln_linear_wq.cu", "ULLAVA_MUTANT_WQ_UNSIGNED")])
    with kernels.mutant("ln_linear_wq.cu", "ULLAVA_MUTANT_WQ_UNSIGNED"):
        bad = mlp_kernel.fused_linear(x, wq, ws, bias, w8a8=False)
    torch.cuda.synchronize()
    assert _row_rel_err(bad, ref) > _TOL


@pytest.mark.cuda
def test_weight_only_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _rand(cuda, 64, 1280)
    wq, ws = _weight(cuda, 1280, 256)
    bias = _rand(cuda, 256)
    with pytest.raises(ValueError, match="column-major"):
        mlp_kernel.fused_linear(x, wq.contiguous(), ws, bias, w8a8=False)
    wq2, ws2 = _weight(cuda, 1280, 260)
    with pytest.raises(ValueError, match="N 260"):
        mlp_kernel.fused_linear(x, wq2, ws2, _rand(cuda, 260), w8a8=False)
