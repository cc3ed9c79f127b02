"""On the card: the weight-only (`w8a8=False`) CUDA forms of
`fused_ln_linear` / `fused_linear` (K10), `fused_mlp_block` (K12) and
`fused_ln_linear_dual` (K13, both weights in one launch), all on the wgmma
+ TMA bf16 x int8-weight core, against the plain PyTorch versions in bf16;
the widening bit for bit over all 256 codes; the cores' deliberate bugs.
Every test here needs an NVIDIA GPU and skips without one. The file
imports torch only, so it runs on a machine that has no JAX:

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


def _poisoned(*like):
    """Outputs of the shapes of `like`, filled with 1e4: a row that a
    kernel leaves unwritten fails a gate, whatever the allocator hands out."""
    return tuple(torch.full(t.shape, 1e4, dtype=t.dtype, device=t.device) for t in like)


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
@pytest.mark.parametrize("N,T,rows2,C,F1,F2", [
    (16, 200, 196, 1280, 3840, 864), (8, 112, 112, 1280, 3840, 864), (3, 64, 64, 1280, 3840, 864),
    (64, 200, 196, 1280, 3840, 864), (32, 112, 112, 1280, 3840, 864), (4, 64, 64, 1280, 3840, 864),
    # The CPU tests' class geometries: tiles that cross windows, N * T not
    # a multiple of 256, F2 not a multiple of 128.
    (5, 64, 64, 128, 384, 104), (3, 112, 112, 128, 384, 104), (3, 200, 196, 128, 384, 104)])
def test_fused_ln_linear_dual_weight_only_matches_plain(cuda, N, T, rows2, C, F1, F2):
    x = _rand(cuda, N, T, C, scale=2.0, shift=0.3)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)
    (wq, ws), (w2, s2) = _weight(cuda, C, F1), _weight(cuda, C, F2)
    bias, bias2 = _rand(cuda, F1, scale=0.5), _rand(cuda, F2, scale=0.5, dtype=torch.float32)
    args = (g, b, wq, ws, bias, w2, s2, bias2, 1e-6)
    y, p = mlp_kernel.fused_ln_linear_dual(x, *args, w8a8=False, rows2=rows2)
    ry, rp = mlp_kernel.fused_ln_linear_dual_plain(x, *args, w8a8=False, rows2=rows2)
    # Into outputs filled with 1e4 first: every row must be written.
    out = _poisoned(ry, rp)
    mlp_kernel._ln_linear_dual_wq_cuda(x, *args, rows2, out=out)
    torch.cuda.synchronize()
    assert p.shape == (N, rows2, F2)
    assert _row_rel_err(y, ry) <= _TOL and _row_rel_err(p, rp) <= _TOL
    assert _row_rel_err(out[0], ry) <= _TOL and _row_rel_err(out[1], rp) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [12544, 3584, 256])
@pytest.mark.parametrize("N", [3840, 1280])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "no_ln_residual"])
def test_fused_ln_linear_weight_only_at_stage2_classes(cuda, rows, N, ln):
    """The row counts of a B=4 ViT-H encode's window classes (full, merged
    edge pair, corners), C 1280 into qkv and proj widths."""
    C = 1280
    x = _rand(cuda, rows, C, scale=2.0, shift=0.3)
    wq, ws = _weight(cuda, C, N)
    bias = _rand(cuda, N, scale=0.5)
    g, b = (_rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)) if ln else (None, None)
    res = None if ln else _rand(cuda, rows, N)
    got = mlp_kernel.fused_ln_linear(x, g, b, wq, ws, bias, 1e-6, w8a8=False, residual=res)
    ref = mlp_kernel.fused_ln_linear_plain(x, g, b, wq, ws, bias, 1e-6, w8a8=False, residual=res)
    torch.cuda.synchronize()
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 300, 3584, 16384])
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


def _exact_widening(gen, source, define=None):
    """`source`'s product on x = the identity [256, 256] against a weight
    that holds all 256 int8 codes in every column (code (k + 3 n) mod 256 -
    128 at [k, n]), power-of-two channel scales and small biases: the share
    of outputs equal to bf16(code * s + b) bit for bit (one live term, exact
    in fp32). K10 through `fused_linear`, K12 through its fc2 stage alone
    (h the identity, x zero)."""
    n = 256
    k = torch.arange(n, device="cuda")
    codes = ((k[:, None] + 3 * k[None, :]) % 256 - 128).to(torch.int8)
    wq = quant.column_major(codes)
    ws = torch.exp2(-torch.randint(4, 12, (n,), generator=gen, device="cuda").float())
    bias = _rand(gen, n, scale=0.25)
    eye = torch.eye(n, device="cuda", dtype=torch.bfloat16)
    ref = (codes.float() * ws + bias.float()).to(torch.bfloat16)

    def run():
        if source == "ln_linear_wq.cu":
            return mlp_kernel.fused_linear(eye, wq, ws, bias, w8a8=False)
        x0 = torch.zeros_like(eye)
        ones = torch.ones(n, device="cuda", dtype=torch.bfloat16)
        return mlp_kernel._mlp_block_wq_cuda(
            x0, ones, torch.zeros_like(ones), wq, ws, bias, wq, ws, bias, 1e-6, stages=4,
            scratch=(torch.empty_like(x0), eye))[0]

    if define is None:
        got = run()
    else:
        kernels.build_all(mutants=[(source, define)])
        with kernels.mutant(source, define):
            got = run()
    torch.cuda.synchronize()
    return (got.view(torch.int16) == ref.view(torch.int16)).float().mean().item()


_SOURCES = ["ln_linear_wq.cu", "mlp_block_wq.cu"]


@pytest.mark.cuda
@pytest.mark.parametrize("source", _SOURCES)
def test_widening_is_exact_on_all_256_codes(cuda, source):
    assert _exact_widening(cuda, source) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("source", _SOURCES)
@pytest.mark.parametrize("define", ["ULLAVA_MUTANT_WQ_UNSIGNED", "ULLAVA_MUTANT_WQ_BIAS_OFF_BY_ONE"])
def test_widening_mutants_fail_the_exact_check(cuda, source, define):
    assert _exact_widening(cuda, source, define) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("define", ["ULLAVA_MUTANT_WQ_BIAS_OFF_BY_ONE", "ULLAVA_MUTANT_WQ_SCALE_BY_TOKEN"])
def test_wgmma_core_mutants_fail_the_gates(cuda, define):
    """The wgmma + TMA core built with its widening's bias constant one code
    off, or its transposed epilogue's scale indexed by token, must fail the
    row gate: K10's proj + residual form and K12."""
    C, F, T = 1280, 5120, 512
    x = _rand(cuda, T, C, scale=2.0, shift=0.3)
    wq, ws = _weight(cuda, C, C)
    bias, res = _rand(cuda, C, scale=0.5), _rand(cuda, T, C)
    ref = mlp_kernel.fused_ln_linear_plain(x, None, None, wq, ws, bias, 0.0, w8a8=False, residual=res)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)
    (w1, s1), (w2, s2) = _weight(cuda, C, F), _weight(cuda, F, C)
    b1, b2 = _rand(cuda, F, scale=0.5), _rand(cuda, C, scale=0.5)
    margs = (x, g, b, w1, s1, b1, w2, s2, b2, 1e-6)
    mref = mlp_kernel.fused_mlp_block_plain(*margs, w8a8=False)
    kernels.build_all(mutants=[(src, define) for src in _SOURCES])
    with kernels.mutant("ln_linear_wq.cu", define):
        bad = mlp_kernel.fused_linear(x, wq, ws, bias, residual=res, w8a8=False)
    with kernels.mutant("mlp_block_wq.cu", define):
        mbad = mlp_kernel.fused_mlp_block(*margs, w8a8=False)
    torch.cuda.synchronize()
    assert _row_rel_err(bad, ref) > _TOL and _row_rel_err(mbad, mref) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("define", ["ULLAVA_MUTANT_WQ_DUAL_FIRST_WINDOW", "ULLAVA_MUTANT_WQ_SCALE_BY_TOKEN",
                                    "ULLAVA_MUTANT_WQ_BIAS_OFF_BY_ONE"])
@pytest.mark.parametrize("N,T,rows2", [(16, 200, 196), (8, 112, 112)])
def test_dual_mutants_fail_the_bias_term_gate(cuda, define, N, T, rows2):
    """K13's bias terms through copies of its source with W2's row-mapped
    tiles stored at the tile's first window only, the scale indexed by
    token, and the widening one code off (the LN bias given a mean of 0.5,
    so the LN'd rows have one that the shifted codes meet)."""
    C, F1, F2 = 1280, 3840, 864
    x = _rand(cuda, N, T, C, scale=2.0, shift=0.3)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1, shift=0.5)
    (wq, ws), (w2, s2) = _weight(cuda, C, F1), _weight(cuda, C, F2)
    bias, bias2 = _rand(cuda, F1, scale=0.5), _rand(cuda, F2, scale=0.5, dtype=torch.float32)
    args = (g, b, wq, ws, bias, w2, s2, bias2, 1e-6)
    rp = mlp_kernel.fused_ln_linear_dual_plain(x, *args, w8a8=False, rows2=rows2)[1]
    kernels.build_all(mutants=[("ln_linear_wq.cu", define)])
    out = _poisoned(torch.empty((N, T, F1), device="cuda", dtype=torch.bfloat16), rp)
    with kernels.mutant("ln_linear_wq.cu", define):
        bad = mlp_kernel._ln_linear_dual_wq_cuda(x, *args, rows2, out=out)[1]
    torch.cuda.synchronize()
    assert _row_rel_err(bad, rp) > _TOL


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
