"""On the card: the three CUDA kernels of the int8 SAM encoder path and
their shared int8 GEMM core against the plain PyTorch versions, in bf16.
Every test here needs an NVIDIA GPU and skips without one. The file
imports torch only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_sam_int8.py -q

Gates: int8 intermediates (the LN'd rows, the re-quantized GELU output) at
least 99.9% exact and the rest within 1 (an fp32 value within
summation-order noise of .5 may round the other way); their scales rtol
1e-5; bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there, plus what a flipped int8 step moves); the bf16-exponential form of
the attention within 2e-2, because its rounding depends on the running
maximum and so on the key tiling.
"""

import pytest
import torch

from ullava_tpu_torch.ops import mlp_kernel, quant, sam_attention

_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(torch.bfloat16)


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _int8_ok(got, ref):
    diff = (got.int() - ref.int()).abs()
    return bool((diff <= 1).all()) and (diff == 0).float().mean().item() >= 0.999


def _weight(gen, K, N, std=0.05):
    leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device="cuda") * std)
    return leaf["q"], leaf["scale"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,K,N", [(200, 96, 72), (1, 16, 8), (129, 1280, 136)])
def test_cuda_int8_gemm_core_odd_shapes(cuda, rows, K, N):
    """The GEMM core through `fused_linear` at shapes that are no multiple
    of its 128 x 128 x 64 tile: ragged rows, columns and depth."""
    x = _rand(cuda, rows, K)
    wq, ws = _weight(cuda, K, N)
    bias = _rand(cuda, N)
    got, xq, xs = mlp_kernel._ln_linear_cuda(x, None, None, wq, ws, bias, 0.0, None)
    # The reference spells the function out with an integer product on
    # the CPU (the library product of the plain version needs > 16 rows).
    xq_ref, xs_ref = mlp_kernel._row_quant(x)
    acc = (xq_ref.cpu().int() @ wq.cpu().int()).cuda().float()
    ref = (acc * (xs_ref * ws.reshape(1, -1)) + bias.float()).to(torch.bfloat16)
    # No LayerNorm: the row pass quantizes the very bf16 values, so the
    # int8 rows and the int32 sums are exact and only the last rounding differs.
    assert torch.equal(xq, xq_ref)
    torch.testing.assert_close(xs, xs_ref, rtol=1e-6, atol=0)
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ln,residual", [(True, False), (False, True), (True, True)])
def test_cuda_fused_ln_linear_matches_plain(cuda, ln, residual):
    x = _rand(cuda, 2, 1024, 1280, scale=2.0, shift=0.3)
    N = 3840 if ln else 1280
    wq, ws = _weight(cuda, 1280, N)
    bias = _rand(cuda, N, scale=0.5)
    g = _rand(cuda, 1280, scale=0.1, shift=1.0) if ln else None
    b = _rand(cuda, 1280, scale=0.1) if ln else None
    res = _rand(cuda, 2, 1024, N) if residual else None
    got = mlp_kernel.fused_ln_linear(x, g, b, wq, ws, bias, 1e-6, residual=res)
    ref = mlp_kernel.fused_ln_linear_plain(x, g, b, wq, ws, bias, 1e-6, True, res)
    assert got.shape == (2, 1024, N)
    assert _row_rel_err(got, ref) <= _TOL
    _, xq, xs = mlp_kernel._ln_linear_cuda(x.reshape(-1, 1280), g, b, wq, ws, bias, 1e-6, None)
    _, xq_ref, xs_ref = mlp_kernel._ln_linear_parts_plain(
        x.reshape(-1, 1280), g, b, wq, ws, bias, 1e-6, True, None)
    assert _int8_ok(xq, xq_ref)
    torch.testing.assert_close(xs, xs_ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("f_chunk", [0, 512])
def test_cuda_fused_mlp_block_matches_plain(cuda, f_chunk):
    T, C, F = 1024 + 64, 1280, 5120
    x = _rand(cuda, T, C, scale=2.0, shift=0.3)
    w1, s1 = _weight(cuda, C, F)
    w2, s2 = _weight(cuda, F, C)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)
    b1, b2 = _rand(cuda, F, scale=0.5), _rand(cuda, C, scale=0.5)
    fc = f_chunk or mlp_kernel.default_f_chunk(F)
    args = (x, g, b, w1, s1, b1, w2, s2, b2, 1e-6, fc)
    got, xq, xs, hq, hs = mlp_kernel._mlp_block_cuda(*args)
    ref, xq_ref, xs_ref, hq_ref, hs_ref = mlp_kernel._mlp_block_parts_plain(*args, True)
    assert _int8_ok(xq, xq_ref)
    assert _int8_ok(hq, hq_ref)
    torch.testing.assert_close(hs, hs_ref, rtol=1e-3, atol=0)
    assert _row_rel_err(got, ref) <= _TOL
    assert torch.equal(mlp_kernel.fused_mlp_block(*args[:-1], f_chunk=f_chunk, w8a8=True), got)


@pytest.mark.cuda
@pytest.mark.parametrize("f_chunk", [512, 1024])
@pytest.mark.parametrize("T", [512, 1000, 1024])
def test_cuda_fused_mlp_block_row_counts_match_plain(cuda, T, f_chunk):
    """K12 on the wgmma + TMA int8 core at row counts of one 128-row tile's
    multiples (512, the corner class's 1024) and not (1000: the last tile
    ragged), with fc1's columns growing by chunk so that each chunk's
    abs-max of a row is its own: the cluster reduction of fc1 and the
    per-chunk scales of fc2 both show in the gates."""
    C, F = 1280, 5120
    x = _rand(cuda, T, C, scale=2.0, shift=0.3)
    gain = (1 + torch.arange(F, device="cuda") // 1024).float()
    leaf = quant.quantize_int8(torch.randn((C, F), generator=cuda, device="cuda") * 0.05 * gain)
    w1, s1 = leaf["q"], leaf["scale"]
    w2, s2 = _weight(cuda, F, C)
    g, b = _rand(cuda, C, scale=0.1, shift=1.0), _rand(cuda, C, scale=0.1)
    b1, b2 = _rand(cuda, F, scale=0.5), _rand(cuda, C, scale=0.5)
    args = (x, g, b, w1, s1, b1, w2, s2, b2, 1e-6, f_chunk)
    got, xq, xs, hq, hs = mlp_kernel._mlp_block_cuda(*args)
    ref, xq_ref, xs_ref, hq_ref, hs_ref = mlp_kernel._mlp_block_parts_plain(*args, True)
    assert _int8_ok(xq, xq_ref)
    assert _int8_ok(hq, hq_ref)
    torch.testing.assert_close(hs, hs_ref, rtol=1e-3, atol=0)
    assert _row_rel_err(got, ref) <= _TOL
    # The chunk scales differ severalfold, so one for the whole row fails.
    one = mlp_kernel._mlp_block_parts_plain(*args[:-1], F, True)[0]
    assert _row_rel_err(one, ref) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("exp_bf16", [False, True])
@pytest.mark.parametrize("B,H", [(1, 16), (3, 16), (3, 6)], ids=["b1", "b3", "b3_h6_group_tail"])
def test_cuda_fused_global_attention_y_matches_plain(cuda, exp_bf16, B, H):
    hd, W = 80, 64
    S, sc = W * W, 80**-0.5
    y = _rand(cuda, B, S, 3 * H * hd)
    a = _rand(cuda, B, S, H, W, scale=2.0 / sc)
    bb = _rand(cuda, B, S, H, W, scale=2.0 / sc)
    got = sam_attention.fused_global_attention_y(y, a, bb, H, hd, W, sc, exp_bf16=exp_bf16)
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, H, hd, W, sc, exp_bf16=exp_bf16)
    assert _row_rel_err(got, ref) <= (2e-2 if exp_bf16 else _TOL)
    swapped = sam_attention.fused_global_attention_y(y, bb, a, H, hd, W, sc, exp_bf16=exp_bf16)
    assert _row_rel_err(swapped, ref) > 2e-2


@pytest.mark.cuda
def test_cuda_fused_global_attention_exp_bf16_matches_plain(cuda):
    """The transpose-staged global kernel in its serving form."""
    q, k, v = (_rand(cuda, 2, 4096, 80) for _ in range(3))
    a, b = (_rand(cuda, 2, 4096, 64, scale=2.0) for _ in range(2))
    sc = 80**-0.5
    got = sam_attention.fused_global_attention(q, k, v, a, b, 64, sc, exp_bf16=True)
    ref = sam_attention.fused_global_attention_plain(q, k, v, a, b, 64, sc, exp_bf16=True)
    assert _row_rel_err(got, ref) <= 2e-2
    swapped = sam_attention.fused_global_attention(q, k, v, b, a, 64, sc, exp_bf16=True)
    assert _row_rel_err(swapped, ref) > 2e-2


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = _rand(cuda, 64, 128)
    wq, ws = _weight(cuda, 128, 512)
    v, bias = _rand(cuda, 128), _rand(cuda, 512)
    # Both forms refuse a row-major weight (not copied) and a fc2 of the
    # wrong shape; the weight-only forms have kernels of their own now
    # (`tests/test_torch_cuda_weight_only.py`).
    for w8a8 in (True, False):
        with pytest.raises(ValueError, match="column-major"):
            mlp_kernel.fused_ln_linear(x, v, v, wq.contiguous(), ws, bias, 1e-6, w8a8=w8a8)
        with pytest.raises(ValueError, match="fc2"):
            mlp_kernel.fused_mlp_block(x, v, v, wq, ws, bias, wq, ws, v, 1e-6, w8a8=w8a8)
    # The int8 score form has its kernel now (`tests/test_torch_cuda_dots_i8.py`).
    y = _rand(cuda, 1, 4096, 3 * 80)
    t = _rand(cuda, 1, 4096, 1, 64)
    got = sam_attention.fused_global_attention_y(y, t, t, 1, 80, 64, 0.1, dots_i8=True)
    ref = sam_attention.fused_global_attention_y_plain(y, t, t, 1, 80, 64, 0.1, dots_i8=True)
    assert _row_rel_err(got, ref) <= 1e-2
