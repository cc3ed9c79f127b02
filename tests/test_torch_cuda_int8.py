"""On the card: each CUDA kernel of the int8 serving path against its plain
PyTorch version, in bf16. Every test here needs an NVIDIA GPU and skips
without one. The file imports torch only, so it runs on a machine that has
no JAX:

    python -m pytest tests/test_torch_cuda_int8.py -q

Gates: int8 outputs at least 99.9% exact and the rest within 1 (an fp32
value within summation-order noise of .5 may round the other way);
abs-max and scales rtol 1e-6; the residual stream `h` exact; bf16 outputs
within 1e-2 of each row's largest value (one bf16 ulp there); cache bytes
outside the written rows unchanged.
"""

import pytest
import torch

from ullava_tpu_torch.ops import decode_attention, mlp_kernel, norms, quant

_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _int8_ok(got, ref):
    diff = (got.int() - ref.int()).abs()
    return bool((diff <= 1).all()) and (diff == 0).float().mean().item() >= 0.999


def _noise_cache(gen, L, B, maxS, Hkv, hd):
    ck, cv = (torch.randint(-127, 128, (L, B, maxS, Hkv * hd), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((L, B, maxS, Hkv), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(2))
    return [ck, cv, ks, vs]


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
def test_cuda_rms_norm_quant_matches_plain(cuda, residual):
    x, res = _rand(cuda, 64, 4096), _rand(cuda, 64, 4096)
    w = (1 + 0.1 * torch.randn(4096, generator=cuda, device="cuda")).to(torch.bfloat16)
    r = res if residual else None
    h_ref, q_ref, s_ref = norms.rms_norm_residual_quant_plain(x, r, w, 1e-6)
    if residual:
        h, q, s = norms.rms_norm_residual_quant(x, res, w, 1e-6)
        assert torch.equal(h, h_ref)
        # Dropping the residual must break the gate.
        _, q_bad, _ = norms.rms_norm_residual_quant(x, torch.zeros_like(res), w, 1e-6)
        assert not _int8_ok(q_bad, q_ref)
    else:
        q, s = norms.rms_norm_quant(x, w, 1e-6)
    assert _int8_ok(q, q_ref)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_silu_mul_quant_matches_plain(cuda):
    g, u = _rand(cuda, 48, 11008, scale=2.0), _rand(cuda, 48, 11008)
    q, s = mlp_kernel.silu_mul_quant(g, u)
    q_ref, s_ref = mlp_kernel.silu_mul_quant_plain(g, u)
    assert _int8_ok(q, q_ref)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    assert not _int8_ok(mlp_kernel.silu_mul_quant(g, torch.ones_like(u))[0], q_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hkv,hd", [
    (37, 4, 128), (37, 3, 64), (37, 2, 200),
    (37, 3, 36), (5, 1, 4),  # hd % 8 != 0: the 8-byte instance
    (1, 4, 128), (1, 2, 36),  # one cache row
])
def test_cuda_prefill_quantize_write_matches_plain(cuda, S, Hkv, hd):
    L, B, maxS, layer = 3, 2, S + 11, 1
    k, v = _rand(cuda, B, S, Hkv, hd), _rand(cuda, B, S, Hkv, hd, scale=3.0)
    cache = _noise_cache(cuda, L, B, maxS, Hkv, hd)
    expect = decode_attention.prefill_quantize_write_plain(k, v, *(c.clone() for c in cache), layer)
    got = decode_attention.prefill_quantize_write(k, v, *cache, layer)
    for g, c, e in zip(got, cache, expect):
        assert g is c
        if g.dtype == torch.int8:
            assert _int8_ok(g[layer, :, :S], e[layer, :, :S])
            g = g.clone()
            g[layer, :, :S] = e[layer, :, :S]
            assert torch.equal(g, e)  # every other byte unchanged
        else:
            torch.testing.assert_close(g, e, rtol=1e-6, atol=0)


def _tie_rows(gen, B, S, Hkv, hd):
    """Rows on which x / scale falls exactly on k + 0.5: one +-amax of
    127 * 2^-4 a (row, head), so the scale is 2^-4 exactly, the rest
    (k + 0.5) * 2^-4, exact in bf16."""
    x = (torch.randint(-127, 127, (B, S, Hkv, hd), generator=gen, device="cuda").float() + 0.5) / 16
    peak = torch.randint(0, hd, (B, S, Hkv, 1), generator=gen, device="cuda")
    sign = torch.randint(0, 2, (B, S, Hkv, 1), generator=gen, device="cuda").float() * 2 - 1
    return x.scatter_(-1, peak, sign * 127 / 16).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 36])
def test_cuda_prefill_quantize_write_rounds_ties_to_even(cuda, hd):
    L, B, S, maxS, Hkv, layer = 2, 2, 11, 16, 4, 0
    k, v = _tie_rows(cuda, B, S, Hkv, hd), _tie_rows(cuda, B, S, Hkv, hd)
    cache = _noise_cache(cuda, L, B, maxS, Hkv, hd)
    decode_attention.prefill_quantize_write(k, v, *cache, layer)
    for x, q, s in ((k, cache[0], cache[2]), (v, cache[1], cache[3])):
        assert torch.equal(s[layer, :, :S], torch.full((B, S, Hkv), 1 / 16, device="cuda"))
        even = torch.round(x.float() * 16)  # half to even
        assert torch.equal(q[layer, :, :S].reshape(B, S, Hkv, hd).float(), even)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 36])
def test_cuda_prefill_quantize_write_bit_equal_to_cpu_plain(cuda, hd):
    """The kernel divides as the plain version does on the CPU, where
    every fp32 division is IEEE (on the card, PyTorch divides by the
    scalar 127 as a multiply by its reciprocal): int8 rows and scales
    bit-equal."""
    L, B, S, maxS, Hkv, layer = 2, 3, 29, 32, 4, 1
    k, v = _rand(cuda, B, S, Hkv, hd), _rand(cuda, B, S, Hkv, hd, scale=3.0)
    cache = _noise_cache(cuda, L, B, maxS, Hkv, hd)
    cpu = decode_attention.prefill_quantize_write_plain(
        k.cpu(), v.cpu(), *(c.cpu() for c in cache), layer)
    got = decode_attention.prefill_quantize_write(k, v, *cache, layer)
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_cuda_kv_quant_division_gives_ieee_codes_on_every_bf16_pair(cuda):
    codes, _, seen = decode_attention.kv_quant_division_check()
    n = 0x7F7F  # positive finite bf16 abs-max patterns
    assert seen == n * (n + 3)  # x patterns 0..amax, two signs, for each
    assert codes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,hd", [(8, 8, 128), (8, 2, 64), (4, 4, 16)])
def test_cuda_decode_attention_fused_write_matches_plain(cuda, H, Hkv, hd):
    L, B, maxS, layer = 2, 4, 352, 1
    q = _rand(cuda, B, 1, H, hd)
    cache = _noise_cache(cuda, L, B, maxS, Hkv, hd)
    kq, vq = (torch.randint(-127, 128, (B, Hkv * hd), generator=cuda, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ksn, vsn = (torch.rand((B, Hkv), generator=cuda, device="cuda") * 0.02 + 1e-3 for _ in range(2))
    wp = torch.tensor([320, 0, 351, 77], device="cuda")
    sc = hd**-0.5
    expect = decode_attention.decode_attention_int8_fused_write_plain(
        q, kq, ksn, vq, vsn, *(c.clone() for c in cache), wp, layer, scale=sc)
    got = decode_attention.decode_attention_int8_fused_write(
        q, kq, ksn, vq, vsn, *cache, wp, layer, scale=sc)
    torch.cuda.synchronize()
    # Held to the plain version fed the same q as fp32 and rounded to bf16
    # once, as the kernel's fp32 result is, within one bf16 ulp of a row's
    # largest value (2^-7); and to the bf16 plain version, which rounds
    # its probabilities and dequantized rows as well, within two (2^-6).
    ref = decode_attention.decode_attention_int8_fused_write_plain(
        q.float(), kq, ksn, vq, vsn, *expect[1:], wp, layer, scale=sc)[0].to(torch.bfloat16)
    assert _row_rel_err(got[0], ref) <= 2.0**-7
    assert _row_rel_err(got[0], expect[0]) <= 2.0**-6
    for g, c, e in zip(got[1:], cache, expect[1:]):
        assert g is c and torch.equal(g, e)  # new rows in place, the rest untouched
    # Attending one row short (the new row left out) must break the gate.
    stale = decode_attention.decode_attention_int8_xla(q, *cache, wp.clamp_min(1), layer, scale=sc)
    assert min(_row_rel_err(stale, ref), _row_rel_err(stale, expect[0])) > 2.0**-6


def _check_fused_write(gen, L, B, maxS, H, Hkv, hd, wp, splits):
    """K8 against both plain versions (module docstring's limits) and the
    cache against the scatter, at each split count in `splits`."""
    q = _rand(gen, B, 1, H, hd)
    cache = _noise_cache(gen, L, B, maxS, Hkv, hd)
    kq, vq = (torch.randint(-127, 128, (B, Hkv * hd), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ksn, vsn = (torch.rand((B, Hkv), generator=gen, device="cuda") * 0.02 + 1e-3 for _ in range(2))
    wp = torch.tensor(wp, device="cuda")
    layer, sc = L - 1, hd**-0.5
    expect = decode_attention.decode_attention_int8_fused_write_plain(
        q, kq, ksn, vq, vsn, *(c.clone() for c in cache), wp, layer, scale=sc)
    ref = decode_attention.decode_attention_int8_fused_write_plain(
        q.float(), kq, ksn, vq, vsn, *(c.clone() for c in expect[1:]), wp, layer,
        scale=sc)[0].to(torch.bfloat16)
    for n in splits:
        fresh = [c.clone() for c in cache]
        if n is None:  # the public entry: the wrapper's own split
            got = decode_attention.decode_attention_int8_fused_write(
                q, kq, ksn, vq, vsn, *fresh, wp, layer, scale=sc)
        else:
            got = (decode_attention._fused_write_cuda(
                q, kq, ksn, vq, vsn, *fresh, wp, layer, sc, n), *fresh)
        torch.cuda.synchronize()
        assert _row_rel_err(got[0], ref) <= 2.0**-7, n
        assert _row_rel_err(got[0], expect[0]) <= 2.0**-6, n
        for g, e in zip(got[1:], expect[1:]):
            assert torch.equal(g, e), n


@pytest.mark.cuda
def test_cuda_decode_attention_fused_write_tile_and_split_edges(cuda):
    """Write positions at the kernel's edges: the first row, a warp tile's
    (16 rows at head_dim 128) and a block round's (64) edges +-1, the edges
    of two splits of the longest sample +-1, the last row; GQA rep 4; one
    block a (sample, head) and 2, 3 and 5 splits (the last block to finish
    merges), and the wrapper's own choice."""
    wp = [0, 15, 16, 17, 63, 64, 65, 79, 80, 81, 159]
    _check_fused_write(cuda, 2, len(wp), 160, 8, 2, 128, wp, [None, 1, 2, 3, 5])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 4])
def test_cuda_decode_attention_fused_write_long_cache(cuda, B):
    """A 2048-row cache, write positions 1900-2047: at B=16 one block a
    (sample, head), at B=4 the wrapper splits the rows."""
    wp = [1900 + (37 * i) % 148 for i in range(B)]
    _check_fused_write(cuda, 1, B, 2048, 32, 32, 128, wp, [None, 1, 4])


@pytest.mark.cuda
def test_cuda_decode_attention_fused_write_limits(cuda):
    """No score row in shared memory: a 16384-row cache (refused before
    the redesign, at 48 KB of shared memory) is taken. What stays refused:
    a head_dim that is not 16 * 2^n up to 512, a split count below 1."""
    _check_fused_write(cuda, 1, 2, 16384, 4, 4, 128, [16383, 9000], [None, 8])
    q = _rand(cuda, 1, 1, 2, 48)
    cache = _noise_cache(cuda, 1, 1, 16, 2, 48)
    new = torch.zeros((1, 96), dtype=torch.int8, device="cuda")
    s = torch.ones((1, 2), device="cuda")
    wp = torch.tensor([3], device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention.decode_attention_int8_fused_write(q, new, s, new, s, *cache, wp, 0, scale=1.0)
    q, cache = _rand(cuda, 1, 1, 2, 64), _noise_cache(cuda, 1, 1, 16, 2, 64)
    new = torch.zeros((1, 128), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="splits"):
        decode_attention._fused_write_cuda(q, new, s, new, s, *cache, wp, 0, 1.0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2048, 8, 1])  # a prefill's rows, a decode step's
def test_cuda_rms_norm_matches_plain(cuda, rows):
    x = _rand(cuda, 2, rows, 4096, scale=2.0)
    w = (1 + 0.1 * torch.randn(4096, generator=cuda, device="cuda")).to(torch.bfloat16)
    ref = norms.rms_norm_plain(x, w, 1e-6)
    assert _row_rel_err(norms.rms_norm(x, w, 1e-6), ref) <= _TOL
    assert _row_rel_err(norms.rms_norm(x, torch.ones_like(w), 1e-6), ref) > _TOL


# (rows, D): the few-row form's row counts (1, a decode step's 16, the
# crossover) and the first past it, and widths that are no multiple of its
# 2048-element pass, up to the widest row the wrapper takes.
_RMS_FORMS = [(1, 4096), (16, 4096), (norms.RMS_FEW_ROWS, 4096),
              (norms.RMS_FEW_ROWS + 1, 4096), (16, 4104), (3, 12256), (5, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D", _RMS_FORMS)
def test_cuda_rms_norm_both_forms_match_plain(cuda, rows, D):
    """`rms_norm` takes the few-row form up to `RMS_FEW_ROWS` rows and the
    staged one past it; each form, forced, agrees with the plain version at
    every shape, and dropping the weight breaks the gate."""
    x = _rand(cuda, rows, D, scale=2.0)
    w = (1 + 0.1 * torch.randn(D, generator=cuda, device="cuda")).to(torch.bfloat16)
    ref = norms.rms_norm_plain(x, w, 1e-6)
    assert _row_rel_err(norms.rms_norm(x, w, 1e-6), ref) <= _TOL
    for few_rows in (True, False):
        assert _row_rel_err(norms._rms_norm_fwd_cuda(x, w, 1e-6, few_rows), ref) <= _TOL
    assert _row_rel_err(norms.rms_norm(x, torch.ones_like(w), 1e-6), ref) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 17])
def test_cuda_int8_matmul_any_rows(cuda, M):
    """The library int8 product refuses 16 rows or fewer on the card;
    `int8_matmul` pads them and gives the exact int32 sums."""
    xq = torch.randint(-127, 128, (M, 4096), generator=cuda, device="cuda", dtype=torch.int8)
    wq = quant.column_major(torch.randint(-127, 128, (4096, 512), generator=cuda, device="cuda",
                                          dtype=torch.int8))
    got = quant.int8_matmul(xq, wq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, 512)
    assert torch.equal(got.cpu(), xq.cpu().long().matmul(wq.cpu().long()).int())
