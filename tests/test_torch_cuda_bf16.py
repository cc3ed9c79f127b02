"""On the card: the four CUDA kernels of the bf16 serving path (rotary,
causal flash prefill, SAM window and global attention, the last on the
wgmma + TMA global core in both exponential forms) against their plain
PyTorch versions, in bf16. Every test here needs an NVIDIA GPU and skips
without one. The file imports torch only, so it runs on a machine that has
no JAX:

    python -m pytest tests/test_torch_cuda_bf16.py -q
"""

import pytest
import torch

from ullava_tpu_torch.ops import attention, rope, sam_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _row_rel_err(got, ref):
    """max over rows of max|got - ref| / max|ref| on that row."""
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


# Tolerance for all four: 1e-2 of each output row's largest value, which
# admits one bf16 ulp there (at most 2^-7 of it) and not two.
_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hd,heads", [
    (96, 128, 4),
    (97, 128, 32),  # rows no multiple of anything the launch takes
    (97, 64, 4),
    (2500, 128, 32),  # more rows than the grid's blocks: blocks walk rows
    (33, 40, 3),  # hd % 16 != 0: 8-byte accesses
    (33, 36, 5),  # hd % 8 != 0: 4-byte accesses
])
def test_cuda_fused_rotary_matches_plain(cuda, rows, hd, heads):
    x = _rand(cuda, rows, heads * hd)
    cos, sin = rope.rope_cos_sin(torch.arange(rows, device="cuda") % 301, hd)
    got = rope.fused_rotary(x, cos, sin, hd)
    ref = rope.fused_rotary_plain(x, cos, sin, hd)
    assert _row_rel_err(got, ref) <= _TOL
    assert _row_rel_err(rope.fused_rotary(x, cos, -sin, hd), ref) > _TOL


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda):
    q, k, v = (_rand(cuda, 2, 150, 4, 128) for _ in range(3))
    lens = torch.tensor([150, 61], dtype=torch.int32, device="cuda")
    got = attention.flash_attention_fwd_bsh(q, k, v, lens, causal=True, scale=128**-0.5)
    ref = attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=True, scale=128**-0.5)
    assert _row_rel_err(got, ref) <= _TOL
    bad = attention.flash_attention_fwd_bsh(q, k, v, lens, causal=False, scale=128**-0.5)
    assert _row_rel_err(bad, ref) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("Sq,Sk,causal,q_offset", [
    (1, 40, True, 39),      # one decode-like query row at the end of its keys
    (16, 16, True, 0),      # the crossover microbenchmark's shortest prefill
    (100, 130, True, 30),   # a static offset; Sq no multiple of 64
    (264, 264, False, 0),   # CLIP's padded sequence, not causal
    (320, 320, True, 0),    # the serving prefill
])
def test_cuda_flash_attention_edges_match_plain(cuda, hd, Sq, Sk, causal, q_offset):
    """K2 at both head dims on the wgmma + TMA forward: GQA (8 heads over
    2 kv heads), a kv_len of 0 (zeros out), one inside a key tile, one at
    Sk, and every sequence length the serving paths and the crossover
    microbenchmark give it; kv_lens ignored fails the gate."""
    from ullava_tpu_torch import kernels

    B, H, Hkv = 3, 8, 2
    q = _rand(cuda, B, Sq, H, hd)
    k, v = (_rand(cuda, B, Sk, Hkv, hd) for _ in range(2))
    lens = torch.tensor([Sk, 0, max(1, Sk - 7)], dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, scale=hd**-0.5, q_offset=q_offset)
    name = "flash_attention_fwd_bsh_hd64" if hd == 64 else "flash_attention_fwd_bsh"
    before = kernels.launch_counts()[name]
    got = attention.flash_attention_fwd_bsh(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = attention.flash_attention_fwd_bsh_plain(q, k, v, lens, **kw)
    assert _row_rel_err(got, ref) <= _TOL
    assert not got[1].any()
    assert bool(torch.isfinite(got.float()).all())
    if Sk > 8:
        bad = attention.flash_attention_fwd_bsh(q, k, v, torch.full_like(lens, Sk), **kw)
        assert _row_rel_err(bad[2:], ref[2:]) > _TOL


@pytest.mark.cuda
def test_cuda_sam_attention_matches_plain(cuda):
    # Bias terms at the encoder's size: q.rel_pos with an unscaled q, std
    # about 2 (K3 takes them pre-scaled by 1/scale).
    sc = 80**-0.5
    y = _rand(cuda, 3, 196, 3 * 16 * 80)
    a, b = (_rand(cuda, 3, 196, 16 * 14, scale=2.0 / sc) for _ in range(2))
    args = (16, 80, 14, sc)
    got = sam_attention.fused_window_attention_grid(y, a, b, *args)
    ref = sam_attention.fused_window_attention_grid_plain(y, a, b, *args)
    assert _row_rel_err(got, ref) <= _TOL
    assert _row_rel_err(sam_attention.fused_window_attention_grid(y, b, a, *args), ref) > _TOL
    q, k, v = (_rand(cuda, 2, 4096, 80) for _ in range(3))
    rel_h, rel_w = (_rand(cuda, 127, 80, scale=0.25) for _ in range(2))
    a, b = (t.reshape(2, 4096, 64).to(torch.bfloat16) for t in sam_attention.decomposed_bias_terms(
        q.reshape(1, 2, 64, 64, 80), rel_h, rel_w, 64))
    got = sam_attention.fused_global_attention(q, k, v, a, b, 64, sc)
    ref = sam_attention.fused_global_attention_plain(q, k, v, a, b, 64, sc)
    assert _row_rel_err(got, ref) <= _TOL
    assert _row_rel_err(sam_attention.fused_global_attention(q, k, v, b, a, 64, sc), ref) > _TOL


def _global_inputs(gen, N):
    q, k, v = (_rand(gen, N, 4096, 80) for _ in range(3))
    rel_h, rel_w = (_rand(gen, 127, 80, scale=0.25) for _ in range(2))
    a, b = (t.reshape(N, 4096, 64).to(torch.bfloat16) for t in sam_attention.decomposed_bias_terms(
        q.reshape(1, N, 64, 64, 80), rel_h, rel_w, 64))
    return q, k, v, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("exp_bf16,tol", [(False, 1e-2), (True, 2e-2)], ids=["exp_fp32", "exp_bf16"])
@pytest.mark.parametrize("N", [18, 64])
def test_cuda_global_attention_on_the_global_core(cuda, N, exp_bf16, tol):
    """K4 on the wgmma + TMA global core in both exponential forms: N = 18
    leaves the last group of 16 (image, head) pairs a tail of 2; 64 is the
    B=4 serve's. Bias dropped or swapped, and the copies built with the raw
    terms not pre-scaled and with a tile's first grid row's A term for both
    halves, fail the same gate."""
    from ullava_tpu_torch import kernels

    sc = 80**-0.5
    q, k, v, a, b = _global_inputs(cuda, N)
    run = lambda a_=a, b_=b: sam_attention.fused_global_attention(  # noqa: E731
        q, k, v, a_, b_, 64, sc, exp_bf16=exp_bf16)
    ref = sam_attention.fused_global_attention_plain(q, k, v, a, b, 64, sc, exp_bf16=exp_bf16)
    assert _row_rel_err(run(), ref) <= tol
    assert _row_rel_err(run(b, a), ref) > tol
    assert _row_rel_err(run(torch.zeros_like(a), torch.zeros_like(b)), ref) > tol
    for define in ("ULLAVA_MUTANT_GLOBAL_BIAS_RAW", "ULLAVA_MUTANT_GLOBAL_A_ONE_ROW"):
        kernels.build_all(mutants=[("sam_global_attention.cu", define)])
        with kernels.mutant("sam_global_attention.cu", define):
            bad = run()
        torch.cuda.synchronize()
        assert _row_rel_err(bad, ref) > tol, define


@pytest.mark.cuda
@pytest.mark.parametrize("total_rows", [0, 200], ids=["block_196", "padded_200"])
def test_cuda_window_attention_one_window_six_heads(cuda, total_rows):
    """K3 at its edges: one window of 6 heads; in the padded form, tail rows
    of magnitude 1e3 (q, k, v and bias terms) that reach no real row: the
    real rows are the compact window's bit for bit, the tail rows finite."""
    sc, H, S = 80**-0.5, 6, total_rows or 196
    y = _rand(cuda, 1, S, 3 * H * 80)
    a, b = (_rand(cuda, 1, S, H * 14, scale=2.0 / sc) for _ in range(2))
    if total_rows:
        y[:, 196:] = _rand(cuda, 1, S - 196, 3 * H * 80, scale=1e3)
        a[:, 196:], b[:, 196:] = (_rand(cuda, 1, S - 196, H * 14, scale=1e3) for _ in range(2))
    args = (H, 80, 14, sc)
    got = sam_attention.fused_window_attention_grid(y, a, b, *args, total_rows=total_rows)
    ref = sam_attention.fused_window_attention_grid_plain(y, a, b, *args)
    assert got.shape == (1, S, H * 80) and bool(torch.isfinite(got).all())
    assert _row_rel_err(got[:, :196], ref[:, :196]) <= _TOL
    compact = sam_attention.fused_window_attention_grid(
        y[:, :196].contiguous(), a[:, :196].contiguous(), b[:, :196].contiguous(), *args)
    assert torch.equal(compact, got[:, :196])
