"""On the card: the kernel forms of the all-int8 serving configuration
against their plain PyTorch versions, in bf16, at ViT-H and CLIP ViT-L/14
widths and small counts: the int8 score forms (`dots_i8`) of the window
kernel (196 rows, and 200 rows with four left out as keys), of the
lane-sliced global kernel (both exponential forms) and of the boundary
kernel (one and two geometries), and the flash forward at head_dim 64.
Every test here needs an NVIDIA GPU and skips without one. The file
imports torch only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_dots_i8.py -q

Gates: within 1e-2 of each row's largest value (one bf16 ulp there; the
int8 codes are computed with the same arithmetic on both sides, so only
the order of fp32 operations differs), over the real query rows; 2e-2
for the bf16 exponentials, whose rounding follows the running maximum.
"""

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import attention, sam_attention

_TOL = 1e-2
_H, _HD, _W = 16, 80, 14
_KW = dict(num_heads=_H, head_dim=_HD, window=_W, scale=_HD**-0.5)


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


def _launches(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("S", [196, 200], ids=["block_196", "padded_200"])
def test_cuda_window_attention_dots_i8_matches_plain(cuda, S):
    N, real = 6, _W * _W
    y = _rand(cuda, N, S, 3 * _H * _HD)
    a, bb = (_rand(cuda, N, S, _H * _W, scale=2.0 / _KW["scale"]) for _ in range(2))
    tr = S if S != real else 0
    got = _launches("fused_window_attention_grid_i8", lambda: sam_attention.fused_window_attention_grid(
        y, a, bb, **_KW, total_rows=tr, dots_i8=True))
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, *_KW.values(), dots_i8=True)
    assert torch.isfinite(got).all()
    assert _row_rel_err(got[:, :real], ref[:, :real]) <= _TOL
    swapped = sam_attention.fused_window_attention_grid(y, bb, a, **_KW, total_rows=tr, dots_i8=True)
    assert _row_rel_err(swapped[:, :real], ref[:, :real]) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("exp_bf16", [True, False], ids=["exp_bf16", "exp_fp32"])
@pytest.mark.parametrize("B,H", [(1, 2), (1, 16), (3, 6)], ids=["b1", "b1_h16", "b3_h6_group_tail"])
def test_cuda_global_attention_y_dots_i8_matches_plain(cuda, exp_bf16, B, H):
    W = 64
    y = _rand(cuda, B, W * W, 3 * H * _HD)
    a, bb = (_rand(cuda, B, W * W, H, W, scale=2.0 / _KW["scale"]) for _ in range(2))
    kw = dict(num_heads=H, head_dim=_HD, window=W, scale=_KW["scale"], exp_bf16=exp_bf16,
              dots_i8=True)
    pre = kernels.launch_counts()["global_attention_y_quant_i8"]
    got = _launches("fused_global_attention_y_i8",
                    lambda: sam_attention.fused_global_attention_y(y, a, bb, **kw))
    assert kernels.launch_counts()["global_attention_y_quant_i8"] == pre + 1
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw)
    tol = 2e-2 if exp_bf16 else _TOL
    assert _row_rel_err(got, ref) <= tol
    assert _row_rel_err(sam_attention.fused_global_attention_y(y, bb, a, **kw), ref) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 16), (3, 6)], ids=["b1", "b3_h6"])
def test_cuda_global_y_quant_i8_matches_plain(cuda, B, H):
    """The pre-pass of the global int8 form, bit for bit: codes, scales and
    the [A | B] codes as the plain `_row_quant` arithmetic gives them."""
    W = 64
    y = _rand(cuda, B, W * W, 3 * H * _HD)
    a, bb = (_rand(cuda, B, W * W, H, W, scale=2.0 / _KW["scale"]) for _ in range(2))
    got = _launches("global_attention_y_quant_i8",
                    lambda: sam_attention.global_y_quant_i8(y, a, bb, H, _HD))
    ref = sam_attention.global_y_quant_i8_plain(y, a, bb, H, _HD)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("geoms", [[(8, 8)], [(14, 8), (8, 14)]], ids=["corner", "dual"])
def test_cuda_rect_attention_dots_i8_matches_plain(cuda, geoms):
    per = 4
    rows, cols = geoms[0]
    N, T = per * len(geoms), rows * cols
    y = _rand(cuda, N, T, 3 * _H * _HD)
    a, bb = (_rand(cuda, N, T, _H * _W, scale=2.0 / _KW["scale"]) for _ in range(2))
    qkv_bias = _rand(cuda, 3 * _H * _HD, scale=0.5)
    ohs = [image_encoder._rect_onehot(r, c, _W, y.dtype, y.device) for r, c in geoms]
    pads = [image_encoder._pad_tables(qkv_bias, r, c, _W, _H, _HD, y.dtype) for r, c in geoms]
    tables = ((ohs[0], *pads[0]) if len(geoms) == 1 else
              (torch.stack(ohs), torch.stack([k for k, _ in pads]), torch.stack([v for _, v in pads])))
    geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
    got = _launches("fused_window_attention_rect_i8", lambda: sam_attention.fused_window_attention_rect(
        y, a, bb, *tables, **_KW, dots_i8=True, geometry=geometry))
    ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, *_KW.values(),
                                                          dots_i8=True)
    assert _row_rel_err(got, ref) <= _TOL
    # The pad keys' value counts (their scores are the unquantized ones).
    nov = sam_attention.fused_window_attention_rect(
        y, a, bb, *tables[:2], torch.zeros_like(tables[2]), **_KW, dots_i8=True, geometry=geometry)
    assert _row_rel_err(nov, ref) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["clip", "causal"])
def test_cuda_flash_hd64_matches_plain(cuda, causal):
    B, S, H, hd = 3, 264, 16, 64
    q, k, v = (_rand(cuda, B, S, H, hd) for _ in range(3))
    lens = torch.tensor([257, 257, 100], dtype=torch.int32, device="cuda")
    run = lambda l=lens: attention.flash_attention_fwd_bsh(  # noqa: E731
        q, k, v, l, causal=causal, scale=hd**-0.5)
    got = _launches("flash_attention_fwd_bsh_hd64", run)
    ref = attention.flash_attention_fwd_bsh_plain(q, k, v, lens, causal=causal, scale=hd**-0.5)
    assert _row_rel_err(got, ref) <= _TOL
    # kv_lens ignored (every pad key attended) fails the gate.
    assert _row_rel_err(run(torch.full_like(lens, S)), ref) > _TOL


@pytest.mark.cuda
def test_cuda_flash_wrappers_refuse_other_head_dims(cuda):
    lens = torch.tensor([64], dtype=torch.int32, device="cuda")
    for hd in (32, 80, 96):
        q = _rand(cuda, 1, 64, 2, hd)
        with pytest.raises(ValueError, match="head_dim"):
            attention.flash_attention_fwd_bsh(q, q, q, lens, causal=False, scale=0.1)
    # The training kernels (K15-K17) stay at 128.
    q = _rand(cuda, 1, 64, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_fwd(q, q, q, lens, causal=True, scale=0.1)
    lse = torch.zeros((1, 2, 64), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_bwd(q, q, q, q, lse, q, lens, causal=True, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [196, 200], ids=["block_196", "padded_200"])
def test_cuda_window_attention_dots_i8_one_window_six_heads(cuda, S):
    """One window of 6 heads; in the padded form tail rows of magnitude 1e3
    that reach no real row (the compact window's rows bit for bit)."""
    H, real = 6, _W * _W
    kw = dict(_KW, num_heads=H)
    y = _rand(cuda, 1, S, 3 * H * _HD)
    a, bb = (_rand(cuda, 1, S, H * _W, scale=2.0 / _KW["scale"]) for _ in range(2))
    if S > real:
        y[:, real:] = _rand(cuda, 1, S - real, 3 * H * _HD, scale=1e3)
        a[:, real:], bb[:, real:] = (_rand(cuda, 1, S - real, H * _W, scale=1e3) for _ in range(2))
    tr = S if S != real else 0
    got = sam_attention.fused_window_attention_grid(y, a, bb, **kw, total_rows=tr, dots_i8=True)
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, *kw.values(), dots_i8=True)
    assert bool(torch.isfinite(got).all())
    assert _row_rel_err(got[:, :real], ref[:, :real]) <= _TOL
    compact = sam_attention.fused_window_attention_grid(
        y[:, :real].contiguous(), a[:, :real].contiguous(), bb[:, :real].contiguous(), **kw,
        dots_i8=True)
    assert torch.equal(compact, got[:, :real])

