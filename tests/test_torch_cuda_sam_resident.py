"""On the card: the CUDA kernels of the SAM encoder's resident window
layout against their plain PyTorch versions, in bf16, at ViT-H widths: the
dual LN1+qkv, the window kernel on windows stored as 200 rows, and the
boundary-window kernel in its single- and dual-geometry forms. Every test
here needs an NVIDIA GPU and skips without one. The file imports torch
only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_sam_resident.py -q

Gates: the LN'd int8 rows at least 99.9% exact and the rest within 1 (an
fp32 value within summation-order noise of .5 may round the other way),
their scales rtol 1e-5; bf16 outputs within 1e-2 of each row's largest
value (one bf16 ulp there, plus what a flipped int8 step moves), for the
attention kernels over the real query rows; the pad rows finite.
"""

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import mlp_kernel, quant, sam_attention

_TOL = 1e-2
_H, _HD, _W = 16, 80, 14
_KW = dict(num_heads=_H, head_dim=_HD, window=_W, scale=_HD**-0.5)


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


def _dual_args(gen, C=1280, F=3840, F2=864):
    wq, ws = _weight(gen, C, F)
    w2, s2 = _weight(gen, C, F2)
    return (_rand(gen, C, scale=0.1, shift=1.0), _rand(gen, C, scale=0.1), wq, ws,
            _rand(gen, F, scale=0.5), w2, s2,
            torch.randn(F2, generator=gen, device="cuda") * 0.5, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,rows2", [(6, 200, 196), (5, 112, 0), (3, 64, 0)],
                         ids=["full_padded", "edge", "corner"])
def test_cuda_fused_ln_linear_dual_matches_plain(cuda, N, T, rows2):
    x = _rand(cuda, N, T, 1280, scale=2.0, shift=0.3)
    args = _dual_args(cuda)
    y, p, xq, xs = mlp_kernel._ln_linear_dual_cuda(x, *args, rows2 or T)
    ry, rp, rxq, rxs = mlp_kernel._ln_linear_dual_parts_plain(x, *args, True, rows2 or T)
    assert y.shape == (N, T, 3840) and p.shape == (N, rows2 or T, 864)
    assert _int8_ok(xq, rxq)
    torch.testing.assert_close(xs, rxs, rtol=1e-5, atol=0)
    assert _row_rel_err(y, ry) <= _TOL and _row_rel_err(p, rp) <= _TOL
    got = mlp_kernel.fused_ln_linear_dual(x, *args, rows2=rows2)
    assert torch.equal(got[0], y) and torch.equal(got[1], p)
    # The first output is `fused_ln_linear`'s: same row pass, same product.
    assert torch.equal(y, mlp_kernel.fused_ln_linear(x, *args[:5], 1e-6))
    # The second bias counts.
    nob = mlp_kernel._ln_linear_dual_cuda(x, *args[:7], torch.zeros_like(args[7]), 1e-6, rows2 or T)
    assert _row_rel_err(nob[1], rp) > _TOL


@pytest.mark.cuda
def test_cuda_fused_ln_linear_dual_2d_and_odd_widths(cuda):
    """The 2-D form, and widths that are no multiple of the GEMM core's
    128-column tile on either weight."""
    x = _rand(cuda, 130, 96, scale=2.0, shift=0.3)
    args = _dual_args(cuda, C=96, F=72, F2=40)
    y, p = mlp_kernel.fused_ln_linear_dual(x, *args, rows2=100)
    ry, rp = mlp_kernel.fused_ln_linear_dual_plain(x, *args, True, 100)
    assert y.shape == (130, 72) and p.shape == (100, 40)
    assert _row_rel_err(y, ry) <= _TOL and _row_rel_err(p, rp) <= _TOL


@pytest.mark.cuda
def test_cuda_fused_ln_linear_dual_one_launch_forms(cuda):
    """Both products in one launch of the wgmma core with ragged last
    column tiles on both weights (F 392, F2 200), 450 rows (no multiple of
    the 128-row tile) and rows2 < T: against the plain version; each
    column range alone (stages 2, 4) bit-equal to the one launch."""
    N, T, C, rows2 = 3, 150, 256, 131
    x = _rand(cuda, N, T, C, scale=2.0, shift=0.3)
    args = _dual_args(cuda, C=C, F=392, F2=200)
    y, p, xq, xs = mlp_kernel._ln_linear_dual_cuda(x, *args, rows2)
    ry, rp, rxq, _ = mlp_kernel._ln_linear_dual_parts_plain(x, *args, True, rows2)
    assert y.shape == (N, T, 392) and p.shape == (N, rows2, 200)
    assert _int8_ok(xq, rxq)
    assert _row_rel_err(y, ry) <= _TOL and _row_rel_err(p, rp) <= _TOL
    y2 = mlp_kernel._ln_linear_dual_cuda(x, *args, rows2, stages=2, scratch=(xq, xs))[0]
    p4 = mlp_kernel._ln_linear_dual_cuda(x, *args, rows2, stages=4, scratch=(xq, xs))[1]
    assert torch.equal(y2, y) and torch.equal(p4, p)


@pytest.mark.cuda
def test_cuda_window_attention_total_rows_matches_plain(cuda):
    N, S = 10, 200
    sc = _KW["scale"]
    y = _rand(cuda, N, S, 3 * _H * _HD)
    a = _rand(cuda, N, S, _H * _W, scale=2.0 / sc)
    bb = _rand(cuda, N, S, _H * _W, scale=2.0 / sc)
    a[:, 196:], bb[:, 196:] = 0, 0
    got = sam_attention.fused_window_attention_grid(y, a, bb, **_KW, total_rows=S)
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, *_KW.values())
    assert got.shape == (N, S, _H * _HD) and bool(torch.isfinite(got).all())
    assert _row_rel_err(got[:, :196], ref[:, :196]) <= _TOL
    assert _row_rel_err(got[:, 196:], ref[:, 196:]) <= _TOL  # the pad rows attend too
    # The real rows are the compact window's, whatever the pad rows hold.
    compact = sam_attention.fused_window_attention_grid(
        y[:, :196].contiguous(), a[:, :196].contiguous(), bb[:, :196].contiguous(), **_KW)
    assert torch.equal(compact, got[:, :196])
    y[:, 196:] += 4.0
    again = sam_attention.fused_window_attention_grid(y, a, bb, **_KW, total_rows=S)
    assert torch.equal(again[:, :196], got[:, :196])


def _rect_inputs(gen, geoms, per, H=_H):
    """`per` windows of each geometry with the encoder's own tables."""
    rows, cols = geoms[0]
    N, T = per * len(geoms), rows * cols
    sc = _KW["scale"]
    y = _rand(gen, N, T, 3 * H * _HD)
    a = _rand(gen, N, T, H * _W, scale=2.0 / sc)
    bb = _rand(gen, N, T, H * _W, scale=2.0 / sc)
    qkv_bias = _rand(gen, 3 * H * _HD, scale=0.5)
    ohs = [image_encoder._rect_onehot(r, c, _W, y.dtype, y.device) for r, c in geoms]
    pads = [image_encoder._pad_tables(qkv_bias, r, c, _W, H, _HD, y.dtype) for r, c in geoms]
    if len(geoms) == 1:
        return y, a, bb, ohs[0], pads[0][0], pads[0][1]
    return (y, a, bb, torch.stack(ohs), torch.stack([k for k, _ in pads]),
            torch.stack([v for _, v in pads]))


@pytest.mark.cuda
@pytest.mark.parametrize("geoms", [[(14, 8)], [(8, 14)], [(8, 8)], [(14, 8), (8, 14)]],
                         ids=["right", "bottom", "corner", "dual"])
def test_cuda_rect_attention_matches_plain(cuda, geoms):
    args = _rect_inputs(cuda, geoms, per=5)
    geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
    got = sam_attention.fused_window_attention_rect(*args, **_KW, geometry=geometry)
    ref = sam_attention.fused_window_attention_rect_plain(*args, *_KW.values())
    assert got.shape == ref.shape
    assert _row_rel_err(got, ref) <= _TOL
    # The pad value counts, and so does which half takes which geometry.
    nov = sam_attention.fused_window_attention_rect(
        *args[:5], torch.zeros_like(args[5]), **_KW, geometry=geometry)
    assert _row_rel_err(nov, ref) > _TOL
    if len(geoms) == 2:
        swapped = sam_attention.fused_window_attention_rect(
            *args, **_KW, geometry=(geoms[1], geoms[0]))
        assert _row_rel_err(swapped, ref) > _TOL


@pytest.mark.cuda
def test_cuda_resident_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = _rand(cuda, 2, 64, 128)
    args = _dual_args(cuda, C=128, F=256, F2=64)
    # Both forms (the weight-only one has its own kernel now,
    # `tests/test_torch_cuda_weight_only.py`) refuse a bf16 second bias
    # (it is f32) and a `rows2` past T.
    for w8a8 in (True, False):
        with pytest.raises(ValueError, match="bias2"):
            mlp_kernel.fused_ln_linear_dual(x, *args[:7], args[7].to(torch.bfloat16), 1e-6,
                                            w8a8=w8a8)
        with pytest.raises(ValueError, match="rows2"):
            mlp_kernel.fused_ln_linear_dual(x, *args, w8a8=w8a8, rows2=65)
    rect = _rect_inputs(cuda, [(14, 8)], per=2)
    with pytest.raises(ValueError, match="geometry"):
        sam_attention.fused_window_attention_rect(*rect, **_KW)
    # A rectangle, or a pair, the kernel is not built for.
    for geoms in ([(4, 14)], [(8, 8), (8, 8)]):
        other = _rect_inputs(cuda, geoms, per=2)
        geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
        for dots_i8 in (False, True):
            with pytest.raises(ValueError, match="not built for geometry"):
                sam_attention.fused_window_attention_rect(*other, **_KW, dots_i8=dots_i8,
                                                          geometry=geometry)
    # The int8 score form has its kernel now (`tests/test_torch_cuda_dots_i8.py`).
    got = sam_attention.fused_window_attention_rect(*rect, **_KW, dots_i8=True, geometry=(14, 8))
    ref = sam_attention.fused_window_attention_rect_plain(*rect, *_KW.values(), dots_i8=True)
    assert _row_rel_err(got, ref) <= _TOL
    y = _rand(cuda, 2, 196, 3 * _H * _HD)
    t = _rand(cuda, 2, 196, _H * _W)
    with pytest.raises(ValueError):
        sam_attention.fused_window_attention_grid(y, t, t, **_KW, total_rows=200)
    # More rows a window than the kernel's 13 tiles of 16 hold.
    y = _rand(cuda, 1, 224, 3 * _H * _HD)
    t = _rand(cuda, 1, 224, _H * _W)
    with pytest.raises(ValueError, match="at most 208 rows"):
        sam_attention.fused_window_attention_grid(y, t, t, **_KW, total_rows=224)


# Which bias term reaches only the pad positions of each single geometry,
# and its reversed columns there: the columns b >= 8 of the right edge and
# the corner (term Bb), the rows a >= 8 of the bottom edge (term A).
_PAD_ONLY_TERM = {(14, 8): 2, (8, 8): 2, (8, 14): 1}
_FORMS = pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])


@pytest.mark.cuda
@_FORMS
@pytest.mark.parametrize("geom", list(_PAD_ONLY_TERM), ids=["right", "corner", "bottom"])
def test_cuda_rect_attention_pad_key_row_max(cuda, geom, dots_i8):
    """Every row's largest score is a pad key's (unquantized in both forms):
    the term that reaches only pad positions raised by 8 / scale (8 in
    score units) on their columns."""
    args = list(_rect_inputs(cuda, [geom], per=3))
    t = args[_PAD_ONLY_TERM[geom]].reshape(*args[0].shape[:2], _H, _W)
    t[..., : _W - 8] += 8.0 / _KW["scale"]
    got = sam_attention.fused_window_attention_rect(*args, **_KW, dots_i8=dots_i8, geometry=geom)
    ref = sam_attention.fused_window_attention_rect_plain(*args, *_KW.values(), dots_i8=dots_i8)
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
@_FORMS
@pytest.mark.parametrize("geoms", [[(14, 8)], [(8, 8)], [(14, 8), (8, 14)]],
                         ids=["right", "corner", "dual"])
def test_cuda_rect_attention_one_window_six_heads(cuda, geoms, dots_i8):
    H = 6
    args = _rect_inputs(cuda, geoms, per=1, H=H)
    kw = dict(_KW, num_heads=H)
    geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
    got = sam_attention.fused_window_attention_rect(*args, **kw, dots_i8=dots_i8,
                                                    geometry=geometry)
    ref = sam_attention.fused_window_attention_rect_plain(*args, *kw.values(), dots_i8=dots_i8)
    assert got.shape == (len(geoms), geoms[0][0] * geoms[0][1], H * _HD)
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
@_FORMS
@pytest.mark.parametrize("n_first", [0, 1, 5, 6], ids=["none_first", "one_first", "five_first",
                                                       "all_first"])
def test_cuda_rect_attention_dual_split_off_half(cuda, n_first, dots_i8):
    """The dual-geometry kernel launched directly with `n_first` of its 6
    windows in the first geometry, against the plain version of each part
    with its half's tables."""
    geoms = [(14, 8), (8, 14)]
    y, a, bb, oh, pad_k, pad_v = _rect_inputs(cuda, geoms, per=3)
    N, T = y.shape[:2]
    out = torch.empty((N, T, _H * _HD), dtype=y.dtype, device=y.device)
    kernels.launch(
        "fused_window_attention_rect_i8" if dots_i8 else "fused_window_attention_rect",
        y.data_ptr(), a.data_ptr(), bb.data_ptr(), pad_k.data_ptr(), pad_v.data_ptr(),
        out.data_ptr(), N, _H, T, pad_k.shape[-2], n_first, *geoms[0], *geoms[1], _KW["scale"])
    parts = [(slice(0, n_first), 0), (slice(n_first, N), 1)]
    ref = torch.cat([sam_attention.fused_window_attention_rect_plain(
        y[sl], a[sl], bb[sl], oh[i], pad_k[i], pad_v[i], *_KW.values(), dots_i8=dots_i8)
        for sl, i in parts if sl.start < sl.stop])
    assert _row_rel_err(out, ref) <= _TOL
