"""On the card: the hd 64 forms (ViT-L's and ViT-B's heads) of the SAM
attention kernels against their plain PyTorch versions, in bf16, at the
shapes of one ViT-L or ViT-B image: the window kernel on 16 full windows
(196 rows, and 200 as the resident layout stores them beside composite
bias weights), the boundary-window kernel on the merged edges and the
corner, each in both score forms (`dots_i8`); the global kernel in both
exponential forms; the lane-sliced global kernel at 16 and 12 heads in
both score and exponential forms, with its int8 pre-pass bit for bit;
the packed kernels at hp 128 over 64 real lanes. The forms that no SAM
configuration reaches raise ValueError naming themselves. Every test here
needs an NVIDIA GPU and skips without one, and has a time limit
(`_LIMIT_S`): a kernel that hangs ends the run with every thread's
traceback. The file imports torch only, so it runs on a machine that has
no JAX:

    python -m pytest tests/test_torch_cuda_sam_hd64.py -q

Gate: bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there); the bf16-exponential forms of the global kernels 2e-2, since
their rounding follows the running maximum and so the key tiling. The
int8 score forms take the limits of their hd 80 forms
(`test_torch_cuda_dots_i8.py`): 1e-2, and 2e-2 with bf16 exponentials.
"""

import faulthandler
import sys

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import sam_attention

_TOL = 1e-2
_H, _HD, _W, _G = 16, 64, 14, 64
_SC = _HD**-0.5
_KW = dict(num_heads=_H, head_dim=_HD, window=_W, scale=_SC)


# Seconds a test may take, its kernels' first build included.
_LIMIT_S = 300


@pytest.fixture(autouse=True)
def _time_limit():
    faulthandler.dump_traceback_later(_LIMIT_S, exit=True, file=sys.__stderr__)
    yield
    faulthandler.cancel_dump_traceback_later()


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


def _launched(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])
@pytest.mark.parametrize("rows", [196, 200])
def test_cuda_window_grid_hd64_matches_plain(cuda, rows, dots_i8):
    y = _rand(cuda, 16, rows, 3 * _H * _HD)
    a, bb = (_rand(cuda, 16, rows, _H * _W, scale=2.0 / _SC) for _ in range(2))
    got = _launched("fused_window_attention_grid" + ("_i8" if dots_i8 else "") + "_hd64",
                    lambda: sam_attention.fused_window_attention_grid(
                        y, a, bb, **_KW, total_rows=rows if rows != 196 else 0, dots_i8=dots_i8))
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, _H, _HD, _W, _SC, dots_i8)
    assert got.shape == (16, rows, _H * _HD)
    assert _row_rel_err(got[:, :196], ref[:, :196]) <= _TOL
    assert torch.isfinite(got.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])
@pytest.mark.parametrize("geoms", [[(14, 8), (8, 14)], [(14, 8)], [(8, 14)], [(8, 8)]],
                         ids=["edge_pair", "right", "bottom", "corner"])
def test_cuda_window_rect_hd64_matches_plain(cuda, geoms, dots_i8):
    per = 4
    qkv_bias = _rand(cuda, 3 * _H * _HD, scale=0.5)
    ohs = [image_encoder._rect_onehot(r, c, _W, torch.bfloat16, "cuda") for r, c in geoms]
    pads = [image_encoder._pad_tables(qkv_bias, r, c, _W, _H, _HD, torch.bfloat16)
            for r, c in geoms]
    if len(geoms) == 1:
        tables, geometry = (ohs[0], *pads[0]), geoms[0]
    else:
        tables = (torch.stack(ohs), torch.stack([k for k, _ in pads]),
                  torch.stack([v for _, v in pads]))
        geometry = tuple(geoms)
    T = geoms[0][0] * geoms[0][1]
    N = per * len(geoms)
    y = _rand(cuda, N, T, 3 * _H * _HD)
    a, bb = (_rand(cuda, N, T, _H * _W, scale=2.0 / _SC) for _ in range(2))
    got = _launched("fused_window_attention_rect" + ("_i8" if dots_i8 else "") + "_hd64",
                    lambda: sam_attention.fused_window_attention_rect(
                        y, a, bb, *tables, **_KW, dots_i8=dots_i8, geometry=geometry))
    ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, _H, _HD, _W, _SC,
                                                          dots_i8)
    assert _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("exp_bf16,tol", [(False, 1e-2), (True, 2e-2)])
def test_cuda_global_hd64_matches_plain(cuda, exp_bf16, tol):
    N, S = 16, _G * _G
    q, k, v = (_rand(cuda, N, S, _HD) for _ in range(3))
    rel_h, rel_w = (_rand(cuda, 2 * _G - 1, _HD, scale=0.25) for _ in range(2))
    a, bb = (t.reshape(N, S, _G).to(torch.bfloat16) for t in sam_attention.decomposed_bias_terms(
        q.reshape(1, N, _G, _G, _HD), rel_h, rel_w, _G))
    got = _launched("fused_global_attention_hd64", lambda: sam_attention.fused_global_attention(
        q, k, v, a, bb, _G, _SC, exp_bf16=exp_bf16))
    ref = sam_attention.fused_global_attention_plain(q, k, v, a, bb, _G, _SC, exp_bf16=exp_bf16)
    assert _row_rel_err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])
@pytest.mark.parametrize("exp_bf16,tol", [(False, 1e-2), (True, 2e-2)])
@pytest.mark.parametrize("H,hg", [(16, 16), (12, 4)], ids=["vit_l", "vit_b"])
def test_cuda_global_y_hd64_matches_plain(cuda, H, hg, exp_bf16, tol, dots_i8):
    S = _G * _G
    y = _rand(cuda, 1, S, 3 * H * _HD)
    a, bb = (_rand(cuda, 1, S, H, _G, scale=2.0 / _SC) for _ in range(2))
    kw = dict(num_heads=H, head_dim=_HD, window=_G, scale=_SC, exp_bf16=exp_bf16,
              dots_i8=dots_i8)
    name = "fused_global_attention_y" + ("_i8" if dots_i8 else "") + "_hd64"
    got = _launched(name, lambda: sam_attention.fused_global_attention_y(
        y, a, bb, head_group=hg, **kw))
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw)
    assert _row_rel_err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 12], ids=["vit_l", "vit_b"])
def test_cuda_global_y_quant_i8_hd64_bit_equal_to_plain(cuda, H):
    S = _G * _G
    y = _rand(cuda, 1, S, 3 * H * _HD)
    a, bb = (_rand(cuda, 1, S, H, _G, scale=2.0 / _SC) for _ in range(2))
    a[0, 0, 0] = 0.0  # an all-zero [A | B] half: the rest of the row sets the scale
    got = _launched("global_attention_y_quant_i8_hd64",
                    lambda: sam_attention.global_y_quant_i8(y, a, bb, H, _HD))
    ref = sam_attention.global_y_quant_i8_plain(y, a, bb, H, _HD)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert not got[0][..., _HD:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 12], ids=["vit_l", "vit_b"])
@pytest.mark.parametrize("name,N,Wn", [("fused_window_attention_packed", 25, _W),
                                       ("fused_global_attention_packed", 1, _G)],
                         ids=["window", "global"])
def test_cuda_packed_hd64_matches_plain(cuda, H, name, N, Wn):
    """K19 and K20 at hp 128 over ViT-L's and ViT-B's 64 real lanes (pad
    lanes zero as the packed weights make them), the scale from hd 64;
    both told their real lanes (`head_dim`), against the plain version
    over all 128."""
    hp, S = 128, Wn * Wn
    y = torch.zeros((N, S, 3, H, hp), dtype=torch.bfloat16, device="cuda")
    y[..., :_HD] = _rand(cuda, N, S, 3, H, _HD)
    y = y.reshape(N, S, 3 * H * hp)
    a, bb = (_rand(cuda, N, H, S, Wn, scale=2.0) for _ in range(2))
    got = _launched(name, lambda: getattr(sam_attention, name)(y, a, bb, H, hp, Wn, _SC,
                                                               head_dim=_HD))
    ref = getattr(sam_attention, f"{name}_plain")(y, a, bb, H, hp, Wn, _SC)
    assert _row_rel_err(got, ref) <= _TOL
    assert torch.all(got.reshape(N, S, H, hp)[..., _HD:] == 0)


@pytest.mark.cuda
def test_cuda_sam_forms_no_configuration_reaches_raise(cuda):
    """Window kernels at a window other than 14 and a head dim outside
    {64, 80}, and packed int8 qkv/proj at a global block of the fused int8
    route: ValueError, each naming the form."""
    with pytest.raises(ValueError, match="W 14 and hd 80 or 64; got hd 96"):
        sam_attention.fused_window_attention_grid(
            _rand(cuda, 2, 196, 3 * 8 * 96), _rand(cuda, 2, 196, 8 * _W),
            _rand(cuda, 2, 196, 8 * _W), num_heads=8, head_dim=96, window=_W, scale=96**-0.5)
    W16 = 16
    with pytest.raises(ValueError, match="W 14 and hd 80 or 64; got hd 64, W 16"):
        sam_attention.fused_window_attention_grid(
            _rand(cuda, 2, W16 * W16, 3 * _H * _HD), _rand(cuda, 2, W16 * W16, _H * W16),
            _rand(cuda, 2, W16 * W16, _H * W16), **{**_KW, "window": W16}, dots_i8=True)
    with pytest.raises(ValueError, match="dots_i8 pre-pass is built for hd 80 or 64"):
        yb = _rand(cuda, 1, _G * _G, 3 * 4 * 32)
        ab = _rand(cuda, 1, _G * _G, 4, _G)
        sam_attention.global_y_quant_i8(yb, ab, ab, 4, 32)
    cfg = image_encoder.SamVisionConfig(img_size=1024, patch_size=16, embed_dim=128, depth=1,
                                        num_heads=2, out_chans=16, window_size=14,
                                        global_attn_indexes=(0,))
    blk = {"qkv": {"q": torch.zeros((128, 3 * 2 * 128), dtype=torch.int8, device="cuda"),
                   "scale": torch.ones(3 * 2 * 128, device="cuda")},
           "proj": {"q": torch.zeros((2 * 128, 128), dtype=torch.int8, device="cuda"),
                    "scale": torch.ones(128, device="cuda")}}
    with pytest.raises(ValueError, match="packed int8 qkv/proj weights at a global block"):
        image_encoder._block(torch.zeros((1, 64, 64, 128), dtype=torch.bfloat16, device="cuda"),
                             blk, cfg, window=False)
