"""On the card: the hd 64 forms (ViT-L's and ViT-B's heads) of the SAM
attention kernels against their plain PyTorch versions, in bf16, at the
shapes of one ViT-L image: the window kernel on 16 full windows (196 rows,
and 200 as the resident layout stores them beside composite bias
weights), the boundary-window kernel on the merged edges and the corner,
the global kernel in both exponential forms, and the lane-sliced global
kernel at 16 heads. The forms that are not built raise ValueError. Every
test here needs an NVIDIA GPU and skips without one. The file imports
torch only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_sam_hd64.py -q

Gate: bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there); the bf16-exponential forms of the global kernels 2e-2, since
their rounding follows the running maximum and so the key tiling.
"""

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import sam_attention

_TOL = 1e-2
_H, _HD, _W, _G = 16, 64, 14, 64
_SC = _HD**-0.5
_KW = dict(num_heads=_H, head_dim=_HD, window=_W, scale=_SC)


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
@pytest.mark.parametrize("rows", [196, 200])
def test_cuda_window_grid_hd64_matches_plain(cuda, rows):
    y = _rand(cuda, 16, rows, 3 * _H * _HD)
    a, bb = (_rand(cuda, 16, rows, _H * _W, scale=2.0 / _SC) for _ in range(2))
    got = _launched("fused_window_attention_grid_hd64",
                    lambda: sam_attention.fused_window_attention_grid(
                        y, a, bb, **_KW, total_rows=rows if rows != 196 else 0))
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, _H, _HD, _W, _SC)
    assert got.shape == (16, rows, _H * _HD)
    assert _row_rel_err(got[:, :196], ref[:, :196]) <= _TOL
    assert torch.isfinite(got.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("geoms", [[(14, 8), (8, 14)], [(14, 8)], [(8, 14)], [(8, 8)]],
                         ids=["edge_pair", "right", "bottom", "corner"])
def test_cuda_window_rect_hd64_matches_plain(cuda, geoms):
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
    got = _launched("fused_window_attention_rect_hd64",
                    lambda: sam_attention.fused_window_attention_rect(
                        y, a, bb, *tables, **_KW, geometry=geometry))
    ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, _H, _HD, _W, _SC)
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
@pytest.mark.parametrize("exp_bf16,tol", [(False, 1e-2), (True, 2e-2)])
def test_cuda_global_y_hd64_matches_plain(cuda, exp_bf16, tol):
    S = _G * _G
    y = _rand(cuda, 1, S, 3 * _H * _HD)
    a, bb = (_rand(cuda, 1, S, _H, _G, scale=2.0 / _SC) for _ in range(2))
    kw = dict(num_heads=_H, head_dim=_HD, window=_G, scale=_SC, exp_bf16=exp_bf16)
    got = _launched("fused_global_attention_y_hd64",
                    lambda: sam_attention.fused_global_attention_y(y, a, bb, head_group=16, **kw))
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw)
    assert _row_rel_err(got, ref) <= tol


@pytest.mark.cuda
def test_cuda_hd64_forms_not_built_raise(cuda):
    y = _rand(cuda, 2, 196, 3 * _H * _HD)
    a = _rand(cuda, 2, 196, _H * _W)
    with pytest.raises(ValueError, match="dots_i8"):
        sam_attention.fused_window_attention_grid(y, a, a, **_KW, dots_i8=True)
    with pytest.raises(ValueError, match="hd 80 or 64"):
        sam_attention.fused_window_attention_grid(
            _rand(cuda, 2, 196, 3 * 8 * 96), _rand(cuda, 2, 196, 8 * _W),
            _rand(cuda, 2, 196, 8 * _W), num_heads=8, head_dim=96, window=_W, scale=96**-0.5)
    H12 = 12
    yb = _rand(cuda, 1, _G * _G, 3 * H12 * _HD)
    ab = _rand(cuda, 1, _G * _G, H12, _G)
    with pytest.raises(ValueError, match="head group"):
        sam_attention.fused_global_attention_y(yb, ab, ab, num_heads=H12, head_dim=_HD,
                                               window=_G, scale=_SC, head_group=4)
    with pytest.raises(ValueError, match="dots_i8 pre-pass"):
        sam_attention.global_y_quant_i8(yb, ab, ab, H12, _HD)
