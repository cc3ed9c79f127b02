"""On the card: the hd 64 forms of K3 (the grid window kernel, both
score forms at 196 and 200 rows a window, its probabilities by
ex2.approx and one multiply), and the B=1 schedules of K14 (the
boundary-window kernel: one warp a 16-row query tile, the pad keys' sums
in closed form) and K11 (the lane-sliced global kernel: the scores in q.k
units with one fma a score, the bf16 exponentials' row sums by the ones
column of P V, the `dots_i8` codes held as bf16 with the row's q scale in
the exponent's factor) and K4 (the head-major global kernel at hd 64, on
the same arithmetic with three consumer warpgroups on 192-row query
tiles, the last one of an (image, head) 64 rows) against their plain
PyTorch versions at ViT-L's 16 heads and ViT-B's 12, every boundary
geometry, one window of each class up to a batch of 16, one and two
images; each mechanism's deliberate bug (`-DULLAVA_MUTANT_*`) caught by
the same comparison; and the launches of `SamPredictor.set_image` at
ViT-L's and ViT-B's widths (four blocks) in bf16 and packed, exactly as
its blocks say. Every test here needs an NVIDIA GPU and skips without
one, and has a time limit (`_LIMIT_S`): a kernel that hangs, as a wrong
barrier order does, ends the run with every thread's traceback. The file
imports torch only:

    python -m pytest tests/test_torch_cuda_sam_b1.py -q

Gate: `test_torch_cuda_sam_hd64.py`'s: 1e-2 of each row's largest value,
2e-2 with bf16 exponentials; the pre-pass bit for bit.
"""

import dataclasses
import faulthandler
import sys

import numpy as np
import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import build, image_encoder, predictor
from ullava_tpu_torch.ops import sam_attention

_HD, _W, _G = 64, 14, 64
_SC = _HD**-0.5
_GEOMS = {"edge_pair": [(14, 8), (8, 14)], "right": [(14, 8)], "bottom": [(8, 14)],
          "corner": [(8, 8)]}


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
    return torch.Generator(device="cuda").manual_seed(1)


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _rect_case(gen, H, geoms, per):
    """`per` windows of each geometry at H heads of 64: (y, a, b, tables,
    geometry) as the encoder hands them to the kernel."""
    qkv_bias = _rand(gen, 3 * H * _HD, scale=0.5)
    ohs = [image_encoder._rect_onehot(r, c, _W, torch.bfloat16, "cuda") for r, c in geoms]
    pads = [image_encoder._pad_tables(qkv_bias, r, c, _W, H, _HD, torch.bfloat16)
            for r, c in geoms]
    if len(geoms) == 1:
        tables, geometry = (ohs[0], *pads[0]), geoms[0]
    else:
        tables = (torch.stack(ohs), torch.stack([k for k, _ in pads]),
                  torch.stack([v for _, v in pads]))
        geometry = tuple(geoms)
    T, N = geoms[0][0] * geoms[0][1], per * len(geoms)
    y = _rand(gen, N, T, 3 * H * _HD)
    a, bb = (_rand(gen, N, T, H * _W, scale=2.0 / _SC) for _ in range(2))
    return y, a, bb, tables, geometry


def _rect(H, dots_i8, y, a, bb, tables, geometry):
    return sam_attention.fused_window_attention_rect(
        y, a, bb, *tables, num_heads=H, head_dim=_HD, window=_W, scale=_SC, dots_i8=dots_i8,
        geometry=geometry)


@pytest.mark.cuda
@pytest.mark.parametrize("per", [1, 4, 16])
@pytest.mark.parametrize("geo", list(_GEOMS))
@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])
@pytest.mark.parametrize("H", [16, 12], ids=["vit_l", "vit_b"])
def test_cuda_rect_hd64_b1_matches_plain(cuda, H, dots_i8, geo, per):
    y, a, bb, tables, geometry = _rect_case(cuda, H, _GEOMS[geo], per)
    name = "fused_window_attention_rect" + ("_i8" if dots_i8 else "") + "_hd64"
    before = kernels.launch_counts()[name]
    got = _rect(H, dots_i8, y, a, bb, tables, geometry)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, H, _HD, _W, _SC,
                                                          dots_i8)
    assert _row_rel_err(got, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("geo", ["edge_pair", "corner"])
def test_cuda_rect_hd64_b1_attrs(cuda, geo):
    """One warp a 16-row tile: 7 for the edges' 112 rows, 4 for the
    corner's 64; two blocks an SM, the register limit that gives (the
    `dots_i8` edges spill 8 bytes a thread under it, and ran slower at one
    block an SM with 159 registers)."""
    geoms = _GEOMS[geo]
    for i8 in (0, 1):
        attrs = kernels.kernel_attrs("sam_rect_attention.cu",
                                     "ullava_window_attention_rect_hd64_attrs", i8, *geoms[0],
                                     *geoms[-1])
        assert attrs["spill_bytes"] <= 8 and attrs["blocks_per_sm"] >= 2, attrs


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])
@pytest.mark.parametrize("exp_bf16,tol", [(False, 1e-2), (True, 2e-2)])
@pytest.mark.parametrize("H", [16, 12], ids=["vit_l", "vit_b"])
def test_cuda_global_y_hd64_b1_matches_plain(cuda, H, exp_bf16, tol, dots_i8, B):
    S = _G * _G
    y = _rand(cuda, B, S, 3 * H * _HD)
    a, bb = (_rand(cuda, B, S, H, _G, scale=2.0 / _SC) for _ in range(2))
    kw = dict(num_heads=H, head_dim=_HD, window=_G, scale=_SC, exp_bf16=exp_bf16,
              dots_i8=dots_i8)
    got = sam_attention.fused_global_attention_y(y, a, bb, **kw)
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw)
    assert _row_rel_err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 12], ids=["vit_l", "vit_b"])
def test_cuda_global_y_quant_i8_hd64_bf16_codes(cuda, H):
    S = _G * _G
    y = _rand(cuda, 2, S, 3 * H * _HD)
    a, bb = (_rand(cuda, 2, S, H, _G, scale=2.0 / _SC) for _ in range(2))
    got = sam_attention.global_y_quant_i8(y, a, bb, H, _HD)
    assert got[0].shape == (2, 2, H, S, _HD) and got[0].dtype == torch.bfloat16
    ref = sam_attention.global_y_quant_i8_plain(y, a, bb, H, _HD)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 32, 17, 1], ids=["one_image", "two_images", "odd_17", "one"])
@pytest.mark.parametrize("rows", [196, 200])
@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])
@pytest.mark.parametrize("H", [16, 12], ids=["vit_l", "vit_b"])
def test_cuda_grid_hd64_b1_matches_plain(cuda, H, dots_i8, rows, N):
    """N windows of `rows` (200: the resident layout's pad rows, zero bias
    terms as `_assemble_bias_terms` makes them; finite, dropped by the
    caller) against the plain version over the 196 real rows."""
    y, a, bb = _grid_case(cuda, H, N, rows)
    name = "fused_window_attention_grid" + ("_i8" if dots_i8 else "") + "_hd64"
    before = kernels.launch_counts()[name]
    got = _grid(H, dots_i8, y, a, bb)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, H, _HD, _W, _SC, dots_i8)
    assert _row_rel_err(got[:, :196], ref[:, :196]) <= 1e-2
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_cuda_grid_hd64_b1_attrs(cuda):
    """4 warps a (window, head), two blocks an SM, at most 8 bytes spilled
    a thread."""
    for i8 in (0, 1):
        attrs = kernels.kernel_attrs("sam_window_attention.cu",
                                     "ullava_window_attention_grid_hd64_attrs", i8)
        assert attrs["blocks_per_sm"] >= 2 and attrs["spill_bytes"] <= 8, attrs


def _grid_case(gen, H, N, rows):
    y = _rand(gen, N, rows, 3 * H * _HD)
    a, bb = (_rand(gen, N, rows, H * _W, scale=2.0 / _SC) for _ in range(2))
    a[:, 196:], bb[:, 196:] = 0, 0
    return y, a, bb


def _grid(H, dots_i8, y, a, bb):
    rows = y.shape[1]
    return sam_attention.fused_window_attention_grid(
        y, a, bb, H, _HD, _W, _SC, total_rows=0 if rows == 196 else rows, dots_i8=dots_i8)


_GRID_BUGS = ["ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX", "ULLAVA_MUTANT_I8_TILE_SCALE"]


@pytest.mark.cuda
@pytest.mark.parametrize("dots_i8,define", [(False, _GRID_BUGS[0])] +
                         [(True, d) for d in _GRID_BUGS])
def test_cuda_grid_hd64_b1_mutants_caught(cuda, dots_i8, define):
    y, a, bb = _grid_case(cuda, 16, 16, 200 if dots_i8 else 196)
    ref = sam_attention.fused_window_attention_grid_plain(y, a, bb, 16, _HD, _W, _SC, dots_i8)
    with kernels.mutant("sam_window_attention.cu", define):
        got = _grid(16, dots_i8, y, a, bb)
    assert _row_rel_err(got[:, :196], ref[:, :196]) > 1e-2


_RECT_BUGS = ["ULLAVA_MUTANT_RECT_TILE_BIAS_ROWS", "ULLAVA_MUTANT_RECT_PAD_SUM_NO_QUAD"]
_GLOBAL_BUGS = [("ULLAVA_MUTANT_GLOBAL_B1_B_PAIR", False), ("ULLAVA_MUTANT_GLOBAL_ONES_FIRST_KSTEP", False),
                ("ULLAVA_MUTANT_GLOBAL_B1_QS_UNFOLDED", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("define", _RECT_BUGS)
@pytest.mark.parametrize("geo", ["edge_pair", "corner"])
def test_cuda_rect_hd64_b1_mutants_caught(cuda, geo, define):
    y, a, bb, tables, geometry = _rect_case(cuda, 16, _GEOMS[geo], 4)
    for dots_i8 in (False, True):
        ref = sam_attention.fused_window_attention_rect_plain(y, a, bb, *tables, 16, _HD, _W,
                                                              _SC, dots_i8)
        with kernels.mutant("sam_rect_attention.cu", define):
            got = _rect(16, dots_i8, y, a, bb, tables, geometry)
        assert _row_rel_err(got, ref) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("define,dots_i8", _GLOBAL_BUGS)
def test_cuda_global_y_hd64_b1_mutants_caught(cuda, define, dots_i8):
    S, H = _G * _G, 16
    y = _rand(cuda, 1, S, 3 * H * _HD)
    a, bb = (_rand(cuda, 1, S, H, _G, scale=2.0 / _SC) for _ in range(2))
    kw = dict(num_heads=H, head_dim=_HD, window=_G, scale=_SC, exp_bf16=True, dots_i8=dots_i8)
    ref = sam_attention.fused_global_attention_y_plain(y, a, bb, **kw)
    with kernels.mutant("sam_global_attention_y.cu", define):
        got = sam_attention.fused_global_attention_y(y, a, bb, **kw)
    assert _row_rel_err(got, ref) > 2e-2


def _after_nan_fill(run, shape):
    """`run()` on an output block the caching allocator hands back right
    after it was filled with NaN (asserted): rows a kernel leaves unwritten
    read NaN."""
    junk = torch.full(shape, float("nan"), dtype=torch.bfloat16, device="cuda")
    ptr = junk.data_ptr()
    del junk
    out = run()
    assert out.data_ptr() == ptr
    return out


def _k4_case(gen, N):
    """K4's inputs at N (image, head) pairs of hd 64: the bias terms from
    `decomposed_bias_terms` of the unscaled q, as the encoder makes them."""
    S = _G * _G
    q, k, v = (_rand(gen, N, S, _HD) for _ in range(3))
    rel_h, rel_w = (_rand(gen, 2 * _G - 1, _HD, scale=0.25) for _ in range(2))
    a, bb = (t.reshape(N, S, _G).to(torch.bfloat16) for t in sam_attention.decomposed_bias_terms(
        q.reshape(1, N, _G, _G, _HD), rel_h, rel_w, _G))
    return q, k, v, a, bb


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 12, 32, 1], ids=["vit_l", "vit_b", "two_images", "one"])
@pytest.mark.parametrize("exp_bf16,tol", [(False, 1e-2), (True, 2e-2)])
def test_cuda_global_hd64_b1_matches_plain(cuda, exp_bf16, tol, N):
    """K4 at hd 64 on the three-warpgroup schedule, into an output block
    just filled with NaN: every row written, one launch."""
    q, k, v, a, bb = _k4_case(cuda, N)
    before = kernels.launch_counts()["fused_global_attention_hd64"]
    got = _after_nan_fill(lambda: sam_attention.fused_global_attention(
        q, k, v, a, bb, _G, _SC, exp_bf16=exp_bf16), tuple(q.shape))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_global_attention_hd64"] == before + 1
    ref = sam_attention.fused_global_attention_plain(q, k, v, a, bb, _G, _SC, exp_bf16=exp_bf16)
    assert _row_rel_err(got, ref) <= tol


@pytest.mark.cuda
def test_cuda_global_hd64_b1_attrs(cuda):
    """512 threads (three consumer warpgroups), one block an SM, nothing
    spilled, in both exponential forms."""
    for e in (0, 1):
        attrs = kernels.kernel_attrs("sam_global_attention.cu",
                                     "ullava_fused_global_attention_hd64_attrs", e)
        assert attrs["blocks_per_sm"] == 1 and attrs["spill_bytes"] == 0, (e, attrs)


_K4_BUGS = [(d, e) for d in ("ULLAVA_MUTANT_GLOBAL_B1_B_PAIR",
                             "ULLAVA_MUTANT_GLOBAL_TAIL_ROWS_SHIFTED",
                             "ULLAVA_MUTANT_GLOBAL_A_ONE_ROW", "ULLAVA_MUTANT_GLOBAL_BIAS_RAW")
            for e in (False, True)] + [("ULLAVA_MUTANT_GLOBAL_ONES_FIRST_KSTEP", True)]


@pytest.fixture(scope="module")
def k4_mutants():
    """Every mutant copy of K4's source this file gates, built at once."""
    if torch.cuda.is_available():
        kernels.build_all(mutants=[("sam_global_attention.cu", d) for d in {d for d, _ in _K4_BUGS}])


@pytest.mark.cuda
@pytest.mark.parametrize("define,exp_bf16", _K4_BUGS)
def test_cuda_global_hd64_b1_mutants_caught(cuda, k4_mutants, define, exp_bf16):
    q, k, v, a, bb = _k4_case(cuda, 16)
    ref = sam_attention.fused_global_attention_plain(q, k, v, a, bb, _G, _SC, exp_bf16=exp_bf16)
    with kernels.mutant("sam_global_attention.cu", define):
        got = _after_nan_fill(lambda: sam_attention.fused_global_attention(
            q, k, v, a, bb, _G, _SC, exp_bf16=exp_bf16), tuple(q.shape))
    assert not _row_rel_err(got, ref) <= (2e-2 if exp_bf16 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "packed"])
@pytest.mark.parametrize("size", ["vit_l", "vit_b"])
def test_cuda_predictor_launches_exact(cuda, size, weights):
    """`set_image` on a 480 x 640 image at full width, cut to two groups of
    a window and a global block: the bf16 weights (the resident layout)
    launch K3 once and K14 three times a window block and K4 once a global
    block; packed weights K19 once a window block and K20 once a global
    block; nothing else. The embedding is finite."""
    cfg = getattr(build, f"sam_{size}")(torch.bfloat16)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, depth=4, global_attn_indexes=(1, 3)))
    params = build.init_sam_params(cfg, cuda, "cuda")
    if weights == "packed":
        params["image_encoder"] = image_encoder.pack_sam_attention(params["image_encoder"],
                                                                  cfg.vision)
    pred = predictor.SamPredictor(params, cfg, device="cuda")
    image = np.random.default_rng(30).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    pred.set_image(image)  # first call: builds, attributes
    before = kernels.launch_counts()
    pred.set_image(image)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    if weights == "packed":
        assert ran == {"fused_window_attention_packed": 2, "fused_global_attention_packed": 2}
    else:
        assert ran == {"fused_window_attention_grid_hd64": 2, "fused_window_attention_rect_hd64": 6,
                       "fused_global_attention_hd64": 2}
    assert bool(torch.isfinite(pred._embedding).all())
