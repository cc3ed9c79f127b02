"""On the card: the CUDA kernels of the SAM packed attention layout and the
two kernels no path calls, against their plain PyTorch versions in bf16:
the packed window kernel (hp 128, W 14) and the packed global kernel (hp
128, W 64), each over its 80 or 64 real lanes (the pad lanes of its
output zero on a block just filled with NaN, its attributes, its
deliberate bugs caught), the per-(window, head) window kernel (hd 80, W 14; also at one
ViT-H B=4 window block and against the grid window kernel on the same
windows) and the decode attention over the int8 cache that writes nothing
(LLaMA-7B's head width, ragged kv_lens, GQA, and a long cache split over
a cluster of blocks, with a uniform row); then a small packed encoder
against the same weights unpacked. Every test here needs an NVIDIA GPU and skips without
one, and has a time limit (`_LIMIT_S`): a kernel that hangs, as a wrong
barrier order does, ends the run with every thread's traceback. The file
imports torch only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_packed.py -q

Gates: bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there is at most 2^-7 of it); the packed encoder within 5e-2 of the
largest embedding value of the unpacked one (both bf16 through two blocks
and the neck, rounding at different points: the unpacked window kernel
pre-scales the bias terms to bf16, the packed ones add them raw after the
scale).
"""

import dataclasses
import faulthandler
import sys

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import decode_attention, sam_attention

_TOL = 1e-2
_H, _HD, _HP = 16, 80, 128


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


def _packed_y(gen, N, W, H=_H, hd=_HD):
    """A packed qkv projection output: hd real lanes of each 128, the pad
    lanes zero as `pack_sam_attention`'s weights make them."""
    y = torch.zeros((N, W * W, 3, H, _HP), dtype=torch.bfloat16, device="cuda")
    y[..., :hd] = _rand(gen, N, W * W, 3, H, hd)
    return y.reshape(N, W * W, 3 * H * _HP)


def _after_nan_fill(run, shape):
    """`run()` on an output block the caching allocator hands back right
    after it was filled with NaN (asserted)."""
    junk = torch.full(shape, float("nan"), dtype=torch.bfloat16, device="cuda")
    ptr = junk.data_ptr()
    del junk
    out = run()
    assert out.data_ptr() == ptr
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("W,N", [(14, 12), (14, 100), (64, 1), (64, 3)],
                         ids=["window", "window_n100", "global", "global_b3"])
def test_cuda_packed_attention_matches_plain(cuda, W, N):
    y = _packed_y(cuda, N, W)
    a, b = (_rand(cuda, N, _H, W * W, W, scale=2.0) for _ in range(2))
    kw = dict(num_heads=_H, head_pad=_HP, window=W, scale=_HD**-0.5, head_dim=_HD)
    fn, plain = ((sam_attention.fused_window_attention_packed,
                  sam_attention.fused_window_attention_packed_plain) if W == 14 else
                 (sam_attention.fused_global_attention_packed,
                  sam_attention.fused_global_attention_packed_plain))
    name = fn.__name__
    before = kernels.launch_counts()[name]
    got = fn(y, a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = plain(y, a, b, _H, _HP, W, _HD**-0.5)
    assert _row_rel_err(got, ref) <= _TOL
    assert torch.all(got.reshape(N, W * W, _H, _HP)[..., _HD:] == 0)
    assert _row_rel_err(fn(y, b, a, **kw), ref) > _TOL  # the bias terms count


_PACKED_SRC = "sam_packed_attention.cu"
# K19's deliberate bugs: its real lanes' two and the window core's.
_PACKED_BUGS = ["ULLAVA_MUTANT_PACKED_PAD_LANES_UNWRITTEN", "ULLAVA_MUTANT_PACKED_K_ACROSS_BLOCK",
                "ULLAVA_MUTANT_PACKED_BIAS_PRESCALED", "ULLAVA_MUTANT_PACKED_HEAD_OFFSET",
                "ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX"]
# K20's: the real lanes' two, the after-scale form's, the global core's A
# term; at hd 64 the three-warpgroup B1 schedule's B pair and short last
# query tile.
_GLOBAL_BUGS = ["ULLAVA_MUTANT_PACKED_PAD_LANES_UNWRITTEN", "ULLAVA_MUTANT_PACKED_K_ACROSS_BLOCK",
                "ULLAVA_MUTANT_PACKED_BIAS_PRESCALED", "ULLAVA_MUTANT_PACKED_HEAD_OFFSET",
                "ULLAVA_MUTANT_GLOBAL_A_ONE_ROW"]
_GLOBAL_HD64_BUGS = ["ULLAVA_MUTANT_GLOBAL_B1_B_PAIR", "ULLAVA_MUTANT_GLOBAL_TAIL_ROWS_SHIFTED"]


@pytest.fixture(scope="module")
def packed_mutants():
    """Every mutant copy of the packed source this file gates, built at
    once (one nvcc each, in parallel)."""
    if torch.cuda.is_available():
        kernels.build_all(mutants=[(_PACKED_SRC, d) for d in
                                   {*_PACKED_BUGS, *_GLOBAL_BUGS, *_GLOBAL_HD64_BUGS}])


def _packed_window_case(gen, N, H, hd):
    y = _packed_y(gen, N, 14, H, hd)
    a, b = (_rand(gen, N, H, 196, 14, scale=2.0) for _ in range(2))
    run = lambda: sam_attention.fused_window_attention_packed(  # noqa: E731
        y, a, b, H, _HP, 14, hd**-0.5, head_dim=hd)
    ref = sam_attention.fused_window_attention_packed_plain(y, a, b, H, _HP, 14, hd**-0.5,
                                                            head_dim=hd)
    return run, ref


@pytest.mark.cuda
@pytest.mark.parametrize("H,hd,N", [(16, 64, 25), (12, 64, 25), (16, 64, 3), (12, 64, 1),
                                    (16, 80, 100), (16, 80, 7)],
                         ids=["vit_l", "vit_b", "vit_l_n3", "vit_b_n1", "vit_h_b4", "vit_h_n7"])
def test_cuda_packed_window_real_lanes_matches_plain(cuda, H, hd, N):
    """K19 over its real lanes against its plain version (which equals the
    all-lanes one on these zero pad lanes), into an output block just
    filled with NaN: the pad lanes come out exactly zero."""
    run, ref = _packed_window_case(cuda, N, H, hd)
    got = _after_nan_fill(run, (N, 196, H * _HP))
    torch.cuda.synchronize()
    assert _row_rel_err(got, ref) <= _TOL
    assert torch.all(got.reshape(N, 196, H, _HP)[..., hd:] == 0)


@pytest.mark.cuda
def test_cuda_packed_window_refuses_other_head_dims(cuda):
    y = _packed_y(cuda, 1, 14)
    a, b = (_rand(cuda, 1, _H, 196, 14) for _ in range(2))
    for hd in (128, 96, 32):  # no instance: refused, never the plain version
        with pytest.raises(ValueError, match="head_dim"):
            sam_attention.fused_window_attention_packed(y, a, b, _H, _HP, 14, 0.1, head_dim=hd)
    with pytest.raises(ValueError, match="head_dim"):
        sam_attention.fused_window_attention_packed(y, a, b, _H, _HP, 14, 0.1)


@pytest.mark.cuda
def test_cuda_packed_window_attrs(cuda):
    """K3's 4-warp schedule at both head widths: two blocks an SM, spills
    no more than the old 128-lane kernel's 24 bytes."""
    for hd in (64, 80):
        attrs = kernels.kernel_attrs(_PACKED_SRC, "ullava_window_attention_packed_attrs", hd)
        assert attrs["blocks_per_sm"] >= 2 and attrs["spill_bytes"] <= 24, (hd, attrs)


@pytest.mark.cuda
@pytest.mark.parametrize("define", _PACKED_BUGS)
@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80"])
def test_cuda_packed_window_mutants_caught(cuda, packed_mutants, hd, define):
    run, ref = _packed_window_case(cuda, 25 if hd == 64 else 100, 16, hd)
    with kernels.mutant(_PACKED_SRC, define):
        got = _after_nan_fill(run, tuple(ref.shape))
    assert not _row_rel_err(got, ref) <= _TOL


def _packed_global_case(gen, B, H, hd):
    y = _packed_y(gen, B, 64, H, hd)
    a, b = (_rand(gen, B, H, 4096, 64, scale=2.0) for _ in range(2))
    run = lambda: sam_attention.fused_global_attention_packed(  # noqa: E731
        y, a, b, H, _HP, 64, hd**-0.5, head_dim=hd)
    ref = sam_attention.fused_global_attention_packed_plain(y, a, b, H, _HP, 64, hd**-0.5,
                                                            head_dim=hd)
    return run, ref


@pytest.mark.cuda
@pytest.mark.parametrize("H,hd,B", [(16, 64, 1), (12, 64, 1), (16, 64, 2), (3, 64, 1),
                                    (16, 80, 4), (16, 80, 1)],
                         ids=["vit_l", "vit_b", "vit_l_b2", "h3", "vit_h_b4", "vit_h_b1"])
def test_cuda_packed_global_real_lanes_matches_plain(cuda, H, hd, B):
    """K20 over its real lanes (the three-warpgroup B1 schedule at hd 64,
    whose 22nd query tile of an (image, head) holds 64 rows; the
    two-warpgroup one at hd 80) against its plain version, into an output
    block just filled with NaN: one launch, the pad lanes exactly zero."""
    run, ref = _packed_global_case(cuda, B, H, hd)
    before = kernels.launch_counts()["fused_global_attention_packed"]
    got = _after_nan_fill(run, (B, 4096, H * _HP))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_global_attention_packed"] == before + 1
    assert _row_rel_err(got, ref) <= _TOL
    assert torch.all(got.reshape(B, 4096, H, _HP)[..., hd:] == 0)


@pytest.mark.cuda
def test_cuda_packed_global_refuses_other_head_dims(cuda):
    """No HD 128 instance: every lane (the default), and any width but 64
    and 80, is refused, never the plain version."""
    y = _packed_y(cuda, 1, 64)
    a, b = (_rand(cuda, 1, _H, 4096, 64) for _ in range(2))
    for hd in (128, 96, 32):
        with pytest.raises(ValueError, match="head_dim"):
            sam_attention.fused_global_attention_packed(y, a, b, _H, _HP, 64, 0.1, head_dim=hd)
    with pytest.raises(ValueError, match="head_dim"):
        sam_attention.fused_global_attention_packed(y, a, b, _H, _HP, 64, 0.1)


@pytest.mark.cuda
def test_cuda_packed_global_attrs(cuda):
    """One block an SM, nothing spilled: three consumer warpgroups at
    hd 64 (512 threads), two at hd 80 (384)."""
    for hd in (64, 80):
        attrs = kernels.kernel_attrs(_PACKED_SRC, "ullava_global_attention_packed_attrs", hd)
        assert attrs["blocks_per_sm"] == 1 and attrs["spill_bytes"] == 0, (hd, attrs)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,define", [(64, d) for d in _GLOBAL_BUGS + _GLOBAL_HD64_BUGS] +
                         [(80, d) for d in _GLOBAL_BUGS])
def test_cuda_packed_global_mutants_caught(cuda, packed_mutants, hd, define):
    run, ref = _packed_global_case(cuda, 1, 16, hd)
    with kernels.mutant(_PACKED_SRC, define):
        got = _after_nan_fill(run, tuple(ref.shape))
    assert not _row_rel_err(got, ref) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 1600], ids=["n64", "vit_h_block"])
def test_cuda_window_attention_matches_plain(cuda, N):
    W = 14
    S = W * W
    q, k, v = (_rand(cuda, N, S, _HD) for _ in range(3))
    a, b = (_rand(cuda, N, S, W, scale=2.0) for _ in range(2))
    got = sam_attention.fused_window_attention(q, k, v, a, b, W, _HD**-0.5)
    ref = sam_attention.fused_window_attention_plain(q, k, v, a, b, W, _HD**-0.5)
    assert _row_rel_err(got, ref) <= _TOL
    assert _row_rel_err(sam_attention.fused_window_attention(q, k, v, b, a, W, _HD**-0.5), ref) > _TOL
    # The raw terms count only pre-scaled by 1/scale.
    pre = (a.float() * _HD**0.5).to(torch.bfloat16), (b.float() * _HD**0.5).to(torch.bfloat16)
    assert _row_rel_err(sam_attention.fused_window_attention(q, k, v, a * 0, b * 0, W, _HD**-0.5),
                        ref) > _TOL
    assert _row_rel_err(sam_attention.fused_window_attention(q, k, v, *pre, W, _HD**-0.5), ref) > _TOL


@pytest.mark.cuda
def test_cuda_window_attention_equals_grid_kernel(cuda):
    """The per-(window, head) kernel and the grid window kernel run one core
    and one arithmetic: at one ViT-H B=4 window block (100 windows, 16
    heads) their outputs are bit-equal, the grid kernel given the same
    q, k, v as its y and the terms pre-scaled by the kernel's fp32 1/scale
    in its reversed column order."""
    Nw, W = 100, 14
    S, sc = W * W, _HD**-0.5
    q, k, v = (_rand(cuda, Nw * _H, S, _HD) for _ in range(3))
    a, b = (_rand(cuda, Nw * _H, S, W, scale=2.0) for _ in range(2))
    got = sam_attention.fused_window_attention(q, k, v, a, b, W, sc)
    y = torch.stack((q, k, v)).reshape(3, Nw, _H, S, _HD).permute(1, 3, 0, 2, 4).reshape(
        Nw, S, 3 * _H * _HD).contiguous()
    inv = (torch.ones(()) / torch.tensor(sc, dtype=torch.float32)).item()
    a3, b3 = ((t.float() * inv).to(torch.bfloat16).reshape(Nw, _H, S, W).flip(-1)
              .permute(0, 2, 1, 3).reshape(Nw, S, _H * W).contiguous() for t in (a, b))
    grid = sam_attention.fused_window_attention_grid(y, a3, b3, _H, _HD, W, sc)
    merged = got.reshape(Nw, _H, S, _HD).permute(0, 2, 1, 3).reshape(Nw, S, _H * _HD)
    assert torch.equal(grid, merged)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,maxS,lens", [
    (32, 32, 352, [352, 300, 1, 129]),
    (8, 2, 64, [64, 5, 33, 0]),
    (32, 32, 2048, [1977]),
    (32, 32, 2048, [0, 2011]),
], ids=["llama7b", "gqa", "split", "split_uniform"])
def test_cuda_decode_attention_int8_matches_plain(cuda, H, Hkv, maxS, lens):
    """Every form against the plain version; over 2048 rows (B x H = 32 or
    64 blocks, where the wrapper splits a (sample, head)'s rows over a
    cluster of blocks) also the cluster of 8 and one block a (sample,
    head), forced. A kv_lens of 0 is a uniform average over all maxS
    positions."""
    L, B, hd = 2, len(lens), 128
    q = _rand(cuda, B, 1, H, hd)
    cache_k, cache_v = (torch.randint(-127, 128, (L, B, maxS, Hkv * hd), generator=cuda,
                                      device="cuda", dtype=torch.int8) for _ in range(2))
    k_scale, v_scale = (torch.rand((L, B, maxS, Hkv), generator=cuda, device="cuda") * 0.02 + 1e-3
                        for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    snapshot = cache_k.clone(), cache_v.clone(), k_scale.clone(), v_scale.clone()
    args = (q, cache_k, cache_v, k_scale, v_scale, kv_lens, 1)
    got = decode_attention.decode_attention_int8(*args, scale=hd**-0.5)
    ref = decode_attention.decode_attention_int8_plain(*args, scale=hd**-0.5)
    assert _row_rel_err(got, ref) <= _TOL
    if maxS == 2048:  # a cluster of 8 blocks a (sample, head), and one block
        for splits in (8, 1):
            forced = decode_attention._decode_read_cuda(*args, hd**-0.5, splits=splits)
            assert _row_rel_err(forced, ref) <= _TOL
    for before, after in zip(snapshot, (cache_k, cache_v, k_scale, v_scale)):
        assert torch.equal(before, after)  # the cache is only read
    full = torch.full_like(kv_lens, maxS)
    assert _row_rel_err(decode_attention.decode_attention_int8(
        q, cache_k, cache_v, k_scale, v_scale, full, 1, scale=hd**-0.5), ref) > _TOL
    assert _row_rel_err(decode_attention.decode_attention_int8(
        q, cache_k, cache_v, v_scale, k_scale, kv_lens, 1, scale=hd**-0.5), ref) > _TOL


@pytest.mark.cuda
def test_cuda_packed_encoder_matches_unpacked(cuda):
    """Two blocks at ViT-H's head width and grids (embed 160 = 2 heads of
    80, window 14 on a 64 x 64 grid), bf16, B=1: one window block through
    the packed window kernel (block layout, 25 windows), one global block
    through the packed global kernel."""
    cfg = image_encoder.SamVisionConfig(embed_dim=160, depth=2, num_heads=2,
                                        global_attn_indexes=(1,), out_chans=256,
                                        window_layout="block")
    params = image_encoder.init_params(cfg, cuda, "cuda")
    for blk in params["window_blocks"] + params["global_blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk[key].normal_(0, 0.5, generator=cuda)
    packed = image_encoder.pack_sam_attention(params, cfg)
    img = torch.randn((1, 1024, 1024, 3), generator=cuda, device="cuda")
    before = kernels.launch_counts()
    got = image_encoder.encode(packed, cfg, img)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    assert ran == {"fused_window_attention_packed": 1, "fused_global_attention_packed": 1}
    ref = image_encoder.encode(params, dataclasses.replace(cfg, window_layout="block"), img)
    assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 5e-2
