"""On the card: the CUDA kernels of the SAM packed attention layout and the
two kernels no path calls, against their plain PyTorch versions in bf16:
the packed window kernel (hp 128, W 14), the packed global kernel (hp 128,
W 64), the per-(window, head) window kernel (hd 80, W 14; also at one
ViT-H B=4 window block and against the grid window kernel on the same
windows) and the decode attention over the int8 cache that writes nothing
(LLaMA-7B's head width, ragged kv_lens, GQA, and a long cache split over
a cluster of blocks, with a uniform row); then a small packed encoder
against the same weights unpacked. Every test here needs an NVIDIA GPU and skips without
one. The file imports torch only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_packed.py -q

Gates: bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there is at most 2^-7 of it); the packed encoder within 5e-2 of the
largest embedding value of the unpacked one (both bf16 through two blocks
and the neck, rounding at different points: the unpacked window kernel
pre-scales the bias terms to bf16, the packed ones add them raw after the
scale).
"""

import dataclasses

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import decode_attention, sam_attention

_TOL = 1e-2
_H, _HD, _HP = 16, 80, 128


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


def _packed_y(gen, N, W):
    """A packed qkv projection output: 80 real lanes of each 128, the pad
    lanes zero as `pack_sam_attention`'s weights make them."""
    y = torch.zeros((N, W * W, 3, _H, _HP), dtype=torch.bfloat16, device="cuda")
    y[..., :_HD] = _rand(gen, N, W * W, 3, _H, _HD)
    return y.reshape(N, W * W, 3 * _H * _HP)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N", [(14, 12), (14, 100), (64, 1), (64, 3)],
                         ids=["window", "window_n100", "global", "global_b3"])
def test_cuda_packed_attention_matches_plain(cuda, W, N):
    y = _packed_y(cuda, N, W)
    a, b = (_rand(cuda, N, _H, W * W, W, scale=2.0) for _ in range(2))
    kw = dict(num_heads=_H, head_pad=_HP, window=W, scale=_HD**-0.5)
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
