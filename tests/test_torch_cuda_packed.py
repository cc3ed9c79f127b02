"""On the card: the CUDA kernels of the SAM packed attention layout and the
two kernels no path calls, against their plain PyTorch versions in bf16:
the packed window kernel (hp 128, W 14), the packed global kernel (hp 128,
W 64), the per-(window, head) window kernel (hd 80, W 14) and the decode
attention over the int8 cache that writes nothing (LLaMA-7B's head width,
ragged kv_lens, and GQA); then a small packed encoder against the same
weights unpacked. Every test here needs an NVIDIA GPU and skips without
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
def test_cuda_window_attention_matches_plain(cuda):
    N, W = 64, 14
    S = W * W
    q, k, v = (_rand(cuda, N, S, _HD) for _ in range(3))
    a, b = (_rand(cuda, N, S, W, scale=2.0) for _ in range(2))
    got = sam_attention.fused_window_attention(q, k, v, a, b, W, _HD**-0.5)
    ref = sam_attention.fused_window_attention_plain(q, k, v, a, b, W, _HD**-0.5)
    assert _row_rel_err(got, ref) <= _TOL
    assert _row_rel_err(sam_attention.fused_window_attention(q, k, v, b, a, W, _HD**-0.5), ref) > _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,maxS,lens", [
    (32, 32, 352, [352, 300, 1, 129]),
    (8, 2, 64, [64, 5, 33, 0]),
], ids=["llama7b", "gqa"])
def test_cuda_decode_attention_int8_matches_plain(cuda, H, Hkv, maxS, lens):
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
    for before, after in zip(snapshot, (cache_k, cache_v, k_scale, v_scale)):
        assert torch.equal(before, after)  # the cache is only read
    full = torch.full_like(kv_lens, maxS)
    assert _row_rel_err(decode_attention.decode_attention_int8(
        q, cache_k, cache_v, k_scale, v_scale, full, 1, scale=hd**-0.5), ref) > _TOL


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
