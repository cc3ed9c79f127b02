"""The packed window attention over its real lanes alone: the port's
`fused_window_attention_packed` takes a `head_dim` keyword (the real lanes
of each `head_pad`-lane block; `head_pad`, every lane, by default) whose
plain version contracts those lanes and writes zeros to the rest. On the
packed layout's zero pad lanes that is the JAX function
(`ullava_tpu/ops/sam_attention.py:785-787`), which contracts every lane:
held here against the Pallas kernel in interpret mode and against the
all-lanes plain version, at ViT-L's and ViT-B's 64 and ViT-H's 80 real
lanes of 128; then the wrapper's refusals and a tiny packed encoder at
head_dim 64, whose window blocks pass `cfg.head_dim`, against JAX `encode`.
No card needed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import sam_attention

N, H, HP, W = 2, 2, 128, 14

# bf16 outputs: both sides round p and the output to bf16 from fp32 sums
# taken in different orders, so an element may land one bf16 step apart
# (2^-8 of its value); fp32: summation order only (`test_torch_sam_packed`).
_TOLS = {"fp32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def setup_module():
    torch.set_num_threads(1)


def _case(seed, hd, dtype, pad_value=0.0):
    """A packed projection output with `hd` real lanes a block (the pad
    lanes `pad_value`: zero as `pack_sam_attention` makes them) and raw
    bias terms of a few units, as numpy arrays in `dtype`."""
    rng = np.random.default_rng(seed)
    S = W * W
    y = np.full((N, S, 3, H, HP), pad_value, np.float32)
    y[..., :hd] = rng.standard_normal((N, S, 3, H, hd))
    a, b = (2.0 * rng.standard_normal((N, H, S, W)).astype(np.float32) for _ in range(2))
    y = y.reshape(N, S, 3 * H * HP)
    if dtype == "bf16":  # round once, hand both sides the same values
        y, a, b = (np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (y, a, b))
    return y, a, b


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80"])
def test_packed_window_plain_real_lanes_matches_jax_and_all_lanes(hd, dtype):
    """`head_dim` = hd against the JAX kernel (interpret mode, all 128
    lanes) and against the all-lanes plain version, each within the
    dtype's tolerance (the zero lanes add exact zeros, but a sum over 128
    lanes may be grouped otherwise than one over hd); its own plain
    version bit for bit."""
    y, a, b = _case(29 + hd, hd, dtype)
    kw = dict(num_heads=H, head_pad=HP, window=W, scale=hd**-0.5)
    ref = jsam.fused_window_attention_packed(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b),
                                             interpret=True, **kw)
    ty, ta, tb = (_torch(t) for t in (y, a, b))
    got = sam_attention.fused_window_attention_packed(ty, ta, tb, **kw, head_dim=hd)
    assert got.shape == (N, W * W, H * HP) and got.dtype == ty.dtype
    _close(got, ref, **_TOLS[dtype])
    plain = sam_attention.fused_window_attention_packed_plain(ty, ta, tb, H, HP, W, hd**-0.5,
                                                              head_dim=hd)
    assert torch.equal(got, plain)
    every_lane = sam_attention.fused_window_attention_packed(ty, ta, tb, **kw)
    _close(got, every_lane.float().numpy(), **_TOLS[dtype])


@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80"])
def test_packed_window_plain_pad_lanes_are_zero(hd):
    """The output's pad lanes are exact zeros, and only the real lanes
    count: with nonzero pad lanes in y the result equals the unpadded
    attention over the first hd lanes (the JAX function's on zero pads)."""
    y0, a, b = _case(7, hd, "fp32")
    y1, _, _ = _case(7, hd, "fp32", pad_value=3.0)
    kw = dict(num_heads=H, head_pad=HP, window=W, scale=hd**-0.5, head_dim=hd)
    got0 = sam_attention.fused_window_attention_packed(*(_torch(t) for t in (y0, a, b)), **kw)
    got1 = sam_attention.fused_window_attention_packed(*(_torch(t) for t in (y1, a, b)), **kw)
    assert torch.all(got1.reshape(N, W * W, H, HP)[..., hd:] == 0)
    assert torch.equal(got0, got1)
    ref = jsam.fused_window_attention_packed(*(jnp.asarray(t) for t in (y0, a, b)),
                                             interpret=True, num_heads=H, head_pad=HP,
                                             window=W, scale=hd**-0.5)
    _close(got1, ref, **_TOLS["fp32"])


@pytest.mark.parametrize("head_dim", [129, 256, 0], ids=["129", "256", "0"])
def test_packed_window_refuses_head_dim_outside_head_pad(head_dim):
    y, a, b = (_torch(t) for t in _case(3, 64, "fp32"))
    with pytest.raises(ValueError, match="head_dim"):
        sam_attention.fused_window_attention_packed(y, a, b, H, HP, W, 0.125, head_dim=head_dim)


def test_packed_encoder_hd64_passes_head_dim_and_matches_jax(monkeypatch):
    """Two blocks at head_dim 64 (embed 128, 2 heads) packed to 128 lanes,
    fp32: a grid of 4 and window 2, so both blocks, windowed and global,
    take the packed window kernel; each call passes `head_dim=64`, and the
    encoder matches JAX `encode` of the same packed weights (Pallas in
    interpret mode) at `test_torch_sam_packed`'s 2e-4."""
    base = dict(img_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2, out_chans=32,
                window_size=2, global_attn_indexes=(1,))
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel="pallas_interpret")
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32)
    assert cfg.head_dim == 64
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, 11, std=0.2))
    jpacked = jie.pack_sam_attention(jp, jcfg)
    packed = image_encoder.pack_sam_attention(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), cfg)
    assert packed["window_blocks"][0]["qkv"].shape[-1] == 3 * 2 * HP

    seen = []
    real = image_encoder.fused_window_attention_packed

    def spy(*args, **kw):
        seen.append((kw.get("head_pad"), kw.get("head_dim")))
        return real(*args, **kw)

    monkeypatch.setattr(image_encoder, "fused_window_attention_packed", spy)
    img = np.random.default_rng(11).standard_normal((2, 64, 64, 3)).astype(np.float32)
    got = image_encoder.encode(packed, cfg, torch.from_numpy(img))
    assert seen == [(HP, 64), (HP, 64)]
    ref = jax.jit(jie.encode, static_argnums=1)(jpacked, jcfg, jnp.asarray(img))
    _close(got, ref, atol=2e-4, rtol=2e-4)


# The global form (K20) on a 32 x 32 grid (S = 1024), the TPU kernel's
# tiles at 256 so that its online softmax spans four key tiles.
GW, GB = 32, 1


def _global_case(seed, hd, dtype, pad_value=0.0):
    """As `_case`, on the global grid: y [GB, S, 3*H*HP], the terms
    [GB, H, S, GW]."""
    rng = np.random.default_rng(seed)
    S = GW * GW
    y = np.full((GB, S, 3, H, HP), pad_value, np.float32)
    y[..., :hd] = rng.standard_normal((GB, S, 3, H, hd))
    a, b = (2.0 * rng.standard_normal((GB, H, S, GW)).astype(np.float32) for _ in range(2))
    y = y.reshape(GB, S, 3 * H * HP)
    if dtype == "bf16":
        y, a, b = (np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (y, a, b))
    return y, a, b


def _jax_global(y, a, b, hd):
    return jsam.fused_global_attention_packed(
        jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), num_heads=H, head_pad=HP, window=GW,
        scale=hd**-0.5, block_q=256, block_k=256, interpret=True)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80"])
def test_packed_global_plain_real_lanes_matches_jax_and_all_lanes(hd, dtype):
    """`fused_global_attention_packed(head_dim=hd)` on the CPU (its plain
    version) against the JAX kernel (interpret mode, all 128 lanes,
    `ullava_tpu/ops/sam_attention.py:867-960`) and against the all-lanes
    plain version, within the dtype's tolerance (`_TOLS`); its plain
    version bit for bit."""
    y, a, b = _global_case(31 + hd, hd, dtype)
    ref = _jax_global(y, a, b, hd)
    ty, ta, tb = (_torch(t) for t in (y, a, b))
    kw = dict(num_heads=H, head_pad=HP, window=GW, scale=hd**-0.5)
    got = sam_attention.fused_global_attention_packed(ty, ta, tb, **kw, head_dim=hd)
    assert got.shape == (GB, GW * GW, H * HP) and got.dtype == ty.dtype
    _close(got, ref, **_TOLS[dtype])
    plain = sam_attention.fused_global_attention_packed_plain(ty, ta, tb, H, HP, GW, hd**-0.5,
                                                              head_dim=hd)
    assert torch.equal(got, plain)
    every_lane = sam_attention.fused_global_attention_packed(ty, ta, tb, **kw)
    _close(got, every_lane.float().numpy(), **_TOLS[dtype])


@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80"])
def test_packed_global_plain_pad_lanes_are_zero(hd):
    """The output's pad lanes are exact zeros and only the real lanes
    count: with pad lanes of 3.0 in y the result equals the one on zero
    pad lanes, bit for bit, and the JAX function's there (fp32, 2e-5)."""
    y0, a, b = _global_case(8, hd, "fp32")
    y1, _, _ = _global_case(8, hd, "fp32", pad_value=3.0)
    kw = dict(num_heads=H, head_pad=HP, window=GW, scale=hd**-0.5, head_dim=hd)
    got0 = sam_attention.fused_global_attention_packed(*(_torch(t) for t in (y0, a, b)), **kw)
    got1 = sam_attention.fused_global_attention_packed(*(_torch(t) for t in (y1, a, b)), **kw)
    assert torch.all(got1.reshape(GB, GW * GW, H, HP)[..., hd:] == 0)
    assert torch.equal(got0, got1)
    _close(got1, _jax_global(y0, a, b, hd), **_TOLS["fp32"])


@pytest.mark.parametrize("head_dim", [129, 256, 0], ids=["129", "256", "0"])
def test_packed_global_refuses_head_dim_outside_head_pad(head_dim):
    y, a, b = (_torch(t) for t in _global_case(4, 64, "fp32"))
    with pytest.raises(ValueError, match="head_dim"):
        sam_attention.fused_global_attention_packed(y, a, b, H, HP, GW, 0.125, head_dim=head_dim)


@pytest.mark.parametrize("embed,heads", [(128, 2), (192, 3)], ids=["vit_l_heads", "vit_b_heads"])
def test_packed_encoder_global_passes_head_dim_and_matches_jax(monkeypatch, embed, heads):
    """Two blocks of heads 64 wide (ViT-L's and ViT-B's width; 2 and 3
    heads) packed to 128 lanes, fp32, on a 32 x 32 grid with 16 x 16
    windows: the window block takes the packed window kernel, the global
    block the packed global one (grid > 16); each call passes
    `head_dim=64`, and the encoder matches JAX `encode` of the same packed
    weights (Pallas in interpret mode) at `test_torch_sam_packed`'s 2e-4."""
    base = dict(img_size=512, patch_size=16, embed_dim=embed, depth=2, num_heads=heads,
                out_chans=32, window_size=16, global_attn_indexes=(1,))
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel="pallas_interpret")
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32)
    assert cfg.head_dim == 64
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, 13, std=0.2))
    jpacked = jie.pack_sam_attention(jp, jcfg)
    packed = image_encoder.pack_sam_attention(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), cfg)

    seen = []
    for name in ("fused_window_attention_packed", "fused_global_attention_packed"):
        def spy(*args, _real=getattr(image_encoder, name), _name=name, **kw):
            seen.append((_name, kw.get("head_pad"), kw.get("head_dim")))
            return _real(*args, **kw)

        monkeypatch.setattr(image_encoder, name, spy)
    img = np.random.default_rng(13).standard_normal((1, 512, 512, 3)).astype(np.float32)
    got = image_encoder.encode(packed, cfg, torch.from_numpy(img))
    assert seen == [("fused_window_attention_packed", HP, 64),
                    ("fused_global_attention_packed", HP, 64)]
    ref = jax.jit(jie.encode, static_argnums=1)(jpacked, jcfg, jnp.asarray(img))
    _close(got, ref, atol=2e-4, rtol=2e-4)
