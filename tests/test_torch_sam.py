"""Parity of the port's SAM path with the JAX package at tiny fp32 sizes:
the image encoder in the block window layout (JAX with its Pallas kernels
in interpret mode), prompt encoding + mask decoding, and the bilinear
resizes of the post-processing in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.models.sam import build as jbuild
from ullava_tpu.models.sam import image_encoder as jie
from torch_port_helpers import random_params
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import build, image_encoder

# fp32 through four blocks and the neck; sums run in different orders.
ATOL = RTOL = 2e-4


def setup_module():
    torch.set_num_threads(1)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_encode_block_layout_matches_jax_pallas_interpret():
    """Grid 17 with window 3 pads 17 -> 18 after LN1 in every window block,
    and the global blocks (size 17 > 16) take the global kernel."""
    jcfg = jie.SamVisionConfig(
        img_size=68, patch_size=4, embed_dim=32, depth=4, num_heads=2, out_chans=16,
        window_size=3, global_attn_indexes=(1, 3), dtype=jnp.float32,
        attn_kernel="pallas_interpret", window_layout="block",
    )
    cfg = image_encoder.SamVisionConfig(
        img_size=68, patch_size=4, embed_dim=32, depth=4, num_heads=2, out_chans=16,
        window_size=3, global_attn_indexes=(1, 3), dtype=torch.float32, window_layout="block",
    )
    # Random rel-pos tables, positions and biases too (init leaves them 0).
    jparams = random_params(jie.init_params, jcfg, seed=0, std=0.2)
    params = params_from_jax(jparams, device="cpu")

    img = np.random.default_rng(1).standard_normal((2, 68, 68, 3)).astype(np.float32)
    ref = jax.jit(jie.encode, static_argnums=1)(jparams, jcfg, jnp.asarray(img))
    got = image_encoder.encode(params, cfg, torch.as_tensor(img))
    assert got.shape == (2, 17, 17, 16)
    _close(got, ref)


def test_forward_masks_matches_jax():
    jcfg = jbuild.SamConfig.tiny()
    cfg = build.SamConfig.tiny()
    jparams = random_params(jbuild.init_sam_params, jcfg, seed=2)
    params = params_from_jax(jparams, device="cpu")
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    text = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jlow, jiou = jax.jit(jbuild.forward_masks, static_argnums=1)(
        jparams, jcfg, jnp.asarray(emb), jnp.asarray(text)
    )
    low, iou = build.forward_masks(params, cfg, torch.as_tensor(emb), torch.as_tensor(text))
    assert low.shape == (2, 3, 16, 16)
    _close(low, jlow, atol=1e-5)
    _close(iou, jiou, atol=1e-5)


@pytest.mark.parametrize("input_size,original_size", [((50, 40), (23, 31)), ((64, 48), (90, 70))])
def test_resizes_match_jax_both_directions(input_size, original_size):
    rng = np.random.default_rng(3)
    low = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    _close(build.upscale_masks_to_frame(torch.as_tensor(low), 64),
           jbuild.upscale_masks_to_frame(jnp.asarray(low), 64), atol=1e-5)
    got = build.postprocess_masks_host(low[0], input_size, original_size, img_size=64)
    ref = jbuild.postprocess_masks_host(low[0], input_size, original_size, img_size=64)
    assert got.shape == (3,) + original_size
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
