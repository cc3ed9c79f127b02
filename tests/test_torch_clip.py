"""Parity of the port's CLIP serving knobs with the JAX package on the CPU:
`attn_impl="flash"` (the token sequence padded with zero rows to a
multiple of 8, pad keys masked through kv_lens, the flash forward K2 at
head_dim 64) and `a8` (W8A8 layer linears where the row count is a
multiple of 8). The JAX package takes both only on a TPU (`_on_tpu()`):
its flash runs here as `attn_impl="flash_interpret"`, and for `a8` its
`ullava_tpu.ops.attention._on_tpu` answers True inside the test (the JAX
sources are untouched). The port computes what the JAX package computes
on the TPU, on any device.

Tolerances. fp32 paths without int8 activations: 2e-4 (summation order
through three layers). With `a8` an activation within fp32 reassociation
of a rounding tie may take the neighbouring int8 step in one framework,
which moves an output by about 1/127 of one term: 2e-3 of the largest
output value, the `FLIP` limit of the other W8A8 tests
(`test_torch_sam_int8.py`), with the bulk (median) within 1e-5 of it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models import clip_vit as jclip
from ullava_tpu.ops import quant as jquant
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import clip_vit

# The module, not the function of the same name that `ullava_tpu.ops` exports.
jattn = importlib.import_module("ullava_tpu.ops.attention")
FLIP = 2e-3
# 128 wide, two heads of 64 (the width the JAX flash path needs); 28 x 28
# images of 14 x 14 patches: 5 tokens, padded to 8 under flash.
WIDE = dict(hidden_size=128, num_heads=2)


def setup_module():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(jcfg, seed, quantized):
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jclip.init_params, jcfg, seed))
    if quantized:
        jparams = jquant.quantize_tree(jparams, jquant.CLIP_QUANT_KEYS)
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _forward_both(jcfg, cfg, jparams, params, B, seed):
    img = np.random.default_rng(seed).standard_normal((B, 28, 28, 3)).astype(np.float32)
    ref = jclip.forward(jparams, jcfg, jnp.asarray(img), hidden_layer=-2)
    got = clip_vit.forward(params, cfg, _t(img), hidden_layer=-2)
    return got["hidden_states"].numpy(), np.asarray(ref["hidden_states"]), img


def test_clip_config_knobs_have_the_jax_defaults():
    cfg, jcfg = clip_vit.CLIPVisionConfig(), jclip.CLIPVisionConfig()
    assert (cfg.a8, cfg.attn_impl) == (jcfg.a8, jcfg.attn_impl) == (False, "xla")
    with pytest.raises(ValueError, match="attn_impl"):
        clip_vit.CLIPVisionConfig(attn_impl="flash_interpret")


def test_clip_flash_matches_jax_flash_interpret():
    """fp32 weights, B=3: the 5 tokens padded to 8 (pad keys masked, pad
    rows dropped). The same function as the unpadded attention, so it also
    matches the port's own "xla" path."""
    jcfg = jclip.CLIPVisionConfig.tiny(**WIDE, attn_impl="flash_interpret")
    cfg = clip_vit.CLIPVisionConfig.tiny(**WIDE, attn_impl="flash")
    jparams, params = _params(jcfg, seed=1, quantized=False)
    got, ref, img = _forward_both(jcfg, cfg, jparams, params, 3, seed=1)
    assert got.shape == (3, 5, 128)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    xla = clip_vit.forward(params, clip_vit.CLIPVisionConfig.tiny(**WIDE), _t(img),
                           hidden_layer=-2)["hidden_states"].numpy()
    np.testing.assert_allclose(got, xla, atol=2e-4, rtol=2e-4)


def test_clip_flash_needs_a_128_multiple_width():
    """At 64 wide (the tiny default) neither package takes the flash path:
    "flash" is the "xla" function exactly."""
    cfg = clip_vit.CLIPVisionConfig.tiny(attn_impl="flash")
    _, params = _params(jclip.CLIPVisionConfig.tiny(), seed=2, quantized=False)
    img = _t(np.random.default_rng(2).standard_normal((2, 28, 28, 3)).astype(np.float32))
    got = clip_vit.forward(params, cfg, img)["hidden_states"]
    ref = clip_vit.forward(params, clip_vit.CLIPVisionConfig.tiny(), img)["hidden_states"]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("impl,B", [("xla", 8), ("xla", 3), ("flash", 3)],
                         ids=["xla_rows40", "xla_rows15", "flash_rows24"])
def test_clip_a8_matches_jax_on_tpu_path(monkeypatch, impl, B):
    """int8 weights with `a8`. 8 x 5 = 40 rows under "xla" and 3 x 8 = 24
    under flash are multiples of 8: W8A8 on both sides. 3 x 5 = 15 rows under
    "xla" are not: both sides stay weight-only, and the port's result is its
    `a8=False` result exactly."""
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    jcfg = jclip.CLIPVisionConfig.tiny(
        **WIDE, a8=True, attn_impl="flash_interpret" if impl == "flash" else "xla")
    cfg = clip_vit.CLIPVisionConfig.tiny(**WIDE, a8=True, attn_impl=impl)
    jparams, params = _params(jcfg, seed=3, quantized=True)
    got, ref, img = _forward_both(jcfg, cfg, jparams, params, B, seed=3)
    weight_only = clip_vit.forward(
        params, clip_vit.CLIPVisionConfig.tiny(**WIDE, attn_impl=impl), _t(img),
        hidden_layer=-2)["hidden_states"].numpy()
    err, top = np.abs(got - ref), np.abs(ref).max()
    rows = B * (8 if impl == "flash" else 5)
    if rows % 8:
        np.testing.assert_array_equal(got, weight_only)
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    else:
        assert err.max() <= FLIP * top, (err.max(), top)
        assert np.median(err) <= 1e-5 * top, (np.median(err), top)
        # W8A8 is another function than weight-only int8.
        assert np.abs(got - weight_only).max() > 10 * err.max()
