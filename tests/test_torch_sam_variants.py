"""The SAM encoders the port adds beside ViT-H, against the JAX package on
the CPU: the `sam_vit_l` and `sam_vit_b` configs field by field; an
encoder with ViT-L's and ViT-B's head dim of 64 (embed 128, 2 heads, 4
blocks, a 17 x 17 grid of windows of 3, so that every window class and
the global kernel's route appear) in the block and the resident layouts,
JAX with its Pallas kernels in interpret mode; `use_rel_pos=False` (plain
attention with no bias in every block, JAX's XLA route); and the
checkpoint converter on Meta-named state dicts with ViT-L's and ViT-B's
block layout (global blocks closing groups of 6 and of 3) at a narrow
width, written here from a numpy seed through `chip_smoke.sam_meta_specs`
(the spec the card run writes at full width), read by
`weights.load_state_dict` and converted by both packages, leaf by leaf.

Tolerances: encoders 5e-4 absolute and relative (fp32 through four
blocks of 64-lane heads and the neck, sums in another order); the
converter bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_helpers import random_params
from ullava_tpu.models.sam import build as jbuild
from ullava_tpu.models.sam import convert as jconvert
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import weights
from ullava_tpu_torch.models.sam import build, convert, image_encoder

TOL = 5e-4


def setup_module():
    torch.set_num_threads(1)


def _fields(cfg):
    out = {}
    for part in ("vision", "prompt", "decoder"):
        for k, v in dataclasses.asdict(getattr(cfg, part)).items():
            if k == "dtype":  # jnp.float32 and torch.float32 alike
                v = getattr(v, "__name__", None) or str(v).split(".")[-1]
            out[f"{part}.{k}"] = v
    return out


@pytest.mark.parametrize("name", ["sam_vit_h", "sam_vit_l", "sam_vit_b"])
def test_sam_configs_match_jax(name):
    jcfg, cfg = getattr(jbuild, name)(), getattr(build, name)()
    got, ref = _fields(cfg), _fields(jcfg)
    # The port's knobs that the JAX config names otherwise or lacks.
    for k in ("vision.attn_kernel",):
        got.pop(k), ref.pop(k)
    assert got == ref
    assert cfg.vision.head_dim == jcfg.vision.head_dim == (80 if name == "sam_vit_h" else 64)


def _cfgs(**kw):
    shape = dict(img_size=68, patch_size=4, embed_dim=128, depth=4, num_heads=2, out_chans=16,
                 window_size=3, global_attn_indexes=(1, 3))
    jcfg = jie.SamVisionConfig(**shape, dtype=jnp.float32, **kw)
    cfg = image_encoder.SamVisionConfig(**shape, dtype=torch.float32,
                                        **{k: v for k, v in kw.items() if k != "attn_kernel"})
    return jcfg, cfg


def _encode_both(jcfg, cfg, seed):
    jparams = random_params(jie.init_params, jcfg, seed=seed, std=0.2)
    params = params_from_jax(jparams, device="cpu")
    img = np.random.default_rng(seed).standard_normal((2, 68, 68, 3)).astype(np.float32)
    ref = jax.jit(jie.encode, static_argnums=1)(jparams, jcfg, jnp.asarray(img))
    got = image_encoder.encode(params, cfg, torch.as_tensor(img))
    assert got.shape == (2, 17, 17, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layout", ["block", "resident"])
def test_encode_hd64_matches_jax(layout):
    jcfg, cfg = _cfgs(attn_kernel="pallas_interpret", window_layout=layout)
    assert cfg.head_dim == 64 and image_encoder._use_resident(cfg) == (layout == "resident")
    _encode_both(jcfg, cfg, seed=3)


def test_encode_without_rel_pos_matches_jax():
    jcfg, cfg = _cfgs(use_rel_pos=False)
    assert not image_encoder._use_resident(cfg) and not image_encoder._fused_routes(cfg)
    _encode_both(jcfg, cfg, seed=4)
    with pytest.raises(ValueError, match="block layout"):
        image_encoder.SamVisionConfig(use_rel_pos=False, window_layout="resident")


@pytest.mark.parametrize("size,period", [("vit_l", 6), ("vit_b", 3)])
def test_convert_vit_l_and_vit_b_meta_checkpoints_match_jax(size, period, tmp_path):
    """ViT-L's and ViT-B's block layouts (a global block closing each group
    of 6 and of 3, four groups) at width 32 with 2 heads; prompt encoder
    and mask decoder at their released width."""
    C, heads = 32, 2
    idx = tuple(period * (i + 1) - 1 for i in range(4))
    rng = np.random.default_rng(period)
    sd = {}
    for name, shape, init in chip_smoke.sam_meta_specs(C, 4 * period, heads, idx):
        base = {"ones": 1.0, "zeros": 0.0}.get(init, 0.0)
        std = 0.0 if init in ("ones", "zeros") else (1.0 if init == "gaussian" else 0.02)
        sd[name] = torch.as_tensor((base + std * rng.standard_normal(shape)).astype(np.float32))
    path = tmp_path / f"sam_{size}.pth"
    torch.save(sd, path)
    sd = weights.load_state_dict(str(path))

    vision = dict(embed_dim=C, depth=4 * period, num_heads=heads, global_attn_indexes=idx)
    jcfg = jbuild.SamConfig(vision=jie.SamVisionConfig(**vision))
    cfg = build.SamConfig(vision=image_encoder.SamVisionConfig(**vision))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jconvert.convert_sam(
        {k: v.numpy() for k, v in sd.items()}, jcfg, jnp.float32)), device="cpu")
    got = convert.convert_sam(sd, cfg, torch.float32, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path_, g), (_, r) in zip(got_leaves, ref_leaves):
        assert g.dtype == r.dtype and torch.equal(g, r), path_
    assert len(got["image_encoder"]["global_blocks"]) == 4
    assert len(got["image_encoder"]["window_blocks"]) == 4 * (period - 1)
    assert got["prompt_encoder"]["mask_conv2"].shape == (2, 2, 4, 16)
