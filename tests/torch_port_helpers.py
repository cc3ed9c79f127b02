"""Shared helpers of the port's parity tests (`test_torch_*.py`)."""

import jax
import numpy as np


def random_params(init, cfg, seed: int, std: float = 0.1):
    """A numpy parameter tree with the shapes and dtypes of `init(key, cfg)`
    (traced with `jax.eval_shape`, so nothing is compiled), filled from a
    numpy seed: norm scales 1 + std*N(0, 1), every other leaf std*N(0, 1)."""
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", ""))
        base = 1.0 if name in ("scale", "norm", "input_norm", "post_norm") or name.endswith("_scale") else 0.0
        return (base + std * rng.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def res_batch(cfg, rng, lens):
    """A right-padded batch of tiny RES requests (numpy): prompts with the
    image span after `<img_beg>`, CLIP images and SAM images."""
    P = cfg.core.vision.num_patches
    ids = rng.integers(5, 140, size=(len(lens), max(lens)))
    for b, n in enumerate(lens):
        ids[b, 1] = cfg.core.img_start_id
        ids[b, 2:2 + P] = 3
        ids[b, 2 + P] = cfg.core.img_end_id
        ids[b, n:] = 0
    return dict(
        input_ids=ids,
        prompt_lens=np.asarray(lens, np.int32),
        images=rng.standard_normal((len(lens), 28, 28, 3)).astype(np.float32),
        images_sam=rng.standard_normal((len(lens), 64, 64, 3)).astype(np.float32),
    )


def assert_int8_close(got, ref):
    """Int8 arrays rounded from fp32 values that the two frameworks sum in
    different orders: a value within that noise of .5 may round the other
    way, so (as the JAX package's own tests do) at least 99.9% must agree
    exactly and the rest within 1."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert (diff <= 1).all() and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
