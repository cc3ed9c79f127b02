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


def assert_int8_close(got, ref):
    """Int8 arrays rounded from fp32 values that the two frameworks sum in
    different orders: a value within that noise of .5 may round the other
    way, so (as the JAX package's own tests do) at least 99.9% must agree
    exactly and the rest within 1."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert (diff <= 1).all() and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
