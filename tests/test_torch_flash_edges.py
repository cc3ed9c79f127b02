"""Parity of the training flash forward (`attention.flash_attention_fwd`,
o and lse) with the JAX package's `flash_attention_fwd` (its Pallas kernel
in interpret mode) at the edges that a 128-row query tile and a
heavy-first block order can get wrong: a query length that is no multiple
of 64 or 128, a query offset past the first key tile, a batch row with no
live key, and ragged kv_lens without the causal mask. Inputs are drawn
with numpy; fp32, at the JAX package's tolerances (2e-4 for o and lse,
`tests/test_ops.py:113`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.ops.attention import flash_attention_fwd as jflash_fwd
from ullava_tpu_torch.ops import attention

# name: (Sq, Sk, kv_lens, causal, q_offset)
_CASES = {
    "sq_200": (200, 200, (200, 131), True, 0),
    "q_offset_128": (128, 256, (256, 200), True, 128),
    "kv_len_0": (128, 128, (128, 0), True, 0),
    "non_causal_ragged": (128, 192, (150, 37), False, 0),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_flash_fwd_edges_match_jax(name):
    Sq, Sk, lens, causal, q_offset = _CASES[name]
    rng = np.random.default_rng(11)
    B, H, D = 2, 2, 128
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float32) for _ in range(2))
    kv = np.asarray(lens, np.int32)
    sc = D**-0.5
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
    o_ref, lse_ref = jflash_fwd(*hm, jnp.asarray(kv), causal=causal, scale=sc,
                                q_offset=q_offset, interpret=True)
    o, lse = attention.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v, kv)), causal=causal, scale=sc,
        q_offset=q_offset)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(o_ref), atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=2e-4)
    dead = np.asarray(kv) == 0
    if dead.any():  # a row with no live key: o zero and lse 1e30 on both sides
        assert not o[dead].any() and bool((lse[dead] == 1e30).all())
        assert not np.asarray(o_ref)[dead].any()
        assert bool((np.asarray(lse_ref)[dead] == 1e30).all())
