"""Parity of the training flash forward (`attention.flash_attention_fwd`,
o and lse) and backward (`attention.flash_attention_bwd`, dq, dk and dv)
with the JAX package's `flash_attention_fwd` and `flash_attention_bwd`
(their Pallas kernels in interpret mode) at the edges that 128-row query
or key tiles, 64-row streamed tiles and a heavy-first block order can get
wrong: a query length that is no multiple of 64 or 128, a query offset
past the first key tile, a batch row with no live key, and ragged kv_lens
without the causal mask. Inputs are drawn with numpy; fp32, at the JAX
package's tolerances (2e-4 for o and lse, `tests/test_ops.py:113`; rtol
5e-3, atol 1e-3 for the gradients, as `tests/test_torch_train.py` holds
them).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.ops.attention import flash_attention_bwd as jflash_bwd
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


@pytest.mark.parametrize("name", list(_CASES))
def test_flash_bwd_edges_match_jax(name):
    """(dq, dk, dv) from JAX's o and lse through both backwards; key rows
    at or past kv_len are exact zeros in dk and dv."""
    Sq, Sk, lens, causal, q_offset = _CASES[name]
    rng = np.random.default_rng(12)
    B, H, D = 2, 2, 128
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float32) for _ in range(2))
    kv = np.asarray(lens, np.int32)
    sc = D**-0.5
    kw = dict(causal=causal, scale=sc, q_offset=q_offset)
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, do)]
    o_ref, lse_ref = jflash_fwd(*hm[:3], jnp.asarray(kv), interpret=True, **kw)
    grads_ref = jflash_bwd(*hm[:3], o_ref, lse_ref, hm[3], jnp.asarray(kv), interpret=True,
                           **kw)
    o = torch.from_numpy(np.asarray(o_ref).transpose(0, 2, 1, 3).copy())
    lse = torch.from_numpy(np.asarray(lse_ref)[..., 0].copy())
    grads = attention.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse, torch.from_numpy(do),
        torch.from_numpy(kv), **kw)
    for g, r in zip(grads, grads_ref):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(r), rtol=5e-3,
                                   atol=1e-3)
    for b, n in enumerate(lens):
        assert not grads[1][b, n:].any() and not grads[2][b, n:].any()


_MODES = {"default": (False, False), "deterministic": (True, False), "warn_only": (True, True)}


def _set_mode(mode):
    on, warn_only = _MODES[mode]
    torch.use_deterministic_algorithms(on, warn_only=warn_only)


@pytest.mark.parametrize("mode", list(_MODES))
def test_flash_bwd_cpu_route_is_deterministic_in_every_mode(mode):
    """The CPU route (the plain version) takes torch's deterministic mode,
    with or without `warn_only`, without a warning, and gives the same bits
    in it as outside it, call after call."""
    Sq, Sk, lens, causal, q_offset = _CASES["sq_200"]
    rng = np.random.default_rng(13)
    B, H, D = 2, 2, 128
    q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D)).astype(np.float32))
            for _ in range(2))
    kv = torch.tensor(lens, dtype=torch.int32)
    kw = dict(causal=causal, scale=D**-0.5, q_offset=q_offset)
    o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
    ref = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        _set_mode(mode)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            runs = [attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
                    for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    for grads in runs:
        for g, r in zip(grads, ref):
            assert torch.equal(g, r)


@pytest.mark.parametrize("mode", list(_MODES))
def test_nondeterministic_alert_follows_torch_mode(mode):
    """What the card's flash backward does before it launches (its dq
    parts arrive in no fixed order): raise under deterministic mode, warn
    under `warn_only`, nothing outside it, as torch's own nondeterministic
    CUDA kernels do."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        _set_mode(mode)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if mode == "deterministic":
                with pytest.raises(RuntimeError, match="flash_attention_bwd"):
                    attention.alert_nondeterministic("flash_attention_bwd")
            else:
                attention.alert_nondeterministic("flash_attention_bwd")
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    warned = [w for w in caught if issubclass(w.category, UserWarning)
              and "flash_attention_bwd" in str(w.message)]
    assert len(warned) == (1 if mode == "warn_only" else 0)
