"""Parity of the port's kernel-bearing ops with the JAX package.

Each function of `ullava_tpu_torch.ops` that holds a kernel takes its plain
version for CPU tensors; here it runs against the JAX function with the
Pallas kernel in interpret mode, on the same inputs drawn from a numpy
seed, in fp32. The kernels themselves run on the card in the `cuda`-marked
tests of `test_torch_cuda_bf16.py` (torch only, skipped without a card) and
in `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.ops.attention import attention_xla as j_attention_xla
from ullava_tpu.ops.attention import flash_attention_fwd_bsh as j_flash_bsh
from ullava_tpu.ops import norms as jnorms
from ullava_tpu.ops import rope as jrope
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.ops import attention, norms, rope, sam_attention

# fp32 on both sides; the two frameworks sum in different orders.
ATOL = RTOL = 2e-5


def setup_module():
    torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_rms_norm_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    _close(norms.rms_norm(_t(x), _t(w), 1e-6), jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(
        norms.layer_norm(_t(x), _t(w), _t(b), 1e-5),
        jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5),
    )


def test_rope_tables_and_apply_rotary_match_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 300, size=(2, 9))
    cos, sin = rope.rope_cos_sin(_t(pos), 32)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), 32)
    _close(cos, jcos, atol=1e-5)
    _close(sin, jsin, atol=1e-5)
    q = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    got = rope.apply_rotary(_t(q), _t(k), _t(jcos), _t(jsin))
    ref = jrope.apply_rotary(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    _close(got[0], ref[0])
    _close(got[1], ref[1])


def test_fused_rotary_matches_jax_interpret():
    rng = np.random.default_rng(2)
    R, hd, H = 16, 32, 4
    x = rng.standard_normal((R, H * hd)).astype(np.float32)
    cos, sin = jrope.rope_cos_sin(jnp.arange(R) % 5, hd)
    ref = jrope.fused_rotary(jnp.asarray(x), cos, sin, hd, interpret=True)
    _close(rope.fused_rotary(_t(x), _t(cos), _t(sin), hd), ref)


def test_fused_rotary_hd128_bf16_matches_jax_interpret():
    """The main path's head width with bf16 rows, as the serving prefill
    feeds it: both sides rotate in fp32 and round once to bf16, so they
    agree within one bf16 ulp of each value (2^-8 relative)."""
    rng = np.random.default_rng(3)
    R, hd, H = 24, 128, 4
    x = jnp.asarray(rng.standard_normal((R, H * hd)).astype(np.float32), jnp.bfloat16)
    cos, sin = jrope.rope_cos_sin(jnp.arange(R) % 11 + 300, hd)
    ref = jrope.fused_rotary(x, cos, sin, hd, interpret=True)
    got = rope.fused_rotary(_t(x.astype(jnp.float32)).to(torch.bfloat16), _t(cos), _t(sin), hd)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0**-8, atol=0)


@pytest.mark.parametrize("causal,q_offset,hd,S,len1", [
    pytest.param(True, 0, 128, 128, 77, id="True-0"),
    pytest.param(False, 0, 128, 128, 77, id="False-0"),
    pytest.param(True, 5, 128, 128, 77, id="True-5"),
    # CLIP's form: hd 64, not causal, kv_lens below S, S no multiple of
    # the 64-row blocks (the JAX grid is pl.cdiv over them).
    pytest.param(False, 0, 64, 100, 61, id="hd64-not_causal-S100"),
])
def test_flash_attention_fwd_bsh_matches_jax_interpret(causal, q_offset, hd, S, len1):
    rng = np.random.default_rng(3)
    B, H = 2, 2
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    lens = np.array([S - 3 if hd == 64 else S, len1], np.int32)
    kw = dict(causal=causal, scale=hd**-0.5, q_offset=q_offset)
    ref = j_flash_bsh(
        *(jnp.asarray(a) for a in (q, k, v, lens)), block_q=64, block_k=64,
        interpret=True, **kw,
    )
    got = attention.flash_attention_fwd_bsh(*(_t(a) for a in (q, k, v, lens)), **kw)
    for b, n in enumerate(lens):  # rows past kv_len are invalid by contract
        _close(got[b, :n], np.asarray(ref)[b, :n])


def test_attention_xla_matches_jax():
    rng = np.random.default_rng(4)
    B, Sq, Sk, H, Hkv, hd = 2, 5, 11, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    bias = rng.standard_normal((B, 1, Sq, Sk)).astype(np.float32)
    lens = np.array([11, 7], np.int32)
    for kw in (dict(causal=True, q_offset=6), dict(bias="b"), dict(kv_lens="l")):
        jkw = {k_: (jnp.asarray(bias) if v_ == "b" else jnp.asarray(lens) if v_ == "l" else v_)
               for k_, v_ in kw.items()}
        tkw = {k_: (_t(bias) if v_ == "b" else _t(lens) if v_ == "l" else v_)
               for k_, v_ in kw.items()}
        ref = j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
        _close(attention.attention_xla(_t(q), _t(k), _t(v), **tkw), ref)


def test_window_attention_grid_matches_jax_interpret():
    rng = np.random.default_rng(5)
    N, H, hd, W = 2, 2, 80, 14
    S = W * W
    y = rng.standard_normal((N, S, 3 * H * hd)).astype(np.float32)
    a = rng.standard_normal((N, S, H * W)).astype(np.float32)
    b = rng.standard_normal((N, S, H * W)).astype(np.float32)
    kw = dict(num_heads=H, head_dim=hd, window=W, scale=hd**-0.5)
    ref = jsam.fused_window_attention_grid(
        jnp.asarray(y), jnp.asarray(a), jnp.asarray(b), interpret=True, **kw
    )
    _close(sam_attention.fused_window_attention_grid(_t(y), _t(a), _t(b), **kw), ref)


@pytest.mark.parametrize("exp_bf16", [False, True], ids=["exp_fp32", "exp_bf16"])
def test_global_attention_and_bias_terms_match_jax_interpret(exp_bf16):
    """K4 in both exponential forms (the bf16 one, the serving form, rounds
    s - m and p to bf16: held at 2e-2)."""
    rng = np.random.default_rng(6)
    B, H, W, hd = 1, 2, 16, 80
    S = W * W
    qg = rng.standard_normal((B, H, W, W, hd)).astype(np.float32)
    rh = 0.1 * rng.standard_normal((2 * W - 1, hd)).astype(np.float32)
    rw = 0.1 * rng.standard_normal((2 * W - 1, hd)).astype(np.float32)
    A, Bb = sam_attention.decomposed_bias_terms(_t(qg), _t(rh), _t(rw), W)
    jA, jB = jsam.decomposed_bias_terms(jnp.asarray(qg), jnp.asarray(rh), jnp.asarray(rw), W)
    _close(A, jA)
    _close(Bb, jB)

    N = B * H
    q = qg.reshape(N, S, hd)
    k, v = (rng.standard_normal((N, S, hd)).astype(np.float32) for _ in range(2))
    jA, jB = (np.asarray(t).reshape(N, S, W) for t in (jA, jB))
    ref = jsam.fused_global_attention(
        *(jnp.asarray(t) for t in (q, k, v, jA, jB)), window=W, scale=hd**-0.5,
        block_q=128, block_k=128, exp_bf16=exp_bf16, interpret=True,
    )
    got = sam_attention.fused_global_attention(
        *(_t(t) for t in (q, k, v, jA, jB)), window=W, scale=hd**-0.5, exp_bf16=exp_bf16
    )
    if exp_bf16:
        _close(got, ref, atol=2e-2, rtol=2e-2)
    else:
        _close(got, ref)
