"""The port's plain int8 quantizers divide as the JAX package does.

`127.0 / amax` on a torch tensor is a reciprocal followed by a multiply,
which misses the IEEE quotient of about a quarter of all fp32 divisors by
one ulp; the JAX lines these quantizers mirror (`ullava_tpu/ops/quant.py`
`apply_linear_a8`, `mlp_kernel.py` `_silu_mul_quant_kernel`, `norms.py`
`_rms_quant_kernel`) and the CUDA kernels divide. A quotient one ulp off
moves `x * (127 / amax)` across a .5 boundary only for a few values in a
hundred thousand, so random rows rarely show it: these tests build rows
whose abs-max is such a divisor and which hold a value whose code the two
forms round apart, and hold the int8 codes (for `apply_linear_a8`, its
output) BIT-equal to the JAX functions', their Pallas kernels in
interpret mode. Every pre-quantization value is exact in both frameworks
by construction (powers of two where a product or a norm enters), so no
tolerance is needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.ops import mlp_kernel as jmlp
from ullava_tpu.ops import norms as jnorms
from ullava_tpu.ops import quant as jquant
from ullava_tpu_torch.ops import mlp_kernel, norms, quant

_F32 = np.float32
_ROWS, _WIDTH = 16, 256


def setup_module():
    torch.set_num_threads(1)


def _quotients(amax):
    """(IEEE 127 / amax, 127 * (1 / amax)) in fp32."""
    amax = np.asarray(amax, _F32)
    return _F32(127.0) / amax, _F32(127.0) * (_F32(1.0) / amax)


def _flipping_pair(rng):
    """An abs-max A whose two quotients differ and a value b < A whose code
    round(b * 127 / A) the reciprocal form rounds to the other integer."""
    while True:
        a = _F32(rng.uniform(0.5, 8.0))
        div, rec = _quotients(a)
        if div == rec:
            continue
        # The fp32 values a few ulps around a .5 boundary of the codes.
        b = _F32((rng.integers(1, 126) + 0.5) * float(a) / 127.0)
        for _ in range(8):
            b = np.nextafter(b, _F32(0.0), dtype=_F32)
        for _ in range(17):
            if np.rint(b * div) != np.rint(b * rec):
                return a, b
            b = np.nextafter(b, _F32(np.inf), dtype=_F32)


def _code_flips(t):
    """Per row: does the reciprocal form give another code than division?"""
    amax = np.maximum(np.abs(t).max(-1, keepdims=True), _F32(1e-12))
    div, rec = _quotients(amax)
    return (np.rint(t * div) != np.rint(t * rec)).any(-1)


def _designed_rows(seed, rows=_ROWS, width=_WIDTH):
    """[rows, width] fp32: row i holds its abs-max A_i and a value b_i of a
    flipping pair (random signs and columns) among values below A_i."""
    rng = np.random.default_rng(seed)
    t = np.empty((rows, width), _F32)
    for i in range(rows):
        a, b = _flipping_pair(rng)
        row = (rng.uniform(-1.0, 1.0, width) * 0.49 * float(a)).astype(_F32)
        cols = rng.choice(width, 2, replace=False)
        row[cols[0]] = a * rng.choice([-1, 1])
        row[cols[1]] = b * rng.choice([-1, 1])
        t[i] = row
    flips = _code_flips(t)
    assert flips.any(), "no row where the reciprocal form moves a code"
    return t, flips


def test_apply_linear_a8_divides_like_jax():
    x, _ = _designed_rows(0)
    rng = np.random.default_rng(1)
    w = jquant.quantize_int8(jnp.asarray(rng.standard_normal((_WIDTH, 40)).astype(_F32)))
    tw = {"q": quant.column_major(torch.from_numpy(np.array(w["q"]))),
          "scale": torch.from_numpy(np.array(w["scale"]))}
    ref = np.asarray(jquant.apply_linear_a8(jnp.asarray(x), w))
    got = quant.apply_linear_a8(torch.from_numpy(x), tw).numpy()
    # The int32 products are exact and the rescale is the same three fp32
    # products in the same order, so equal codes give equal outputs.
    np.testing.assert_array_equal(got, ref)


def test_silu_mul_quant_plain_divides_like_jax():
    h, _ = _designed_rows(2)
    # sigmoid(32) is 1.0 in fp32, so silu(g) * u = 32 * (h / 32) = h exactly.
    g = np.full_like(h, 32.0)
    u = h / _F32(32.0)
    jq, js = jmlp.silu_mul_quant(jnp.asarray(g), jnp.asarray(u), interpret=True)
    q, s = mlp_kernel.silu_mul_quant_plain(torch.from_numpy(g), torch.from_numpy(u))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("residual", [True, False])
def test_rms_norm_residual_quant_plain_divides_like_jax(residual):
    """The normed row is n = xf * rsqrt(mean(xf^2) + eps) * w. Row i of xf
    is +-64 on 16 of its 256 columns and 0 elsewhere, so mean(xf^2) = 256
    (eps is below its half ulp) and the norm is exactly 1/16: n = +-4 w on
    those columns. w holds every row's flipping pair and values below each
    A_i on the other columns a row takes."""
    rng = np.random.default_rng(3)
    pairs = [_flipping_pair(rng) for _ in range(_ROWS)]
    a_min = min(float(a) for a, _ in pairs)
    w = (rng.uniform(-1.0, 1.0, _WIDTH) * 0.49 * a_min).astype(_F32)
    w[:_ROWS] = [a for a, _ in pairs]
    w[_ROWS:2 * _ROWS] = [b for _, b in pairs]
    xf = np.zeros((_ROWS, _WIDTH), _F32)
    for i in range(_ROWS):
        fill = rng.choice(np.arange(2 * _ROWS, _WIDTH), 14, replace=False)
        xf[i, np.concatenate([[i, _ROWS + i], fill])] = 64.0 * rng.choice([-1, 1], 16)
    assert _code_flips(xf / _F32(16.0) * w).any()
    x, res = (xf * _F32(0.75), xf * _F32(0.25)) if residual else (xf, None)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if residual:
        jh, jq, js = jnorms.rms_norm_residual_quant(jnp.asarray(x), jnp.asarray(res), jw, 1e-6,
                                                    interpret=True)
        h, q, s = norms.rms_norm_residual_quant_plain(torch.from_numpy(x), torch.from_numpy(res),
                                                      tw, 1e-6)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    else:
        jq, js = jnorms.rms_norm_quant(jnp.asarray(x), jw, 1e-6, interpret=True)
        _, q, s = norms.rms_norm_residual_quant_plain(torch.from_numpy(x), None, tw, 1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
