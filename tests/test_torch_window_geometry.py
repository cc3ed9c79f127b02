"""Parity of the port's SAM window attention (K3, `fused_window_attention_grid`,
and K14, `fused_window_attention_rect`) with the JAX package's Pallas
kernels in interpret mode at the geometry the CUDA kernels are built for:
W 14, hd 80, 2 heads, 1-2 windows, bf16 inputs made with numpy from a seed.
On the CPU the port's wrappers run their plain versions, which repeat the
kernels' arithmetic: K3 on whole windows of 196 rows and in the padded
layout (200 rows, the 4 tail rows left out as keys), K14 on the ViT-H
boundary rectangles 14 x 8, 8 x 14, 8 x 8 and the two edges in one
dual-geometry call, each in both score forms.

Tolerances, in units of each output row's largest value: bf16 scores within
1e-2 (the two frameworks round P and the output to bf16 from fp32 sums
taken in another order: one bf16 ulp of the row's largest value is 2^-7 of
it); `dots_i8` within 2e-2 (q, k and the bias terms are quantized per row
on both sides with the same arithmetic, but a value within fp32
reassociation of .5 may round one int8 step apart, which moves a score by
about 1/127 of one term, as in the other int8-score tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import sam_attention

H, HD, W = 2, 80, 14
SCALE = HD**-0.5
KW = dict(num_heads=H, head_dim=HD, window=W, scale=SCALE)
FORMS = pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16_scores", "dots_i8"])


def setup_module():
    torch.set_num_threads(1)


def _bf16(a):
    """The same bf16 values on both sides: a numpy array rounded to bf16
    (as float32) and its JAX and torch bf16 copies."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _inputs(rng, N, S):
    """y [N, S, 3*H*HD] and the bias terms [N, S, H*W] at the encoder's
    size: q.rel_pos with an unscaled q (a few units), pre-scaled by 1/scale."""
    y = rng.standard_normal((N, S, 3 * H * HD))
    a, b = (2.0 / SCALE * rng.standard_normal((N, S, H * W)) for _ in range(2))
    return y, a, b


def _row_rel_err(got, ref):
    got = np.asarray(got, np.float32).reshape(-1, got.shape[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, ref.shape[-1])
    return float((np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max())


def _tol(dots_i8):
    return 2e-2 if dots_i8 else 1e-2


@FORMS
def test_window_grid_block_matches_jax(dots_i8):
    """Two whole windows of 196 rows."""
    y, a, b = (_bf16(t) for t in _inputs(np.random.default_rng(20), 2, W * W))
    ref = jsam.fused_window_attention_grid(y[1], a[1], b[1], **KW, dots_i8=dots_i8, interpret=True)
    got = sam_attention.fused_window_attention_grid(y[0], a[0], b[0], **KW, dots_i8=dots_i8)
    assert got.shape == (2, W * W, H * HD) and got.dtype == torch.bfloat16
    assert _row_rel_err(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) <= _tol(dots_i8)


@FORMS
def test_window_grid_padded_tail_rows_reach_no_real_row(dots_i8):
    """One window stored as 200 rows whose 4 tail rows (q, k, v and bias
    terms) are of magnitude 1e3: they are left out as keys, so the real
    rows match the JAX kernel's and are the compact window's bit for bit;
    the tail rows come out finite."""
    real, S = W * W, 200
    y, a, b = _inputs(np.random.default_rng(21), 1, S)
    for t in (y, a, b):
        t[:, real:] *= 1e3
    y, a, b = _bf16(y), _bf16(a), _bf16(b)
    ref = jsam.fused_window_attention_grid(y[1], a[1], b[1], **KW, dots_i8=dots_i8, total_rows=S,
                                           interpret=True)
    got = sam_attention.fused_window_attention_grid(y[0], a[0], b[0], **KW, total_rows=S,
                                                    dots_i8=dots_i8)
    assert bool(torch.isfinite(got).all())
    ref = np.asarray(ref.astype(jnp.float32))
    assert _row_rel_err(got[:, :real].float().numpy(), ref[:, :real]) <= _tol(dots_i8)
    compact = sam_attention.fused_window_attention_grid(
        y[0][:, :real], a[0][:, :real], b[0][:, :real], **KW, dots_i8=dots_i8)
    assert torch.equal(compact, got[:, :real])


_RECT = {"right": [(14, 8)], "bottom": [(8, 14)], "corner": [(8, 8)],
         "dual": [(14, 8), (8, 14)]}


def _rect_tables(geoms, qkv_bias):
    """(port's tables, JAX's tables) for each geometry, stacked with a
    leading halves axis for two."""
    qb_t, qb_j = qkv_bias
    port, jax_ = [], []
    for rows, cols in geoms:
        port.append((image_encoder._rect_onehot(rows, cols, W, torch.bfloat16, "cpu"),
                     *image_encoder._pad_tables(qb_t, rows, cols, W, H, HD, torch.bfloat16)))
        jax_.append((jie._rect_onehot(rows, cols, W, jnp.bfloat16),
                     *jie._pad_tables(qb_j, rows, cols, W, H, HD, jnp.bfloat16)))
    if len(geoms) == 1:
        return port[0], jax_[0]
    return (tuple(torch.stack([t[i] for t in port]) for i in range(3)),
            tuple(jnp.stack([t[i] for t in jax_]) for i in range(3)))


@FORMS
@pytest.mark.parametrize("cls", list(_RECT))
def test_window_rect_matches_jax(cls, dots_i8):
    """One boundary window of each geometry (two in the dual call), its pad
    keys from the encoder's tables (k and v the qkv bias)."""
    geoms = _RECT[cls]
    rng = np.random.default_rng(22)
    T = geoms[0][0] * geoms[0][1]
    y, a, b = (_bf16(t) for t in _inputs(rng, len(geoms), T))
    qkv_bias = _bf16(0.5 * rng.standard_normal(3 * H * HD))
    tables, jtables = _rect_tables(geoms, qkv_bias)
    for mine, theirs in zip(tables, jtables):
        np.testing.assert_array_equal(mine.float().numpy(), np.asarray(theirs.astype(jnp.float32)))
    ref = jsam.fused_window_attention_rect(y[1], a[1], b[1], *jtables, **KW, dots_i8=dots_i8,
                                           interpret=True)
    geometry = tuple(geoms) if len(geoms) == 2 else geoms[0]
    got = sam_attention.fused_window_attention_rect(y[0], a[0], b[0], *tables, **KW,
                                                    dots_i8=dots_i8, geometry=geometry)
    assert got.shape == (len(geoms), T, H * HD)
    assert _row_rel_err(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) <= _tol(dots_i8)
