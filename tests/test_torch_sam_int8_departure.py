"""What `torch_sam_int8_departure.py` found about the int8 SAM encoder's
departure from JAX at hd 64 (`test_torch_sam_hd64_int8.py`'s
`ENC_I8_MAX`, `ENC_I8_MEDIAN`): each block alone matches the JAX block to
fp32 noise once the JAX side rounds to bf16 where its kernels say they do,
and the encoder's gap is tie flips carried from block to block.

- K11 at hd 64 with bf16 exponentials, head group 4: XLA on the CPU keeps
  the JAX kernel's bf16 `exp` in fp32 by default
  (`xla_allow_excess_precision`), which is where the global block's own
  departure came from; compiled with that option off, the JAX kernel and
  the port's plain version agree to fp32 noise, in both score forms.
- One window block and one global block of the test's int8 encoder
  (`mlp_w8a8`, composite bias weights, the resident layout), alone on the
  same input at hd 64 and at hd 80: the median difference is fp32 noise
  (a handful of int8 codes at rounding ties move the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sam_int8_departure as dep
from ullava_tpu.models.sam import image_encoder as jie
from ullava_tpu.ops import sam_attention as jsam
from ullava_tpu_torch.models.sam import image_encoder
from ullava_tpu_torch.ops import sam_attention

HD = 64


def setup_module():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dots_i8", [False, True], ids=["bf16", "dots_i8"])
def test_global_y_hd64_exp_bf16_matches_jax_rounding_as_written(dots_i8):
    """K11's plain version at hd 64, 4 heads (head group 4), bf16
    exponentials, against the JAX kernel in interpret mode compiled with
    `dep.EXACT`: the median difference within 1e-6 of the largest value
    (fp32 sums in another order), the largest within 1e-3 (with int8
    scores a code at a rounding tie); the default compile keeps the bf16
    `exp` in fp32, and its median departs by more than 1e-5."""
    g, H = 32, 4
    rng = np.random.default_rng(33)
    S, C, scale = g * g, H * HD, HD**-0.5
    y = rng.standard_normal((1, S, 3 * C)).astype(np.float32)
    a, b = ((0.4 / scale * rng.standard_normal((1, S, H, g))).astype(np.float32)
            for _ in range(2))
    kw = dict(num_heads=H, head_dim=HD, window=g, scale=scale, head_group=4, exp_bf16=True,
              dots_i8=dots_i8)
    got = sam_attention.fused_global_attention_y(
        *(torch.from_numpy(t) for t in (y, a, b)), **kw).numpy()

    def jax_k11(opts):
        fn = jax.jit(lambda *t: jsam.fused_global_attention_y(*t, **kw, interpret=True),
                     compiler_options=opts)
        return np.asarray(fn(*(jnp.asarray(t) for t in (y, a, b))))

    top = np.abs(got).max()
    exact, excess = np.abs(got - jax_k11(dep.EXACT)), np.abs(got - jax_k11(None))
    assert np.median(exact) <= 1e-6 * top and exact.max() <= 1e-3 * top, (exact.max(), top)
    assert np.median(excess) > 1e-5 * top, (np.median(excess), top)


@pytest.mark.parametrize("kind", ["window", "global"])
@pytest.mark.parametrize("hd", [64, 80], ids=["hd64", "hd80_twin"])
def test_int8_encoder_block_alone_matches_jax(hd, kind):
    """One block of the int8 encoder (`dep.build`: the draw of
    `test_encode_int8_resident_dots_i8_matches_jax`, `attn_dots_i8` off) on
    one seeded input, the JAX block compiled with `dep.EXACT`: the median
    difference within 1e-6 of the largest output value, the largest within
    2e-2 (an int8 activation code one step over at a rounding tie moves
    the outputs of its row by about 1/127 of a term)."""
    jcfg, jq, cfg, params, _ = dep.build(hd, False)
    jfn, tfn = next((j, t) for k, j, t, _ in dep.blocks(jcfg, jq, cfg, params) if k == kind)
    x = np.random.default_rng(41).standard_normal((1, cfg.grid, cfg.grid, cfg.embed_dim))
    x = x.astype(np.float32)
    ref = np.asarray(jfn(jnp.asarray(x)))
    with torch.no_grad():
        got = tfn(torch.from_numpy(x)).numpy()
    err, top = np.abs(got - ref), np.abs(ref).max()
    assert np.median(err) <= 1e-6 * top, (np.median(err), top)
    assert err.max() <= 2e-2 * top, (err.max(), top)
    assert image_encoder._use_global_fused(params["global_blocks"][0], cfg, cfg.grid)
    assert jie._global_head_group(jcfg) == (4 if hd == 64 else 0)
