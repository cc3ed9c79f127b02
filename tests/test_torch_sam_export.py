"""The port's SAM decoder export against the JAX package's at tiny fp32
sizes: `make_decoder_fn` (the padded point prompt, the gated mask
embedding for `has_mask_input` 0 and 1, every mask token, the multi-click
reweighting of token 0 for one and for three points, single- and
multi-mask output, stability scores in place of the IoU head) against
the JAX function on the same numpy inputs, `stability_score_t` against
`stability_score_jnp`, and a `torch.export` round trip on the CPU: the
loaded program gives the function's outputs bit for bit.

Tolerance: 2e-4 absolute and relative on logits and IoU predictions (fp32
through the two-way transformer and the upscaling, sums in another
order); stability scores 2e-2, since a logit within that noise of +/-1
moves one pixel of a 16 x 16 mask in or out (1/256 of a score's count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models.sam import build as jbuild
from ullava_tpu.models.sam import export as jexport
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import build, export

TOL = 2e-4
STAB_TOL = 2e-2


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jbuild.SamConfig.tiny(), build.SamConfig.tiny()
    jparams = random_params(jbuild.init_sam_params, jcfg, seed=4, std=0.2)
    return jcfg, cfg, jparams, params_from_jax(jparams, device="cpu")


def _inputs(cfg, B, n, seed):
    rng = np.random.default_rng(seed)
    g, D, S = cfg.prompt.image_embedding_size, cfg.prompt.embed_dim, cfg.prompt.input_image_size
    labels = rng.integers(-1, 2, (B, n)).astype(np.int32)
    labels[:, 0] = 1
    return (rng.standard_normal((B, g, g, D)).astype(np.float32),
            (rng.random((B, n, 2)) * S).astype(np.float32), labels,
            rng.standard_normal((B, 4 * g, 4 * g, 1)).astype(np.float32),
            np.asarray([1.0, 0.0][:B], np.float32))


@pytest.mark.parametrize("single", [True, False], ids=["single_mask", "all_masks"])
@pytest.mark.parametrize("stability", [False, True], ids=["iou_head", "stability"])
@pytest.mark.parametrize("n", [1, 3], ids=["one_point", "three_points"])
def test_make_decoder_fn_matches_jax(tiny, single, stability, n):
    """Batch 2: sample 0 with its mask prompt (has_mask_input 1), sample 1
    with the no-mask embedding (0)."""
    jcfg, cfg, jparams, params = tiny
    args = _inputs(cfg, 2, n, seed=n)
    kw = dict(return_single_mask=single, use_stability_score=stability)
    ref = jax.jit(jexport.make_decoder_fn(jparams, jcfg, **kw))(*map(jnp.asarray, args))
    got = export.make_decoder_fn(params, cfg, **kw)(*map(torch.as_tensor, args))
    M = 1 if single else cfg.decoder.num_mask_tokens
    assert got[0].shape == (2, M, 64, 64) and got[2].shape == (2, M, 16, 16)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=STAB_TOL if stability else TOL, rtol=TOL)


def test_mask_input_moves_the_masks(tiny):
    """The gate: has_mask_input 0 leaves the mask prompt out entirely."""
    _, cfg, _, params = tiny
    emb, pts, lab, mask, _ = _inputs(cfg, 1, 2, seed=7)
    fn = export.make_decoder_fn(params, cfg, return_single_mask=False)
    t = [torch.as_tensor(a) for a in (emb, pts, lab, mask)]
    off = fn(*t, torch.zeros(1))
    on = fn(*t, torch.ones(1))
    other = fn(*t[:3], torch.as_tensor(mask) * 3.0, torch.zeros(1))
    assert not torch.allclose(off[2], on[2])
    assert torch.equal(off[2], other[2])


def test_stability_score_t_matches_jax():
    logits = np.random.default_rng(3).standard_normal((2, 4, 16, 16)).astype(np.float32) * 2
    ref = jexport.stability_score_jnp(jnp.asarray(logits))
    got = export.stability_score_t(torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,single", [(1, True), (3, False)])
def test_export_round_trip_on_cpu(tiny, n, single):
    _, cfg, _, params = tiny
    blob = export.export_sam_decoder(params, cfg, num_points=n, return_single_mask=single)
    assert isinstance(blob, bytes) and len(blob) > 0
    loaded = export.load_sam_decoder(blob)
    args = [torch.as_tensor(a) for a in _inputs(cfg, 1, n, seed=11)]
    want = export.make_decoder_fn(params, cfg, return_single_mask=single)(*args)
    got = loaded(*args)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
