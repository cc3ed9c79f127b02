"""The port's SAM prompt encoder against the JAX package's
`prompt_encoder.encode_prompts` at tiny fp32 sizes: point prompts (with
the padding point that a prompt without a box gets, and without it
beside a box), labels -1, 0 and 1, boxes, mask prompts through the
downscaling convs, and the projected [SEG] text embeddings, alone and
together, on parameters drawn from a numpy seed and carried across by
`bridge.params_from_jax`.

Tolerance 2e-5 absolute and relative: fp32 sines and cosines of the same
projections, and three small convs and two LayerNorms summed in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models.sam import prompt_encoder as jprompt
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models.sam import prompt_encoder

TOL = 2e-5
B = 3

CASES = {
    "points_padded": dict(points=2),
    "points_padded_labels": dict(points=3, labels=(1, 0, -1)),
    "boxes": dict(boxes=1),
    "points_and_box": dict(points=2, boxes=1),
    "two_boxes": dict(boxes=2),
    "mask": dict(masks=True),
    "text": dict(text=2),
    "all": dict(points=2, boxes=1, masks=True, text=1),
}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jprompt.SamPromptConfig.tiny()
    cfg = prompt_encoder.SamPromptConfig.tiny()
    jparams = random_params(jprompt.init_params, jcfg, seed=0, std=0.5)
    return jcfg, cfg, jparams, params_from_jax(jparams, device="cpu")


def _inputs(case, cfg, rng):
    """numpy prompts of one case, in pixels of the tiny 64-pixel frame."""
    g, D, S = cfg.image_embedding_size, cfg.embed_dim, cfg.input_image_size
    out = {}
    if "points" in case:
        n = case["points"]
        labels = np.asarray(case.get("labels") or rng.integers(0, 2, n), np.int32)
        out["points"] = ((rng.random((B, n, 2)) * S).astype(np.float32),
                         np.broadcast_to(labels, (B, n)).copy())
    if "boxes" in case:
        xy = np.sort(rng.random((B, case["boxes"], 2, 2)) * S, axis=2)
        out["boxes"] = xy.reshape(B, case["boxes"], 4).astype(np.float32)
    if case.get("masks"):
        out["masks"] = rng.standard_normal((B, 4 * g, 4 * g, 1)).astype(np.float32)
    if "text" in case:
        out["text_embeds"] = rng.standard_normal((B, case["text"], D)).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_prompts_matches_jax(tiny, name):
    jcfg, cfg, jparams, params = tiny
    kw = _inputs(CASES[name], cfg, np.random.default_rng(len(name)))
    jkw = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in kw.items()}
    tkw = {k: (tuple(torch.as_tensor(a) for a in v) if isinstance(v, tuple) else torch.as_tensor(v))
           for k, v in kw.items()}
    jsparse, jdense = jprompt.encode_prompts(jparams, jcfg, batch=B, **jkw)
    sparse, dense = prompt_encoder.encode_prompts(params, cfg, batch=B, **tkw)
    assert sparse.shape == jsparse.shape and dense.shape == jdense.shape
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=TOL, rtol=TOL)


def test_padding_point_only_without_a_box(tiny):
    """A prompt of points alone gets one padding point (label -1, the
    not-a-point embedding); beside a box it does not."""
    jcfg, cfg, jparams, params = tiny
    pts = torch.full((1, 2, 2), 10.0)
    lab = torch.ones((1, 2), dtype=torch.int32)
    box = torch.tensor([[[4.0, 4.0, 30.0, 40.0]]])
    alone, _ = prompt_encoder.encode_prompts(params, cfg, batch=1, points=(pts, lab))
    boxed, _ = prompt_encoder.encode_prompts(params, cfg, batch=1, points=(pts, lab), boxes=box)
    assert alone.shape[1] == 3 and boxed.shape[1] == 4
    assert torch.equal(alone[0, 2], params["not_a_point"])
    assert torch.equal(alone[:, :2], boxed[:, :2])


def test_init_params_has_every_jax_leaf_and_keeps_the_generator_draws():
    cfg = prompt_encoder.SamPromptConfig.tiny()
    jshapes = {k: tuple(v.shape) for k, v in random_params(
        jprompt.init_params, jprompt.SamPromptConfig.tiny(), seed=0).items()}
    gen = torch.Generator().manual_seed(5)
    p = prompt_encoder.init_params(cfg, gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == jshapes
    # The text-prompt leaves are the generator's first draws, and the
    # generator ends where those two draws leave it.
    ref = torch.Generator().manual_seed(5)
    pe = torch.randn((2, cfg.embed_dim // 2), generator=ref)
    no_mask = torch.randn((cfg.embed_dim,), generator=ref) * 0.02
    assert torch.equal(p["pe_gaussian"], pe) and torch.equal(p["no_mask"], no_mask)
    assert torch.equal(torch.randn(4, generator=gen), torch.randn(4, generator=ref))
