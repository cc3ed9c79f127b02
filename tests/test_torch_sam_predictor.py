"""The port's `SamPredictor` and `SamAutomaticMaskGenerator` against the
JAX package's on the same tiny SAM (parameters drawn from a numpy seed,
carried across by `bridge.params_from_jax`), mirroring
`tests/test_sam_predictor.py`: point, box and point + box prompts with
single- and multi-mask output, the automatic generator's kept set, its
RLEs and scores, and the host helpers `build_point_grid`,
`stability_score` and `mask_iou_matrix`.

The image is 48 x 64 against the tiny encoder's 64-pixel input, so the
longest side needs no resize and both packages encode the same pixels (a
resize differs by up to one 8-bit step between PIL and the port's
`resize_uint8`). The JAX encoder runs its XLA routes off the TPU (block
layout), the port its resident layout on the CPU. Tolerances: IoU
predictions and low-res logits 2e-4 absolute and relative (fp32 through
four encoder blocks, the neck and the decoder, sums in another order);
masks at least 99.9% of pixels equal (a logit within that noise of 0 may
land on the other side); the generator's kept set, areas and RLEs equal
(its thresholds sit far from any candidate's scores), its scores 2e-4.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import random_params
from ullava_tpu.models.sam import automatic as jautomatic
from ullava_tpu.models.sam import build as jbuild
from ullava_tpu.models.sam import predictor as jpredictor
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.data.tools import rle
from ullava_tpu_torch.models.sam import automatic, build, predictor

TOL = 2e-4


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jbuild.SamConfig.tiny(), build.SamConfig.tiny()
    jparams = random_params(jbuild.init_sam_params, jcfg, seed=0, std=0.2)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module")
def predictors(tiny):
    jcfg, cfg, jparams, params = tiny
    image = np.random.default_rng(0).integers(0, 255, (48, 64, 3), np.uint8)
    jp = jpredictor.SamPredictor(jparams, jcfg)
    p = predictor.SamPredictor(params, cfg, device="cpu")
    jp.set_image(image)
    p.set_image(image)
    return jp, p


def _close(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL)


PROMPTS = {
    "one_point": dict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1])),
    "two_points": dict(point_coords=np.array([[30.0, 20.0], [5.0, 40.0]]),
                       point_labels=np.array([1, 0])),
    "box": dict(box=np.array([5, 5, 40, 40])),
    "points_and_box": dict(point_coords=np.array([[30.0, 20.0], [12.0, 9.0]]),
                           point_labels=np.array([1, 1]), box=np.array([2, 3, 50, 44])),
}


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "single"])
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_predict_matches_jax(predictors, prompt, multimask):
    jp, p = predictors
    jm, ji, jl = jp.predict(**PROMPTS[prompt], multimask_output=multimask)
    m, i, lo = p.predict(**PROMPTS[prompt], multimask_output=multimask)
    n = 3 if multimask else 1
    assert m.shape == (n, 48, 64) and m.dtype == bool
    assert i.shape == (n,) and lo.shape == (n, 16, 16)
    _close(lo, jl)
    _close(i, ji)
    assert (m == jm).mean() >= 0.999


def test_predictor_embedding_and_sizes(predictors):
    jp, p = predictors
    assert p.original_size == jp.original_size and p.input_size == jp.input_size
    _close(p._embedding.numpy(), jp._embedding)
    with pytest.raises(RuntimeError):
        predictor.SamPredictor(p.params, p.cfg, device="cpu").predict(
            point_coords=np.zeros((1, 2)), point_labels=np.ones(1))


def test_point_grid_and_scores_match_jax():
    np.testing.assert_array_equal(automatic.build_point_grid(4), jautomatic.build_point_grid(4))
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 16, 16)) * 3
    np.testing.assert_array_equal(automatic.stability_score(logits),
                                  jautomatic.stability_score(logits))
    masks = rng.random((6, 12, 12)) > 0.5
    np.testing.assert_array_equal(automatic.mask_iou_matrix(masks),
                                  jautomatic.mask_iou_matrix(masks))


def _thresholds(jparams, jcfg, image, keep):
    """An IoU threshold halfway between the `keep`-th and the next largest
    of the JAX generator's candidate IoU predictions, so that summation
    noise cannot move a candidate across it."""
    gen = jautomatic.SamAutomaticMaskGenerator(jparams, jcfg, points_per_side=4)
    emb = gen._encode(jparams["image_encoder"],
                      gen.seg_tool.preprocess(gen.seg_tool.apply_image(image))[None])
    pts = gen.grid * np.array([64.0, 48.0])
    _, iou = gen._decode_all(jparams, emb, pts.astype(np.float32), np.ones(len(pts), np.int32))
    s = np.sort(np.asarray(iou).reshape(-1))[::-1]
    assert s[keep - 1] - s[keep] > 1e-3
    return float((s[keep - 1] + s[keep]) / 2)


def test_automatic_mask_generator_matches_jax(tiny):
    jcfg, cfg, jparams, params = tiny
    image = np.random.default_rng(1).integers(0, 255, (48, 64, 3), np.uint8)
    kw = dict(points_per_side=4, pred_iou_thresh=_thresholds(jparams, jcfg, image, 20),
              stability_score_thresh=-1.0, min_mask_area=0)
    ref = jautomatic.SamAutomaticMaskGenerator(jparams, jcfg, **kw).generate(image)
    got = automatic.SamAutomaticMaskGenerator(params, cfg, device="cpu", **kw).generate(image)
    assert len(ref) > 1 and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["point_coords"] == r["point_coords"]
        assert g["area"] == r["area"] and g["bbox"] == r["bbox"]
        assert g["segmentation"] == r["segmentation"]
        assert np.array_equal(rle.decode(g["segmentation"]), rle.decode(r["segmentation"]))
        np.testing.assert_allclose([g["predicted_iou"], g["stability_score"]],
                                   [r["predicted_iou"], r["stability_score"]], atol=TOL, rtol=TOL)


def test_automatic_mask_generator_empty_when_nothing_passes(tiny):
    _, cfg, _, params = tiny
    image = np.random.default_rng(2).integers(0, 255, (48, 64, 3), np.uint8)
    gen = automatic.SamAutomaticMaskGenerator(params, cfg, points_per_side=2,
                                              pred_iou_thresh=1e9, device="cpu")
    assert gen.generate(image) == []
