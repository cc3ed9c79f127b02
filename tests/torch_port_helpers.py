"""Shared helpers of the port's parity tests (`test_torch_*.py`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ullava_tpu.models import ullava as jullava
from ullava_tpu_torch.models import ullava


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


def res_batch(cfg, rng, lens):
    """A right-padded batch of tiny RES requests (numpy): prompts with the
    image span after `<img_beg>`, CLIP images and SAM images."""
    P = cfg.core.vision.num_patches
    ids = rng.integers(5, 140, size=(len(lens), max(lens)))
    for b, n in enumerate(lens):
        ids[b, 1] = cfg.core.img_start_id
        ids[b, 2:2 + P] = 3
        ids[b, 2 + P] = cfg.core.img_end_id
        ids[b, n:] = 0
    return dict(
        input_ids=ids,
        prompt_lens=np.asarray(lens, np.int32),
        images=rng.standard_normal((len(lens), 28, 28, 3)).astype(np.float32),
        images_sam=rng.standard_normal((len(lens), 64, 64, 3)).astype(np.float32),
    )


def assert_int8_close(got, ref):
    """Int8 arrays rounded from fp32 values that the two frameworks sum in
    different orders: a value within that noise of .5 may round the other
    way, so (as the JAX package's own tests do) at least 99.9% must agree
    exactly and the rest within 1."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert (diff <= 1).all() and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


# `bench.py:855-859`: the adapters as `add_lora` names them, the heads and
# the mask decoder but its IoU head. Both packages get this tuple.
BENCH_LORA = (
    r"^core/llm/layers/(q|v)_proj_lora_(a|b)$",
    r"^seg_projector/", r"^det_projector/", r"^det_decoder/",
    r"^sam/mask_decoder/(?!iou_head)",
)


def stage2_cfgs(**kw):
    """The tiny stage-2 configs of both packages (finetuning: no detach of
    the text embeddings, as `configs/train/ullava_lora.yaml`)."""
    jcfg = jullava.UllavaConfig.tiny(**kw)
    jcfg = dataclasses.replace(jcfg, core=dataclasses.replace(jcfg.core, projector_from_scratch=False))
    cfg = ullava.UllavaConfig.tiny(**kw)
    cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, projector_from_scratch=False))
    return jcfg, cfg


def stage2_batch(cfg, rng, B=2, S=20):
    """`tests/test_ullava_stage2.py:125-148`'s batch: two [SEG] and one
    [LOC] in sample 0, one of each in sample 1, a shorter second sample,
    partly valid slots and padded SAM frames."""
    ids = rng.integers(5, 100, size=(B, S)).astype(np.int64)
    ids[0, 5] = ids[0, 8] = cfg.seg_token_idx
    ids[0, 11] = cfg.loc_token_idx
    ids[1, 4], ids[1, 7] = cfg.seg_token_idx, cfg.loc_token_idx
    F = cfg.mask_loss_frame
    return dict(
        input_ids=ids, labels=ids.copy(), attn_lens=np.array([S, S - 4], np.int32),
        images=rng.standard_normal((B, 28, 28, 3)).astype(np.float32),
        images_sam=rng.standard_normal((B, 64, 64, 3)).astype(np.float32),
        gt_masks=(rng.random((B, cfg.max_masks, F, F)) > 0.5).astype(np.float32),
        mask_valid=np.array([[True, True, False], [True, False, False]]),
        gt_boxes=rng.random((B, cfg.max_boxes, 4)).astype(np.float32),
        box_valid=np.array([[True, False, False], [True, False, False]]),
        input_hw=np.array([[64, 48], [32, 64]], np.int32),
    )


def jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if k == "input_ids" else v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
