"""Batch evaluation harness: cIoU / gIoU (masks) and Prec@0.5 (boxes)
(counterpart of `ullava_tpu/evaluation/harness.py`).

A teacher-forced forward with the gold conversation (mask and box quality
at the gold token positions, not free generation), `ullava.forward(...,
inference=True)` under `no_grad` on the parameters' device; each sample's
masks post-processed on the host to its original resolution
(`sam/build.postprocess_masks_host`), histogram intersection and union
summed, box IoU scored at Prec@0.5.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ullava_tpu_torch.data.collators import GroundingCollator
from ullava_tpu_torch.data.loader import batch_to_device
from ullava_tpu_torch.evaluation.tools import AverageMeter, Summary, bbox_iou, intersection_and_union
from ullava_tpu_torch.models import ullava
from ullava_tpu_torch.models.sam.build import postprocess_masks_host
from ullava_tpu_torch.training.optim import named_leaves

logger = logging.getLogger(__name__)

_MODEL_KEYS = ("input_ids", "attn_lens", "images", "images_sam")


def _params_device(params) -> torch.device:
    """The device the parameters live on (that of their first tensor)."""
    for _, leaf in named_leaves(params):
        return leaf.device
    raise ValueError("no tensor in the parameters")


def validate(
    params,
    cfg: ullava.UllavaConfig,
    dataset,
    collator,
    forward_fn: Optional[Callable] = None,
    max_samples: Optional[int] = None,
    batch_size: int = 8,
) -> Dict[str, float]:
    """Teacher-forced eval over one dataset, `batch_size` samples a
    forward (the trailing batch padded with its last sample, so every
    forward has one shape); the per-sample post-processing at the
    original resolution stays on the host."""
    if forward_fn is None:
        def forward_fn(p, b):
            with torch.no_grad():
                return ullava.forward(p, cfg, **b, labels=None, inference=True)

    device = _params_device(params)
    inter_m = AverageMeter("Intersection", ":6.3f", Summary.SUM)
    union_m = AverageMeter("Union", ":6.3f", Summary.SUM)
    giou_m = AverageMeter("gIoU", ":6.3f", Summary.SUM)
    prec_m = AverageMeter("Prec@0.5", ":6.3f", Summary.SUM)

    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        samples = [dataset[i] for i in idxs]
        # Pad the trailing batch to keep one shape.
        while len(samples) < batch_size:
            samples.append(samples[-1])
        batch = collator(samples)
        model_batch = batch_to_device({k: batch[k] for k in _MODEL_KEYS if k in batch}, device)
        out = forward_fn(params, model_batch)

        seg_valid_b = out["seg_valid"].cpu().numpy()
        low_res_b = out["low_res_masks"].float().cpu().numpy()
        loc_valid_b = out["loc_valid"].cpu().numpy()
        pred_boxes_b = out["pred_boxes"].float().cpu().numpy()

        for bi in range(len(idxs)):
            sample = samples[bi]
            gt_masks = np.asarray(sample["seg_mask"])  # [K, H, W] original res
            raw = tuple(int(x) for x in sample["raw_size"])
            resize = tuple(int(x) for x in sample["resize"])

            k = min(int(seg_valid_b[bi].sum()), len(gt_masks))
            if k > 0:
                pred = postprocess_masks_host(
                    low_res_b[bi, :k], input_size=resize, original_size=raw,
                    img_size=cfg.sam.vision.img_size,
                )
                pred_bin = (pred > 0).astype(np.int32)
                for j in range(k):
                    inter, union, _ = intersection_and_union(
                        pred_bin[j], (gt_masks[j] > 0).astype(np.int32), 2, 255
                    )
                    inter_m.update(inter[1])
                    union_m.update(union[1])
                    acc_iou = inter / np.maximum(union, 1e-5)
                    acc_iou[union == 0] = 1.0  # empty-empty = full IoU
                    giou_m.update(acc_iou[1], n=1)

            gt_boxes = np.asarray(sample.get("boxes", np.zeros((0, 4))))
            kb = min(int(loc_valid_b[bi].sum()), len(gt_boxes))
            for j in range(kb):
                iou = bbox_iou(pred_boxes_b[bi, j], gt_boxes[j])
                prec_m.update(float(iou > 0.5), n=1)

    ciou = inter_m.sum / max(union_m.sum, 1e-10)
    return {
        "ciou": float(ciou),
        "giou": float(giou_m.avg),
        "prec@0.5": float(prec_m.avg),
        "n_masks": int(giou_m.count),
        "n_boxes": int(prec_m.count),
    }


def build_eval_datasets(eval_dataset_cfg, tokenizer, processor_cfg, conv_type):
    from ullava_tpu_torch.config import ConfigNode
    from ullava_tpu_torch.tasks import setup_task

    task = setup_task(ConfigNode({"type": "image_text_evaluate"}))
    return task.build_datasets(eval_dataset_cfg, tokenizer, processor_cfg, conv_type)


def make_teacher_forced_eval_fn(
    cfg: ullava.UllavaConfig,
    eval_dataset_cfg,
    tokenizer,
    processor_cfg,
    conv_type: str,
    model_max_length: int = 512,
    max_samples: Optional[int] = None,
    eval_max_masks: int = 10,
) -> Callable:
    """params -> {dataset_name: metrics}, the per-epoch eval. Val
    datasets carry up to 10 sentences an item, so the readout's slots
    widen to `eval_max_masks`."""
    cfg = dataclasses.replace(
        cfg,
        max_masks=max(cfg.max_masks, eval_max_masks),
        max_boxes=max(cfg.max_boxes, eval_max_masks),
    )
    datasets = build_eval_datasets(eval_dataset_cfg, tokenizer, processor_cfg, conv_type)
    collator = GroundingCollator(
        tokenizer.pad_token_id, model_max_length=model_max_length,
        max_masks=cfg.max_masks, mask_frame=cfg.mask_loss_frame,
    )

    def eval_fn(params):
        results = {}
        for name, ds in datasets.items():
            results[name] = validate(params, cfg, ds, collator, max_samples=max_samples)
            logger.info("[eval] %s: %s", name, results[name])
        return results

    return eval_fn
