"""Segmentation and grounding losses (counterpart of
`ullava_tpu/models/loss.py`), at fixed shapes: masks arrive as dense
[B, M, H, W] tensors with per-mask validity and a per-sample valid pixel
region, boxes as [B, N, 4] xyxy with per-box validity.

Aggregation as in the reference's stage-2 model: per-mask pixel-mean BCE
and per-mask dice, summed over the valid masks of the batch and divided
by (valid masks + 1e-8). The box losses are normalised twice: each
sample's error sum by that sample's box count, and the sum over samples
by the total box count again; the mask losses are not (the reference
multiplies their per-sample term by its mask count first). The dice keeps
the reference's `scale=1000` on numerator and denominator, and the GIoU
loss leaves degenerate predicted boxes out of its sum while they still
count in the denominators. Everything is computed in fp32. The batch-wide
counts (valid masks, valid boxes) are global: inside a sharded training
step `parallel.collectives.global_sum` adds them over the data ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullava_tpu_torch.parallel.collectives import global_sum


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Element-wise (IoU, union) of aligned boxes [..., 4] xyxy."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp_min(1e-12), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Element-wise GIoU of aligned boxes (the diagonal of the reference's
    pairwise matrix)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp_min(0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp_min(1e-12)


def _masked_mean_over_masks(per_mask: torch.Tensor, mask_valid: torch.Tensor) -> torch.Tensor:
    per_mask = torch.where(mask_valid, per_mask, torch.zeros_like(per_mask))
    return per_mask.sum() / (global_sum(mask_valid.sum()) + 1e-8)


def dice_loss(
    pred_logits: torch.Tensor,  # [B, M, H, W]
    gt_masks: torch.Tensor,  # [B, M, H, W] in {0, 1}
    mask_valid: torch.Tensor,  # [B, M] bool
    pixel_valid: Optional[torch.Tensor] = None,  # [B, H, W] bool
    scale: float = 1000.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Sum over valid masks of (1 - dice), / (num_valid + 1e-8)."""
    p = torch.sigmoid(pred_logits.float())
    t = gt_masks.float()
    if pixel_valid is not None:
        pv = pixel_valid[:, None].float()
        p, t = p * pv, t * pv
    num = 2.0 * (p / scale * t).sum((-2, -1))
    den = (p / scale).sum((-2, -1)) + (t / scale).sum((-2, -1))
    return _masked_mean_over_masks(1.0 - (num + eps) / (den + eps), mask_valid)


def sigmoid_ce_loss(
    pred_logits: torch.Tensor,  # [B, M, H, W]
    gt_masks: torch.Tensor,
    mask_valid: torch.Tensor,  # [B, M]
    pixel_valid: Optional[torch.Tensor] = None,  # [B, H, W]
) -> torch.Tensor:
    """Per-mask pixel-mean BCE with logits (over the valid pixels), summed
    over valid masks / (count + 1e-8)."""
    x = pred_logits.float()
    t = gt_masks.float()
    per_pixel = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    if pixel_valid is not None:
        pv = pixel_valid[:, None].float()
        per_mask = (per_pixel * pv).sum((-2, -1)) / pv.sum((-2, -1)).clamp_min(1.0)
    else:
        per_mask = per_pixel.mean((-2, -1))
    return _masked_mean_over_masks(per_mask, mask_valid)


def bbox_l1_loss(
    pred_boxes: torch.Tensor,  # [B, N, 4]
    gt_boxes: torch.Tensor,
    box_valid: torch.Tensor,  # [B, N]
) -> torch.Tensor:
    """Per-sample |err| sum / (n_b + 1e-8), summed, / (total + 1e-8)."""
    l1 = (pred_boxes.float() - gt_boxes.float()).abs()
    l1 = torch.where(box_valid[..., None], l1, torch.zeros_like(l1))
    per_sample = l1.sum((-2, -1)) / (box_valid.sum(-1) + 1e-8)
    return per_sample.sum() / (global_sum(box_valid.sum()) + 1e-8)


def bbox_giou_loss(
    pred_boxes: torch.Tensor,  # [B, N, 4]
    gt_boxes: torch.Tensor,
    box_valid: torch.Tensor,
) -> torch.Tensor:
    """Per-sample (1 - giou) summed over non-degenerate valid boxes /
    (n_b + 1e-8), summed over samples, / (total + 1e-8). A predicted box
    with x2 < x1 or y2 < y1 adds nothing but still counts."""
    ok = (pred_boxes[..., 2:] >= pred_boxes[..., :2]).all(-1) & box_valid
    giou = generalized_box_iou(pred_boxes.float(), gt_boxes.float())
    per_box = torch.where(ok, 1.0 - giou, torch.zeros_like(giou))
    per_sample = per_box.sum(-1) / (box_valid.sum(-1) + 1e-8)
    return per_sample.sum() / (global_sum(box_valid.sum()) + 1e-8)
