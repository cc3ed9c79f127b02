"""Evaluation metrics and meters (counterpart of
`ullava_tpu/evaluation/tools.py`): `bbox_iou` with the x1000 scaling that
dodges degenerate tiny areas, histogram intersection / union for cIoU and
gIoU, and `AverageMeter`, whose `all_reduce` sums over the processes of an
initialised `torch.distributed` group.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np


class Summary(enum.Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f", summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1):
        val = float(np.asarray(val))
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def all_reduce(self):
        """Aggregate across processes when `torch.distributed` runs."""
        import torch

        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            total = torch.tensor([self.sum, self.count], dtype=torch.float64)
            dist.all_reduce(total)
            self.sum, self.count = float(total[0]), float(total[1])
            self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"

    def summary(self):
        if self.summary_type is Summary.AVERAGE:
            return f"{self.name} {self.avg:.4f}"
        if self.summary_type is Summary.SUM:
            return f"{self.name} {self.sum:.4f}"
        if self.summary_type is Summary.COUNT:
            return f"{self.name} {self.count:.0f}"
        return ""


def bbox_iou(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Element-wise IoU of xyxy boxes with the reference's x1000 scaling
    (normalized boxes have tiny areas; scaling sidesteps fp underflow)."""
    b1 = np.asarray(box1, np.float64) * 1000.0
    b2 = np.asarray(box2, np.float64) * 1000.0
    x0 = np.maximum(b1[..., 0], b2[..., 0])
    y0 = np.maximum(b1[..., 1], b2[..., 1])
    x1 = np.minimum(b1[..., 2], b2[..., 2])
    y1 = np.minimum(b1[..., 3], b2[..., 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (area1 + area2 - inter + eps)


def intersection_and_union(
    pred: np.ndarray, target: np.ndarray, num_classes: int = 2, ignore_index: int = 255
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Histogram-based intersection, union and target area, host numpy."""
    pred = np.asarray(pred).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    pred[target == ignore_index] = ignore_index
    inter = pred[pred == target]
    bins = np.arange(num_classes + 1)
    area_inter = np.histogram(inter, bins=bins)[0]
    area_pred = np.histogram(pred, bins=bins)[0]
    area_target = np.histogram(target, bins=bins)[0]
    return (
        area_inter.astype(np.float64),
        (area_pred + area_target - area_inter).astype(np.float64),
        area_target.astype(np.float64),
    )
