"""Evaluation layer: metrics, meters and the batch eval harness
(counterpart of `ullava_tpu/evaluation/`)."""

from ullava_tpu_torch.evaluation.tools import (  # noqa: F401
    AverageMeter,
    Summary,
    bbox_iou,
    intersection_and_union,
)
