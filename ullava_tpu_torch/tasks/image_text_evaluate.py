"""Evaluate task: one dataset per eval set, as a name -> dataset dict
(counterpart of `ullava_tpu/tasks/image_text_evaluate.py`)."""

from __future__ import annotations

from ullava_tpu_torch.registry import registry
from ullava_tpu_torch.tasks.base_task import BaseTask


@registry.register_task("image_text_evaluate")
class ImageTextEvaluateTask(BaseTask):
    def build_datasets(self, dataset_cfg, tokenizer, processor_cfg=None,
                       conv_type: str = "conv_simple"):
        return super().build_datasets(dataset_cfg, tokenizer, processor_cfg, conv_type)
