"""Pretrain / finetune task: every configured dataset in one
ConcatDatasetWithShuffle with the fixed shuffle seed 42 and portion 1
(counterpart of `ullava_tpu/tasks/image_text_pretrain.py`)."""

from __future__ import annotations

from ullava_tpu_torch.data.datasets import ConcatDatasetWithShuffle
from ullava_tpu_torch.registry import registry
from ullava_tpu_torch.tasks.base_task import BaseTask


@registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    def build_datasets(self, dataset_cfg, tokenizer, processor_cfg=None,
                       conv_type: str = "conv_simple"):
        datasets = super().build_datasets(
            dataset_cfg, tokenizer, processor_cfg, conv_type
        )
        return ConcatDatasetWithShuffle(list(datasets.values()), seed=42, portion=1)
