"""Base task: builds processors, the collator and the datasets from the
config (counterpart of `ullava_tpu/tasks/base_task.py`): processors by
registry name, the collator 'base_collator' unless the config names
another, datasets through their registered builders."""

from __future__ import annotations

from typing import Dict

from ullava_tpu_torch.registry import registry


class BaseTask:
    def __init__(self, task_cfg):
        self.config = task_cfg

    def build_processors(self, processor_cfg) -> Dict[str, object]:
        processors = {}
        for name in processor_cfg or {}:
            cls = registry.get_processor_class(name)
            if cls is None:
                raise KeyError(f"processor '{name}' is not registered")
            processors[name] = cls.from_config(processor_cfg.get(name))
        return processors

    def build_collator(self, pad_token_id: int, **kw):
        name = self.config.get("collator_type", "base_collator")
        cls = registry.get_collator_class(name)
        if cls is None:
            raise KeyError(f"collator '{name}' is not registered")
        return cls(pad_token_id, **kw)

    def build_datasets(self, dataset_cfg, tokenizer, processor_cfg=None,
                       conv_type: str = "conv_simple"):
        datasets = {}
        for name in dataset_cfg or {}:
            builder_cls = registry.get_builder_class(name)
            if builder_cls is None:
                raise KeyError(f"dataset builder '{name}' is not registered")
            builder = builder_cls(dataset_cfg.get(name), tokenizer, conv_type)
            datasets[name] = builder.build(processor_cfg)
        return datasets
