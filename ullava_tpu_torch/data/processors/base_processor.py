"""Base processor: identity transform + from_config (counterpart of
`ullava_tpu/data/processors/base_processor.py`)."""

from __future__ import annotations

from ullava_tpu_torch.registry import registry


class BaseProcessor:
    def __init__(self):
        self.transform = lambda x: x

    def __call__(self, item):
        return self.transform(item)

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


registry.register_processor("base_processor")(BaseProcessor)
