"""Dataset builders: per-dataset config -> dataset instance (counterpart
of `ullava_tpu/data/builders/base_builder.py`): holds the YAML sub-config,
resolves processor names through the registry and constructs the dataset
class."""

from __future__ import annotations

from typing import Optional

from ullava_tpu_torch.registry import registry


class BaseDatasetBuilder:
    dataset_cls = None

    def __init__(self, cfg=None, tokenizer=None, conv_type: str = "conv_simple"):
        self.config = cfg
        self.tokenizer = tokenizer
        self.conv_type = conv_type

    @staticmethod
    def fetch_processor(processor_name: Optional[str], processor_cfg=None):
        if processor_name is None:
            return None
        cls = registry.get_processor_class(processor_name)
        if cls is None:
            raise KeyError(f"processor '{processor_name}' is not registered")
        sub_cfg = None
        if processor_cfg is not None:
            sub_cfg = processor_cfg.get(processor_name)
        return cls.from_config(sub_cfg)

    def build(self, processor_cfg=None):
        cfg = self.config
        build_info = cfg.get("build_info", {})
        vis_processor = self.fetch_processor(cfg.get("vis_processor"), processor_cfg)
        return self.dataset_cls(
            vis_processor=vis_processor,
            tokenizer=self.tokenizer,
            vis_root=build_info.get("image_dir", ""),
            ann_root=build_info.get("anno_dir", ""),
            portion=float(build_info.get("portion", 1.0)),
            image_token_len=int(cfg.get("image_token_len", 256)),
            data_type=cfg.get("data_type", "image"),
            conv_type=self.conv_type,
        )
