"""Template builders: datasets that draw questions from a template bank
(counterpart of `ullava_tpu/data/builders/template_type_builder.py`):
RefCOCO* -> ResDataset (+8 val/test splits -> ValResDataset), ade20k /
cocostuff / paco_lvis / pascal_part -> semantic seg, msra_10k / msra_b ->
salient, dut_omron / duts_te / ecssd -> val salient.
"""

from __future__ import annotations

from ullava_tpu_torch.data.builders.base_builder import BaseDatasetBuilder
from ullava_tpu_torch.data.datasets import (
    CocoStuffDataset,
    PacoDataset,
    ResDataset,
    SalientSegDataset,
    SemanticSegDataset,
    ValResDataset,
    ValSalientSegDataset,
)
from ullava_tpu_torch.registry import registry


class TemplateBuilder(BaseDatasetBuilder):
    dataset_cls = ResDataset

    def build(self, processor_cfg=None):
        cfg = self.config
        build_info = cfg.get("build_info", {})
        vis_processor = self.fetch_processor(cfg.get("vis_processor"), processor_cfg)
        return self.dataset_cls(
            vis_processor=vis_processor,
            tokenizer=self.tokenizer,
            vis_root=build_info.get("image_dir", ""),
            ann_root=build_info.get("anno_dir", ""),
            template_root=build_info.get("template_root", ""),
            portion=float(build_info.get("portion", 1.0)),
            image_token_len=int(cfg.get("image_token_len", 256)),
            data_type=cfg.get("data_type", "image"),
            conv_type=self.conv_type,
            sam_size=int(cfg.get("sam_image_size", 1024)),
        )


for _name in ("refcoco", "refcoco+", "refcocog", "refclef"):
    registry.register_builder(_name)(TemplateBuilder)


class ValResBuilder(TemplateBuilder):
    dataset_cls = ValResDataset


for _name in (
    "refcoco_val", "refcoco_testA", "refcoco_testB",
    "refcoco+_val", "refcoco+_testA", "refcoco+_testB",
    "refcocog_val", "refcocog_test",
):
    registry.register_builder(_name)(ValResBuilder)


@registry.register_builder("ade20k")
class Ade20kBuilder(TemplateBuilder):
    dataset_cls = SemanticSegDataset


@registry.register_builder("cocostuff")
class CocoStuffBuilder(TemplateBuilder):
    dataset_cls = CocoStuffDataset

    def build(self, processor_cfg=None):
        cfg = self.config
        build_info = cfg.get("build_info", {})
        vis_processor = self.fetch_processor(cfg.get("vis_processor"), processor_cfg)
        return self.dataset_cls(
            vis_processor=vis_processor,
            tokenizer=self.tokenizer,
            vis_root=build_info.get("image_dir", ""),
            ann_root=build_info.get("anno_dir", ""),
            template_root=build_info.get("template_root", ""),
            portion=float(build_info.get("portion", 1.0)),
            image_token_len=int(cfg.get("image_token_len", 256)),
            data_type=cfg.get("data_type", "image"),
            conv_type=self.conv_type,
            sam_size=int(cfg.get("sam_image_size", 1024)),
            # the '-'-class drop list (COCO-Stuff labels.txt, external
            # dataset metadata — see templates/README.md)
            class_file=build_info.get("class_file"),
        )


class PacoBuilder(TemplateBuilder):
    dataset_cls = PacoDataset


registry.register_builder("paco_lvis")(PacoBuilder)
registry.register_builder("pascal_part")(PacoBuilder)


class SalientBuilder(TemplateBuilder):
    dataset_cls = SalientSegDataset


registry.register_builder("msra_10k")(SalientBuilder)
registry.register_builder("msra_b")(SalientBuilder)


class ValSalientBuilder(TemplateBuilder):
    dataset_cls = ValSalientSegDataset


for _name in ("dut_omron", "duts_te", "ecssd"):
    registry.register_builder(_name)(ValSalientBuilder)
