"""Plain builders: datasets configured by annotation and image dirs only
(counterpart of `ullava_tpu/data/builders/plain_type_builder.py`):
llava_cc3m / llava_instruct / sqa / llava_v1_5_mix665k -> LLaVADataset,
llava_seg -> LLaVASegDataset. `tgif` (the video path) is not ported yet:
its builder raises KeyError.
"""

from __future__ import annotations

from ullava_tpu_torch.data.builders.base_builder import BaseDatasetBuilder
from ullava_tpu_torch.data.datasets import LLaVADataset, LLaVASegDataset
from ullava_tpu_torch.registry import registry


class PlainBuilder(BaseDatasetBuilder):
    dataset_cls = LLaVADataset


for _name in ("llava_cc3m", "llava_instruct", "sqa", "llava_v1_5_mix665k"):
    registry.register_builder(_name)(PlainBuilder)


@registry.register_builder("llava_seg")
class LLaVASegBuilder(PlainBuilder):
    dataset_cls = LLaVASegDataset


@registry.register_builder("tgif")
class TgifBuilder(BaseDatasetBuilder):
    """The video dataset's name, kept so that a YAML naming it fails with
    a reason: the video path (`data/processors/video_processor.py`,
    `data/tools/video_transforms.py`, `data/datasets/tgif_dataset.py`) is
    not ported yet."""

    def build(self, processor_cfg=None):
        raise KeyError("dataset builder 'tgif': the video path (video_processor, "
                       "video_transforms, tgif_dataset) is not ported to ullava_tpu_torch yet")
