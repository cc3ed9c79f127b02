"""Salient-object segmentation datasets, MSRA-10K / MSRA-B (val: DUT-OMRON,
DUTS-TE, ECSSD) (counterpart of
`ullava_tpu/data/datasets/salient_seg_dataset.py`).

The SS template bank, an answer with the generated reason and tag, mask =
(label == 255), the box from the mask. The val variant asks the fixed
salient question. Images are read as `cv2.imread` + BGR -> RGB reads them
and labels as `np.array(PIL.Image.open(...))` does (`image_io`).
"""

from __future__ import annotations

import copy
import os

import numpy as np

from ullava_tpu_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_LOC_TOKEN,
    DEFAULT_SEG_TOKEN,
    DEFAULT_TAG_END,
    DEFAULT_TAG_START,
)
from ullava_tpu_torch.data.datasets.base_dataset import BaseDataset
from ullava_tpu_torch.data.tools.image_io import read_label, read_rgb
from ullava_tpu_torch.tokenization import preprocess, preprocess_image_text


class SalientSegDataset(BaseDataset):
    def __init__(self, vis_processor, tokenizer, vis_root, ann_root,
                 template_root, portion=1, image_token_len=256, seed=42,
                 data_type="image", conv_type="conv_simple", sam_size=1024):
        super().__init__(
            vis_processor=vis_processor, tokenizer=tokenizer, vis_root=vis_root,
            ann_root=ann_root, template_root=template_root, seed=seed,
            portion=portion, data_type=data_type, conv_type=conv_type,
            sam_size=sam_size,
        )
        self.image_token_len = image_token_len
        self.num_sentence_per_item = 1

    @staticmethod
    def get_label(label_path: str) -> np.ndarray:
        return read_label(label_path)

    def build_conversations(self, item):
        gpt = item["gpt"]
        reason, tag = gpt["reason"], gpt["tag"]
        question = self.random_choice_template()
        answer = (
            f"Sure. Mask: {DEFAULT_SEG_TOKEN}; Location: {DEFAULT_LOC_TOKEN}; "
            f"{DEFAULT_TAG_START}{tag.lower()}{DEFAULT_TAG_END}. "
            f"Explanation: {reason.lower()}"
        )
        return [
            {"from": "human", "value": question},
            {"from": "gpt", "value": answer},
        ]

    def __getitem__(self, idx):
        item = self.annotation[idx]
        image_path = os.path.join(self.vis_root, item["image_path"])
        label_path = os.path.join(self.vis_root, item["label_path"])
        image = read_rgb(image_path, library="cv2")
        label = self.get_label(label_path)

        height, width = label.shape[:2]
        mask = (label == 255).astype(np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]
        xyxy = self.det_tool.mask2bbox((mask > 0).astype(np.uint8))
        normalized_bbox = self.det_tool.pad_normalize_xyxy(xyxy, width, height)

        image_clip = self.prepare_clip_image(image)
        image_sam, resize = self.prepare_sam_image(image)

        conversations = self.build_conversations(item)
        sources = preprocess_image_text(copy.deepcopy(conversations), self.image_token_len)
        data = preprocess(sources, self.tokenizer, self.conv_type)

        return {
            "input_ids": data["input_ids"][0],
            "labels": data["labels"][0],
            "image": image_clip,
            "image_sam": image_sam,
            "seg_mask": mask[None],
            "boxes": np.asarray([normalized_bbox], np.float32),
            "raw_size": (height, width),
            "resize": tuple(resize),
        }


class ValSalientSegDataset(SalientSegDataset):
    def build_conversations(self, item):
        # The fixed val question and answer.
        question = DEFAULT_IMAGE_TOKEN + "\n" + "Find the salient object in the image."
        answer = f"Sure. Mask: {DEFAULT_SEG_TOKEN}; Location: {DEFAULT_LOC_TOKEN};"
        return [
            {"from": "human", "value": question},
            {"from": "gpt", "value": answer},
        ]
