"""Referring-expression segmentation / comprehension datasets, RefCOCO*
(counterpart of `ullava_tpu/data/datasets/res_dataset.py`).

At most 3 referring sentences an item at train (10 at val, drawn by the
global `np.random.choice`), the question from the SEG template bank (the
image marker only in the first round), the answer
``Sure. Mask: [SEG]; Location: [LOC]; [tag]<category>[/tag].``, COCO
polygon / RLE decode to a binary mask repeated once a round, xywh -> xyxy
-> pad-normalized boxes, and the fixed val question. The image is read
by `cv2.imread` + BGR -> RGB (`image_io`).
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
from ullava_tpu_torch.data.tools import rle as rle_codec
from ullava_tpu_torch.data.tools.image_io import read_rgb
from ullava_tpu_torch.tokenization import preprocess, preprocess_image_text

CLASS_TOKEN = "<class>"


def decode_segmentation(segmentation, height: int, width: int) -> np.ndarray:
    """COCO polygon / RLE -> binary uint8 mask (multi-part union)."""
    if len(segmentation) == 0:
        return np.zeros((height, width), np.uint8)
    if isinstance(segmentation[0], list):  # polygons
        rles = rle_codec.fr_poly(segmentation, height, width)
    else:  # list of RLE dicts
        rles = segmentation
    m = rle_codec.decode(list(rles))
    m = m.sum(axis=2)
    return m.astype(np.uint8)


class ResDataset(BaseDataset):
    num_sentence_per_item = 3

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

    def build_sample(self, index):
        item = self.annotation[index]
        sentences = item["sentences"]
        if len(sentences) > self.num_sentence_per_item:
            sentences = list(
                np.random.choice(sentences, self.num_sentence_per_item, replace=False)
            )

        conversations = []
        for idx, sentence in enumerate(sentences):
            question = self.random_choice_template().replace(CLASS_TOKEN, sentence)
            if idx != 0:
                question = question.replace(DEFAULT_IMAGE_TOKEN, "")
            conversations.append({"from": "human", "value": question})
            conversations.append({
                "from": "gpt",
                "value": (
                    f"Sure. Mask: {DEFAULT_SEG_TOKEN}; Location: {DEFAULT_LOC_TOKEN}; "
                    f"{DEFAULT_TAG_START}{item['category'].lower()}{DEFAULT_TAG_END}."
                ),
            })

        return {
            "image_path": os.path.join(self.vis_root, item["image_path"]),
            "target": {
                "segmentation": item["segmentation"],
                "bbox": item["bbox"],
                "height": item["height"],
                "width": item["width"],
            },
            "conversations": conversations,
        }

    def __getitem__(self, idx):
        sample = self.build_sample(idx)
        image = read_rgb(sample["image_path"], library="cv2")

        conversation_list = sample["conversations"]
        tgt = sample["target"]
        height, width = tgt["height"], tgt["width"]

        image_clip = self.prepare_clip_image(image)
        image_sam, resize = self.prepare_sam_image(image)

        sources = preprocess_image_text(
            copy.deepcopy(conversation_list), self.image_token_len
        )
        data = preprocess(sources, self.tokenizer, self.conv_type)

        n_rounds = len(conversation_list) // 2
        mask = decode_segmentation(tgt["segmentation"], height, width)
        xyxy = self.det_tool.xywh2xyxy(tgt["bbox"])
        normalized_bbox = self.det_tool.pad_normalize_xyxy(xyxy, width, height)

        masks = np.stack([mask] * n_rounds, axis=0).astype(np.float32)
        boxes = np.stack([normalized_bbox] * n_rounds, axis=0).astype(np.float32)

        return {
            "input_ids": data["input_ids"][0],
            "labels": data["labels"][0],
            "image": image_clip,
            "image_sam": image_sam,
            "seg_mask": masks,
            "boxes": boxes,
            "raw_size": (height, width),
            "resize": tuple(resize),
        }


class ValResDataset(ResDataset):
    num_sentence_per_item = 10

    def random_choice_template(self) -> str:
        # The fixed val question.
        return (
            DEFAULT_IMAGE_TOKEN
            + "\n"
            + f"Output the segmentation mask of the {CLASS_TOKEN} in the image."
        )
