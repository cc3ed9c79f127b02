"""Semantic segmentation datasets, ADE20K, COCO-Stuff, PACO / Pascal-Part
(counterpart of `ullava_tpu/data/datasets/sem_seg_dataset.py`).

At most 3 classes an image (the global `np.random.choice`), label image ->
per-class binary masks, the ADE20K label remap (0 -> 255, ids shifted
down by 1), COCO-Stuff's multi-word '-' classes dropped, PACO's
per-annotation polygon / RLE decode with merge. Images are read as
`cv2.imread` + BGR -> RGB reads them; label images as
`np.array(PIL.Image.open(...))` does, indices and not RGB (`image_io`).
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
from ullava_tpu_torch.data.tools.image_io import read_label, read_rgb
from ullava_tpu_torch.tokenization import preprocess, preprocess_image_text

CLASS_TOKEN = "<class>"


class SemanticSegDataset(BaseDataset):
    class_map = {}

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
        self.num_sentence_per_item = 3

    @staticmethod
    def get_label(label_path: str) -> np.ndarray:
        """ADE20K remap: 0 (unlabeled) -> 255, ids shift down by 1."""
        label = read_label(label_path)
        label[label == 0] = 255
        label -= 1
        label[label == 254] = 255
        return label

    def _answer(self, cls_name: str) -> str:
        return (
            f"Sure. Mask: {DEFAULT_SEG_TOKEN}; Location: {DEFAULT_LOC_TOKEN}; "
            f"{DEFAULT_TAG_START}{cls_name.lower()}{DEFAULT_TAG_END}."
        )

    def build_sample(self, index):
        item = self.annotation[index]
        classes = item["classes"]
        if len(classes) > self.num_sentence_per_item:
            classes = list(
                np.random.choice(classes, self.num_sentence_per_item, replace=False)
            )
        conversations, cls_seq = [], []
        for idx, cls in enumerate(classes):
            cls_name, cls_id = cls["class"], cls["class_id"]
            question = self.random_choice_template().replace(CLASS_TOKEN, cls_name.lower())
            if idx != 0:
                question = question.replace(DEFAULT_IMAGE_TOKEN, "")
            conversations.append({"from": "human", "value": question})
            conversations.append({"from": "gpt", "value": self._answer(cls_name)})
            cls_seq.append(cls_id)
        return {
            "image_path": os.path.join(self.vis_root, item["image_path"]),
            "target": {
                "label_path": os.path.join(self.vis_root, item["label_path"]),
                "class_sequence": cls_seq,
            },
            "conversations": conversations,
        }

    def __getitem__(self, idx):
        sample = self.build_sample(idx)
        image = read_rgb(sample["image_path"], library="cv2")
        label = self.get_label(sample["target"]["label_path"])
        cls_seq = sample["target"]["class_sequence"]

        image_clip = self.prepare_clip_image(image)
        image_sam, resize = self.prepare_sam_image(image)

        sources = preprocess_image_text(
            copy.deepcopy(sample["conversations"]), self.image_token_len
        )
        data = preprocess(sources, self.tokenizer, self.conv_type)

        height, width = label.shape[:2]
        masks, boxes = [], []
        for class_id in cls_seq:
            m = (label == class_id).astype(np.float32)
            masks.append(m)
            xyxy = self.det_tool.mask2bbox((label == class_id).astype(np.uint8))
            boxes.append(self.det_tool.pad_normalize_xyxy(xyxy, width, height))

        return {
            "input_ids": data["input_ids"][0],
            "labels": data["labels"][0],
            "image": image_clip,
            "image_sam": image_sam,
            "seg_mask": np.stack(masks, 0),
            "boxes": np.asarray(boxes, np.float32),
            "raw_size": (height, width),
            "resize": tuple(resize),
        }


class CocoStuffDataset(SemanticSegDataset):
    """COCO-Stuff labels come pre-indexed; multi-word '-' classes are
    dropped by remapping their ids to 255. The
    class list is loaded from `cocostuff_classes.txt` next to templates."""

    def __init__(self, *args, class_file=None, **kw):
        super().__init__(*args, **kw)
        self.drop_ids = set()
        if class_file and os.path.exists(class_file):
            with open(class_file) as f:
                lines = [l.strip().split(": ")[-1] for l in f.readlines()[1:]]
            self.drop_ids = {i for i, c in enumerate(lines) if "-" in c}

    def get_label(self, label_path: str) -> np.ndarray:
        label = read_label(label_path)
        for i in self.drop_ids:
            label[label == i] = 255
        return label


class PacoDataset(SemanticSegDataset):
    """PACO-LVIS / Pascal-Part: per-annotation polygon or RLE instances; answer prefix 'Info:'."""

    def _answer(self, cls_name: str) -> str:
        return (
            f"Sure. Info: {DEFAULT_SEG_TOKEN}; Location: {DEFAULT_LOC_TOKEN}; "
            f"{DEFAULT_TAG_START}{cls_name.lower()}{DEFAULT_TAG_END}."
        )

    def build_sample(self, index):
        item = self.annotation[index]
        classes, anns = item["classes"], item["annotations"]
        idxs = list(range(len(classes)))
        if len(classes) > self.num_sentence_per_item:
            idxs = list(
                np.random.choice(idxs, self.num_sentence_per_item, replace=False)
            )
        conversations = []
        for j, i in enumerate(idxs):
            cls = classes[i]
            question = self.random_choice_template().replace(CLASS_TOKEN, cls.lower())
            if j != 0:
                question = question.replace(DEFAULT_IMAGE_TOKEN, "")
            conversations.append({"from": "human", "value": question})
            conversations.append({"from": "gpt", "value": self._answer(cls)})
        return {
            "image_path": os.path.join(self.vis_root, item["image_path"]),
            "target": {"annotations": [anns[i] for i in idxs]},
            "conversations": conversations,
        }

    def __getitem__(self, idx):
        sample = self.build_sample(idx)
        image = read_rgb(sample["image_path"], library="cv2")

        image_clip = self.prepare_clip_image(image)
        image_sam, resize = self.prepare_sam_image(image)

        sources = preprocess_image_text(
            copy.deepcopy(sample["conversations"]), self.image_token_len
        )
        data = preprocess(sources, self.tokenizer, self.conv_type)

        masks, boxes = [], []
        for ann in sample["target"]["annotations"]:
            height, width = ann["height"], ann["width"]
            seg = ann["segmentation"]
            if isinstance(seg, list):  # polygons -> merged mask
                m = rle_codec.merge(rle_codec.fr_poly(seg, height, width))
            else:
                m = rle_codec.decode(seg)
            masks.append(m.astype(np.float32))
            xyxy = self.det_tool.xywh2xyxy(ann["bbox"])
            boxes.append(self.det_tool.pad_normalize_xyxy(xyxy, width, height))

        return {
            "input_ids": data["input_ids"][0],
            "labels": data["labels"][0],
            "image": image_clip,
            "image_sam": image_sam,
            "seg_mask": np.stack(masks, 0),
            "boxes": np.asarray(boxes, np.float32),
            "raw_size": masks[0].shape[:2],
            "resize": tuple(resize),
        }
