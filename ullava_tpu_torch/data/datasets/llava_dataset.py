"""LLaVA-style VQA / captioning datasets (counterpart of
`ullava_tpu/data/datasets/llava_dataset.py`).

A corrupt sample is retried up to 10 times on a random other index
(`random.randint`, as in the JAX package); `LLaVASegDataset` emits VQA
rows shaped like grounding rows (empty masks and boxes) so that they mix
into stage-2 batches. Images are read as the JAX line reads them, by
PIL's `.convert("RGB")` (`image_io`).
"""

from __future__ import annotations

import copy
import os
import random

import numpy as np

from ullava_tpu_torch.data.datasets.base_dataset import BaseDataset
from ullava_tpu_torch.data.tools.image_io import read_rgb
from ullava_tpu_torch.tokenization import preprocess, preprocess_image_text


class LLaVADataset(BaseDataset):
    def __init__(self, vis_processor, tokenizer, vis_root, ann_root,
                 portion=1, image_token_len=256, data_type="image",
                 conv_type="conv_simple", seed=42):
        super().__init__(
            vis_processor=vis_processor, tokenizer=tokenizer, vis_root=vis_root,
            ann_root=ann_root, portion=portion, data_type=data_type,
            conv_type=conv_type, seed=seed,
        )
        self.image_token_len = image_token_len

    def __getitem__(self, index):
        num_retries = 10
        for _ in range(num_retries):
            try:
                sample = self.annotation[index]
                conversation_list = sample["conversations"]

                if "image" in sample:
                    image_path = os.path.join(self.vis_root, sample["image"])
                    image = read_rgb(image_path, library="pil")
                    image = self.prepare_clip_image(image)
                    sources = preprocess_image_text(
                        copy.deepcopy(conversation_list), self.image_token_len
                    )
                else:
                    image = None
                    sources = [copy.deepcopy(conversation_list)]

                data = preprocess(sources, self.tokenizer, self.conv_type)
                out = {"input_ids": data["input_ids"][0], "labels": data["labels"][0]}
                if image is not None:
                    out["image"] = image
                return out
            except ImportError:  # no PIL on this machine: not a corrupt sample
                raise
            except Exception as error:  # corrupt sample -> resample
                name = sample.get("image", str(index)) if isinstance(sample, dict) else str(index)
                print(f"Failed to load example {name}, Error: {error}. Resampling.")
                index = random.randint(0, len(self) - 1)
        raise RuntimeError(f"Failed to fetch sample after {num_retries} retries.")


class LLaVASegDataset(LLaVADataset):
    """VQA rows inside stage-2 grounding batches: a zero SAM image, no
    masks and no boxes (the collator marks their slots invalid)."""

    def __init__(self, *args, sam_size=1024, **kw):
        super().__init__(*args, **kw)
        self.sam_size = sam_size

    def __getitem__(self, index):
        out = super().__getitem__(index)
        out["image_sam"] = np.zeros((self.sam_size, self.sam_size, 3), np.float32)
        out["seg_mask"] = np.zeros((0, 1, 1), np.float32)  # no masks
        out["boxes"] = np.zeros((0, 4), np.float32)  # no boxes
        out["raw_size"] = (self.sam_size, self.sam_size)
        out["resize"] = (self.sam_size, self.sam_size)
        return out
