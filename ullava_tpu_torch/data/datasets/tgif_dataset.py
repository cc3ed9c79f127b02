"""TGIF video captioning / QA dataset (counterpart of
`ullava_tpu/data/datasets/tgif_dataset.py`).

A sample's GIF goes through the video processor; its text gets the video
token run of `n_frm + image_token_len` tokens (temporal tokens, one a
frame, then the spatial patch tokens). A corrupt sample is retried up to
10 times on a random other index (`random.randint`, as in the JAX
package); a missing image library is not a corrupt sample and raises.
"""

from __future__ import annotations

import copy
import os
import random

from ullava_tpu_torch.data.datasets.base_dataset import BaseDataset
from ullava_tpu_torch.tokenization import preprocess, preprocess_video_text


class TgifDataset(BaseDataset):
    def __init__(self, vis_processor, tokenizer, vis_root, ann_root,
                 portion=1, image_token_len=256, data_type="video",
                 conv_type="conv_simple", seed=42):
        super().__init__(
            vis_processor=vis_processor, tokenizer=tokenizer, vis_root=vis_root,
            ann_root=ann_root, portion=portion, data_type=data_type,
            conv_type=conv_type, seed=seed,
        )
        self.resize_size = vis_processor.image_size
        self.num_frm = vis_processor.n_frm
        # temporal tokens (n_frm) + spatial tokens (num_patches)
        self.image_token_len = self.num_frm + image_token_len

    def __getitem__(self, index):
        num_retries = 10
        for _ in range(num_retries):
            try:
                sample = self.annotation[index]
                conversation_list = sample["conversations"]
                if "gif" in sample:
                    gif_path = os.path.join(self.vis_root, sample["gif"])
                    video = self.vis_processor(gif_path)
                    sources = preprocess_video_text(
                        copy.deepcopy(conversation_list), self.image_token_len
                    )
                else:
                    video = None
                    sources = [copy.deepcopy(conversation_list)]

                data = preprocess(sources, self.tokenizer, self.conv_type)
                out = {"input_ids": data["input_ids"][0], "labels": data["labels"][0]}
                if video is not None:
                    out["video"] = video
                return out
            except ImportError:  # no PIL on this machine: not a corrupt sample
                raise
            except Exception as error:  # corrupt sample -> resample
                name = sample.get("gif", str(index)) if isinstance(sample, dict) else str(index)
                print(f"Failed to load video {name}: {error}. Resampling.")
                index = random.randint(0, len(self) - 1)
        raise RuntimeError(f"Failed to fetch video after {num_retries} retries.")
