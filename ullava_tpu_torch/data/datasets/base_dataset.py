"""Base dataset: annotation loading, seeded subsampling, templates
(counterpart of `ullava_tpu/data/datasets/base_dataset.py`).

JSON and JSONL annotation files, the seeded `portion` subsample
(`random.seed` + `random.sample`, so every data-parallel worker picks the
same subset), the instruction-template bank drawn by a per-dataset
`np.random.default_rng(seed)`. The random sources and the order of draws
are the JAX package's, so one seeding of both gives the same samples.
Samples are plain dicts of numpy arrays.
"""

from __future__ import annotations

import json
import pathlib
import random
from typing import Dict, List

import numpy as np

from ullava_tpu_torch.data.tools.mask_toolbox import DetToolBox, SegToolBox


class BaseDataset:
    def __init__(
        self,
        vis_processor=None,
        tokenizer=None,
        vis_root: str = "",
        ann_root: str = "",
        template_root: str = "",
        portion: float = 1,
        seed: int = 42,
        data_type: str = "image",
        conv_type: str = "conv_simple",
        sam_size: int = 1024,
    ):
        self.seed = seed
        self.annotation = self.get_annotations(ann_root, portion)
        self.tokenizer = tokenizer
        self.vis_root = vis_root
        self.vis_processor = vis_processor
        self.templates = self.get_templates(template_root) if template_root else None
        self.rng = np.random.default_rng(self.seed)
        self.data_type = data_type
        self.conv_type = conv_type
        self.seg_tool, self.det_tool = SegToolBox(sam_size=sam_size), DetToolBox()

    def __len__(self) -> int:
        return len(self.annotation)

    def __getitem__(self, item):
        raise NotImplementedError

    def get_annotations(self, ann_root: str, portion: float) -> List[Dict]:
        path = pathlib.Path(ann_root)
        if ann_root.endswith(".json"):
            with path.open(encoding="utf-8") as f:
                annotation = json.load(f)
        elif ann_root.endswith(".jsonl"):
            annotation = []
            with path.open(encoding="utf-8") as f:
                for line in f:
                    annotation.append(json.loads(line))
        else:
            raise NotImplementedError("annotation must be .json or .jsonl")

        if portion < 1.0:
            n_sampled = int(len(annotation) * portion)
            # Same seed on every data-parallel worker -> same subset.
            random.seed(self.seed)
            annotation = random.sample(annotation, n_sampled)
        return annotation

    @staticmethod
    def get_templates(template_root: str) -> List[str]:
        if not template_root.endswith(".json"):
            raise ValueError(f"template bank {template_root!r} must be a .json file")
        with open(template_root, encoding="utf-8") as f:
            return json.load(f)

    def template_nums(self) -> int:
        return len(self.templates)

    def random_choice_template(self) -> str:
        return str(self.rng.choice(self.templates))

    # ---- shared image prep -----------------------------------------------
    def prepare_clip_image(self, image: np.ndarray) -> np.ndarray:
        return self.vis_processor(image)

    def prepare_sam_image(self, image: np.ndarray):
        """Returns (normalized padded [sam_size, sam_size, 3] f32, resize (h, w))."""
        resized = self.seg_tool.apply_image(image)
        resize = resized.shape[:2]
        return self.seg_tool.preprocess(resized), resize
