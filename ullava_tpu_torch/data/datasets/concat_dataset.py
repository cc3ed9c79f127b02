"""Dataset mixing: plain concat + seeded shuffled subset (counterpart of
`ullava_tpu/data/datasets/concat_dataset.py`): a shuffled index subset
from `np.random.default_rng(seed)` and `portion` (> 1 repeats the index
list)."""

from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative.append(total)

    def __len__(self):
        return self.cumulative[-1] if self.cumulative else 0

    def __getitem__(self, index):
        if index < 0:
            index += len(self)
        ds_idx = bisect.bisect_right(self.cumulative, index)
        prev = self.cumulative[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][index - prev]


class ConcatDatasetWithShuffle:
    def __init__(self, datasets: Sequence, seed: int = 42, portion: float = 1):
        self.seed = seed
        self.portion = portion
        self.dataset = ConcatDataset(datasets)
        target_len = int(len(self.dataset) * portion)
        indices = list(range(len(self.dataset))) * int(np.ceil(portion))
        rng = np.random.default_rng(seed)
        rng.shuffle(indices)
        self.indices = indices[:target_len]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        return self.dataset[self.indices[index]]
