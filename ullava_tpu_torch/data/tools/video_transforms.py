"""Video clip transforms on the host (counterpart of
`ullava_tpu/data/tools/video_transforms.py`).

Crop / resize / resized-crop / center-crop / normalize / horizontal flip
over [T, H, W, C] numpy clips, and the transform classes built on them.
Resizes go through PIL as in the JAX line: a uint8 clip frame by frame, a
float clip channel by channel in PIL's "F" mode (a torch interpolation is
not bit-equal to either). PIL is imported at the resize, so the module
imports without it. The random classes draw from Python's `random` in the
JAX line's order, so that one `random.seed` gives the same clips.
"""

from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np

from ullava_tpu_torch.data.tools.image_io import _pil_image

# PIL's resampling codes (`PIL.Image.Resampling`), named here so that the
# defaults need no PIL at import.
BILINEAR = 2
BICUBIC = 3


def crop(clip: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    return clip[:, i : i + h, j : j + w]


def resize(clip: np.ndarray, target_size: Tuple[int, int],
           interpolation=BILINEAR) -> np.ndarray:
    """[T, H, W, C] -> [T, th, tw, C]: a uint8 clip frame by frame through
    PIL, any other clip as float32 channel by channel in PIL's "F" mode."""
    Image = _pil_image("video frames")
    th, tw = target_size
    if clip.dtype == np.uint8:
        return np.stack([
            np.asarray(Image.fromarray(np.asarray(f)).resize((tw, th), interpolation))
            for f in clip
        ])
    T, H, W, C = clip.shape
    res = np.empty((T, th, tw, C), np.float32)
    for t in range(T):
        for c in range(C):
            img = Image.fromarray(clip[t, :, :, c].astype(np.float32), mode="F")
            res[t, :, :, c] = np.asarray(img.resize((tw, th), interpolation))
    return res


def resized_crop(clip: np.ndarray, i: int, j: int, h: int, w: int,
                 size: Tuple[int, int], interpolation=BICUBIC) -> np.ndarray:
    return resize(crop(clip, i, j, h, w), size, interpolation)


def center_crop(clip: np.ndarray, crop_size: Tuple[int, int]) -> np.ndarray:
    th, tw = crop_size
    h, w = clip.shape[1:3]
    return crop(clip, (h - th) // 2, (w - tw) // 2, th, tw)


def normalize(clip: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    x = clip.astype(np.float32)
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def hflip(clip: np.ndarray) -> np.ndarray:
    return clip[:, :, ::-1]


def to_float(clip: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [0, 1] (THWC)."""
    return clip.astype(np.float32) / 255.0


class RandomCropVideo:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        th, tw = self.size
        h, w = clip.shape[1:3]
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return crop(clip, i, j, th, tw)


class CenterCropVideo:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return center_crop(clip, self.size)


class NormalizeVideo:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return normalize(clip, self.mean, self.std)


class RandomHorizontalFlipVideo:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return hflip(clip) if random.random() < self.p else clip
