"""SAM-side image prep and box utilities, host-side (counterpart of
`ullava_tpu/data/tools/mask_toolbox.py`).

- `SegToolBox.apply_image`: resize so that the longest side is 1024
  (bilinear), `apply_mask` (nearest), `preprocess`: SAM mean/std normalize
  + zero-pad bottom/right to 1024^2, NHWC float32. The resizes are
  `ops.image_ops.resize_uint8` in place of PIL's;
- `DetToolBox`: xywh -> xyxy, pad-then-normalize to the padded square,
  its inverse, and mask -> bbox (xyxy, inclusive corners).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ullava_tpu_torch.constants import SAM_IMAGE_SIZE, SAM_MEAN, SAM_STD
from ullava_tpu_torch.ops.image_ops import resize_uint8


def get_preprocess_shape(h: int, w: int, long_side: int) -> Tuple[int, int]:
    scale = long_side / max(h, w)
    new_h, new_w = h * scale, w * scale
    return int(new_h + 0.5), int(new_w + 0.5)


class SegToolBox:
    def __init__(self, sam_size: int = SAM_IMAGE_SIZE):
        self.sam_size = sam_size
        self.mean = np.asarray(SAM_MEAN, np.float32)
        self.std = np.asarray(SAM_STD, np.float32)

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """uint8 HWC RGB -> resized HWC uint8 with longest side = sam_size."""
        h, w = image.shape[:2]
        return resize_uint8(image, get_preprocess_shape(h, w, self.sam_size), "bilinear")

    def apply_mask(self, mask: np.ndarray) -> np.ndarray:
        """Binary HW mask -> resized (nearest) to the pre-pad shape."""
        h, w = mask.shape[:2]
        return resize_uint8(mask.astype(np.uint8), get_preprocess_shape(h, w, self.sam_size),
                            "nearest")

    def preprocess(self, image: np.ndarray) -> np.ndarray:
        """Resized HWC image -> normalized + padded [1024, 1024, 3] f32."""
        x = (image.astype(np.float32) - self.mean) / self.std
        h, w = x.shape[:2]
        out = np.zeros((self.sam_size, self.sam_size, 3), np.float32)
        out[:h, :w] = x
        return out

    def pad_mask_to_frame(self, mask: np.ndarray, frame: int) -> np.ndarray:
        """Resized binary mask -> zero-padded square frame, downsampled
        (nearest) to `frame` (the model's mask_loss_frame)."""
        h, w = mask.shape[:2]
        canvas = np.zeros((self.sam_size, self.sam_size), np.uint8)
        canvas[:h, :w] = mask
        if frame != self.sam_size:
            canvas = resize_uint8(canvas, (frame, frame), "nearest")
        return canvas


class DetToolBox:
    @staticmethod
    def get_pad_length(width: float, height: float) -> Tuple[float, float]:
        if width > height:
            return 0.0, (width - height) / 2.0
        return (height - width) / 2.0, 0.0

    @staticmethod
    def xywh2xyxy(xywh: Sequence[float]) -> List[float]:
        x, y, w, h = xywh
        return [x, y, x + w, y + h]

    def pad_normalize_xyxy(self, xyxy, width, height) -> List[float]:
        x0, y0, x1, y1 = xyxy
        max_side = max(width, height)
        pad_x, pad_y = self.get_pad_length(width, height)
        return [
            (x0 + pad_x) / max_side,
            (y0 + pad_y) / max_side,
            (x1 + pad_x) / max_side,
            (y1 + pad_y) / max_side,
        ]

    def denormalize_padded_xyxy(self, normalized_xyxy, width, height) -> List[float]:
        n_x0, n_y0, n_x1, n_y1 = normalized_xyxy
        max_side = max(width, height)
        pad_x, pad_y = self.get_pad_length(width, height)
        return [
            n_x0 * max_side - pad_x,
            n_y0 * max_side - pad_y,
            n_x1 * max_side - pad_x,
            n_y1 * max_side - pad_y,
        ]

    @staticmethod
    def mask2bbox(binary_mask: np.ndarray) -> List[float]:
        """[0/1] mask -> [x0, y0, x1, y1] with inclusive max corners."""
        ys, xs = np.nonzero(np.asarray(binary_mask))
        if len(xs) == 0:
            return [0.0, 0.0, 0.0, 0.0]
        return [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]
