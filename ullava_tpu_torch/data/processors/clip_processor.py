"""CLIP image processor, host-side (counterpart of
`ullava_tpu/data/processors/clip_processor.py`).

Optional square padding with a WHITE (255, 255, 255) background (centred
paste), then the CLIPImageProcessor pipeline: resize the shortest side to
`image_size` (bicubic), centre crop, scale to [0, 1], normalize with the
CLIP mean and std. Output is NHWC float32. The resize is
`ops.image_ops.resize_uint8` in place of PIL's, which the card's machine
lacks; a PIL image is still accepted where PIL is installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ullava_tpu_torch.constants import CLIP_MEAN, CLIP_STD, DEFAULT_IMAGE_SIZE
from ullava_tpu_torch.ops.image_ops import resize_uint8
from ullava_tpu_torch.registry import registry


@registry.register_processor("clip_image")
class CLIPProcessor:
    def __init__(self, image_size: int = DEFAULT_IMAGE_SIZE, aspect_ratio: Optional[str] = None):
        self.image_size = image_size
        self.aspect_ratio = aspect_ratio  # 'pad' | 'keep' | None
        self.mean = np.asarray(CLIP_MEAN, np.float32)
        self.std = np.asarray(CLIP_STD, np.float32)

    @staticmethod
    def pad_to_square(img: np.ndarray, background_color=(255, 255, 255)) -> np.ndarray:
        """uint8 HWC -> the image pasted centred on a square of
        `background_color`."""
        h, w = img.shape[:2]
        if w == h:
            return img
        side = max(w, h)
        out = np.empty((side, side, img.shape[2]), np.uint8)
        out[:] = np.asarray(background_color, np.uint8)
        top, left = (side - h) // 2, (side - w) // 2
        out[top:top + h, left:left + w] = img
        return out

    def __call__(self, item) -> np.ndarray:
        """uint8 HWC RGB array (or a PIL image) -> [image_size, image_size,
        3] float32."""
        if hasattr(item, "convert"):  # a PIL image
            item = item.convert("RGB")
        img = np.asarray(item, np.uint8)
        if self.aspect_ratio == "pad":
            img = self.pad_to_square(img)

        # Resize the shortest side to image_size (bicubic), centre crop.
        h, w = img.shape[:2]
        scale = self.image_size / min(w, h)
        new_w, new_h = round(w * scale), round(h * scale)
        img = resize_uint8(img, (new_h, new_w), "bicubic")
        left = (new_w - self.image_size) // 2
        top = (new_h - self.image_size) // 2
        img = img[top:top + self.image_size, left:left + self.image_size]

        x = img.astype(np.float32) / 255.0
        return (x - self.mean) / self.std  # [H, W, 3] float32

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            image_size=int(cfg.get("image_size", DEFAULT_IMAGE_SIZE)),
            aspect_ratio=cfg.get("aspect_ratio", None),
        )
