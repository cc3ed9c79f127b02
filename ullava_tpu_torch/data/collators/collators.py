"""Fixed-shape batch collators (counterpart of
`ullava_tpu/data/collators/collators.py`). Every output is a dense numpy
array:

- text padded to the batch's longest row rounded up to `pad_multiple`,
  cut at `model_max_length`, with the pad id and IGNORE_INDEX, and
  `attn_lens` in place of an attention-mask matrix;
- images and videos stacked with zero rows for absent media;
- masks resampled onto the SAM frame at `mask_frame` as
  [B, max_masks, F, F] + validity, boxes as [B, max_masks, 4] + validity;
- raw and resized sizes as [B, 2] int arrays for host post-processing.

The nearest resizes of `resample_mask_to_frame` take the native host
library where it is loaded, else `ops.image_ops.resize_uint8(...,
"nearest")`, which follows PIL's rule exactly, where the JAX package
takes PIL. Registered under the reference's collator names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from ullava_tpu_torch.constants import IGNORE_INDEX, SAM_IMAGE_SIZE
from ullava_tpu_torch.data.tools.mask_toolbox import get_preprocess_shape
from ullava_tpu_torch.ops.image_ops import resize_uint8
from ullava_tpu_torch.registry import registry


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resample_mask_to_frame(
    mask: np.ndarray, raw_hw, frame: int, sam_size: int = SAM_IMAGE_SIZE
) -> np.ndarray:
    """Original-resolution binary mask -> SAM padded frame at `frame` res
    (same geometry as the image path: resize longest side, pad bottom/right)."""
    from ullava_tpu_torch.data.tools import native

    h, w = raw_hw
    nh, nw = get_preprocess_shape(h, w, sam_size)
    binary = (mask > 0).astype(np.uint8)
    resized = native.resize_nearest(binary, nh, nw)
    if resized is None:
        resized = resize_uint8(binary, (nh, nw), "nearest")
    canvas = np.zeros((sam_size, sam_size), np.uint8)
    canvas[:nh, :nw] = resized
    if frame != sam_size:
        down = native.resize_nearest(canvas, frame, frame)
        if down is None:
            down = resize_uint8(canvas, (frame, frame), "nearest")
        canvas = down
    return canvas.astype(np.float32)


@registry.register_collator("base_collator")
class BaseCollator:
    def __init__(self, pad_token_id: int, pad_multiple: int = 64,
                 model_max_length: Optional[int] = None):
        self.pad_token_id = pad_token_id
        self.ignore_index = IGNORE_INDEX
        self.pad_multiple = pad_multiple
        self.model_max_length = model_max_length

    def process_text(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        ids_list = [np.asarray(i["input_ids"], np.int32) for i in instances]
        lab_list = [np.asarray(i["labels"], np.int32) for i in instances]
        max_len = _round_up(max(len(x) for x in ids_list), self.pad_multiple)
        if self.model_max_length:
            max_len = min(max_len, self.model_max_length)
        B = len(ids_list)
        input_ids = np.full((B, max_len), self.pad_token_id, np.int32)
        labels = np.full((B, max_len), self.ignore_index, np.int32)
        attn_lens = np.zeros((B,), np.int32)
        for b, (ids, lab) in enumerate(zip(ids_list, lab_list)):
            n = min(len(ids), max_len)
            input_ids[b, :n] = ids[:n]
            labels[b, :n] = lab[:n]
            attn_lens[b] = n
        return {"input_ids": input_ids, "labels": labels, "attn_lens": attn_lens}

    def gather_images(self, instances) -> Optional[np.ndarray]:
        shapes = [i["image"].shape for i in instances if "image" in i]
        if not shapes:
            return None
        images = [
            i.get("image", np.zeros(shapes[0], np.float32)).astype(np.float32)
            for i in instances
        ]
        return np.stack(images)

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, Any]:
        batch = self.process_text(instances)
        images = self.gather_images(instances)
        if images is not None:
            batch["images"] = images
        return batch


@registry.register_collator("image_collator")
class ImageCollator(BaseCollator):
    pass


@registry.register_collator("video_collator")
class VideoCollator(BaseCollator):
    def __call__(self, instances):
        batch = self.process_text(instances)
        shapes = [i["video"].shape for i in instances if "video" in i]
        if shapes:
            batch["videos"] = np.stack([
                i.get("video", np.zeros(shapes[0], np.float32)).astype(np.float32)
                for i in instances
            ])
        return batch


@registry.register_collator("image_video_collator")
class ImageVideoCollator(BaseCollator):
    def __call__(self, instances):
        batch = self.process_text(instances)
        img_shapes = [i["image"].shape for i in instances if "image" in i]
        vid_shapes = [i["video"].shape for i in instances if "video" in i]
        if img_shapes:
            batch["images"] = np.stack([
                i.get("image", np.zeros(img_shapes[0], np.float32)).astype(np.float32)
                for i in instances
            ])
        if vid_shapes:
            batch["videos"] = np.stack([
                i.get("video", np.zeros(vid_shapes[0], np.float32)).astype(np.float32)
                for i in instances
            ])
        return batch


@registry.register_collator("segmentation_collator")
class SegmentationCollator(BaseCollator):
    def __init__(self, pad_token_id, pad_multiple: int = 64,
                 model_max_length: Optional[int] = None,
                 max_masks: int = 3, mask_frame: int = 1024,
                 with_boxes: bool = False):
        super().__init__(pad_token_id, pad_multiple, model_max_length)
        self.max_masks = max_masks
        self.mask_frame = mask_frame
        self.with_boxes = with_boxes

    def __call__(self, instances):
        batch = self.process_text(instances)
        B = len(instances)
        F = self.mask_frame

        batch["images"] = np.stack(
            [i["image"].astype(np.float32) for i in instances]
        )
        batch["images_sam"] = np.stack(
            [i["image_sam"].astype(np.float32) for i in instances]
        )

        gt_masks = np.zeros((B, self.max_masks, F, F), np.float32)
        mask_valid = np.zeros((B, self.max_masks), bool)
        raw_sizes = np.zeros((B, 2), np.int32)
        resize_sizes = np.zeros((B, 2), np.int32)
        for b, inst in enumerate(instances):
            raw = inst["raw_size"]
            raw_sizes[b] = raw
            resize_sizes[b] = inst["resize"]
            masks = inst["seg_mask"]
            for m in range(min(len(masks), self.max_masks)):
                gt_masks[b, m] = resample_mask_to_frame(masks[m], raw, F)
                mask_valid[b, m] = True
        batch.update(
            gt_masks=gt_masks,
            mask_valid=mask_valid,
            raw_sizes=raw_sizes,
            input_hw=resize_sizes,
        )

        if self.with_boxes:
            gt_boxes = np.zeros((B, self.max_masks, 4), np.float32)
            box_valid = np.zeros((B, self.max_masks), bool)
            for b, inst in enumerate(instances):
                boxes = inst.get("boxes", np.zeros((0, 4), np.float32))
                n = min(len(boxes), self.max_masks)
                if n:
                    gt_boxes[b, :n] = boxes[:n]
                    box_valid[b, :n] = True
            batch.update(gt_boxes=gt_boxes, box_valid=box_valid)
        return batch


@registry.register_collator("grounding_collator")
class GroundingCollator(SegmentationCollator):
    def __init__(self, pad_token_id, pad_multiple: int = 64,
                 model_max_length: Optional[int] = None,
                 max_masks: int = 3, mask_frame: int = 1024):
        super().__init__(
            pad_token_id, pad_multiple, model_max_length,
            max_masks=max_masks, mask_frame=mask_frame, with_boxes=True,
        )
