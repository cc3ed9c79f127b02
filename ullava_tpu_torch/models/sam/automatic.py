"""Automatic mask generation, SamAutomaticMaskGenerator (counterpart of
`ullava_tpu/models/sam/automatic.py`).

A grid of points swept over the image, the masks of every point decoded
in ONE batched call of the prompt encoder and the mask decoder, filtered
by predicted IoU and stability score, turned into masks at the original
resolution on the host and deduplicated by a greedy mask-IoU NMS (highest
predicted IoU first); each kept mask goes out as COCO RLE.

    gen = SamAutomaticMaskGenerator(params, build.sam_vit_l())   # on the card
    records = gen.generate(image)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.data.tools import rle as rle_codec
from ullava_tpu_torch.data.tools.mask_toolbox import SegToolBox
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import image_encoder, mask_decoder, prompt_encoder


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced grid in [0,1]^2 (cell centers)."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xx, yy = np.meshgrid(coords, coords)
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)


def stability_score(logits: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """IoU between thresholded masks at +/- offset around 0."""
    high = (logits > offset).sum(axis=(-2, -1))
    low = (logits > -offset).sum(axis=(-2, -1))
    return high / np.maximum(low, 1)


def mask_iou_matrix(masks: np.ndarray) -> np.ndarray:
    flat = masks.reshape(masks.shape[0], -1).astype(np.float64)
    inter = flat @ flat.T
    areas = flat.sum(-1)
    union = areas[:, None] + areas[None, :] - inter
    return inter / np.maximum(union, 1)


class SamAutomaticMaskGenerator:
    def __init__(
        self,
        params,
        cfg: sam_build.SamConfig,
        points_per_side: int = 16,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.92,
        nms_iou_thresh: float = 0.7,
        min_mask_area: int = 16,
        device=None,
    ):
        """`params` must lie on `device` (the card unless "cpu" is asked for)."""
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.grid = build_point_grid(points_per_side)
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.nms_iou_thresh = nms_iou_thresh
        self.min_mask_area = min_mask_area
        self.seg_tool = SegToolBox(sam_size=cfg.vision.img_size)

    @torch.no_grad()
    def _decode_all(self, emb: torch.Tensor, pts: torch.Tensor, labels: torch.Tensor):
        """Every point its own one-point prompt, all in one batch: (low_res
        [N, 3, 4g, 4g], iou [N, 3])."""
        p, cfg = self.params, self.cfg
        N = pts.shape[0]
        sparse, dense = prompt_encoder.encode_prompts(
            p["prompt_encoder"], cfg.prompt, batch=N, points=(pts[:, None, :], labels[:, None]),
        )
        pe = prompt_encoder.dense_positional_embedding(p["prompt_encoder"], cfg.prompt)
        return mask_decoder.decode_masks(
            p["mask_decoder"], cfg.decoder, emb.expand((N,) + emb.shape[1:]), pe, sparse, dense,
            multimask_output=True,
        )

    def generate(self, image: np.ndarray) -> List[Dict]:
        """image: RGB uint8. Returns list of dicts with 'segmentation'
        (RLE), 'area', 'bbox' (xywh), 'predicted_iou', 'stability_score',
        'point_coords' — the pycocotools-style output schema."""
        resized = self.seg_tool.apply_image(image)
        pre = torch.as_tensor(self.seg_tool.preprocess(resized)[None], device=self.device)
        emb = image_encoder.encode(self.params["image_encoder"], self.cfg.vision, pre)
        return self._generate_from(emb, resized.shape[:2], image.shape[:2])

    def _generate_from(
        self, emb: torch.Tensor, input_size: Tuple[int, int], original_size: Tuple[int, int]
    ) -> List[Dict]:
        """`generate`'s work after the encoder, on its embedding [1, g, g, D]."""
        pts = self.grid.copy()
        pts[:, 0] *= input_size[1]
        pts[:, 1] *= input_size[0]
        labels = np.ones(len(pts), np.int32)

        low_res, iou = self._decode_all(
            emb, torch.as_tensor(pts, dtype=torch.float32, device=self.device),
            torch.as_tensor(labels, device=self.device),
        )
        low_res = low_res.float().cpu().numpy()
        low_res = low_res.reshape(-1, *low_res.shape[2:])  # [N*3, h, w]
        iou = iou.float().cpu().numpy().reshape(-1)
        point_idx = np.repeat(np.arange(len(pts)), 3)

        keep = iou > self.pred_iou_thresh
        stab = stability_score(low_res)
        keep &= stab > self.stability_score_thresh
        if not keep.any():
            return []
        low_res, iou, stab, point_idx = low_res[keep], iou[keep], stab[keep], point_idx[keep]

        masks = np.stack([
            sam_build.postprocess_masks_host(
                lr[None], input_size=input_size, original_size=original_size,
                img_size=self.cfg.vision.img_size,
            )[0] > 0
            for lr in low_res
        ])

        areas = masks.sum(axis=(1, 2))
        big = areas >= self.min_mask_area
        masks, iou, stab, areas, point_idx = (
            masks[big], iou[big], stab[big], areas[big], point_idx[big]
        )
        if len(masks) == 0:
            return []

        # Greedy NMS by mask IoU, highest predicted IoU first.
        order = np.argsort(-iou)
        iou_mat = mask_iou_matrix(masks)
        keep_idx: List[int] = []
        for i in order:
            if all(iou_mat[i, j] < self.nms_iou_thresh for j in keep_idx):
                keep_idx.append(int(i))

        out = []
        for i in keep_idx:
            ys, xs = np.nonzero(masks[i])
            bbox = [float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]
            out.append({
                "segmentation": rle_codec.encode(masks[i].astype(np.uint8)),
                "area": int(areas[i]),
                "bbox": bbox,
                "predicted_iou": float(iou[i]),
                "stability_score": float(stab[i]),
                "point_coords": [pts[point_idx[i]].tolist()],
            })
        return out
