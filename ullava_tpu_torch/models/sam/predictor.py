"""SamPredictor: embed an image once, prompt it many times (counterpart of
`ullava_tpu/models/sam/predictor.py`).

`set_image` resizes the image so that its longest side is the encoder's
input size, normalizes and pads it on the host (`SegToolBox`), and keeps
the encoder's embedding on the device; `predict` runs point and box
prompts through the prompt encoder and the mask decoder and returns the
masks at the original resolution with their IoU predictions. The decoder
always emits the three multimask tokens; `multimask_output=False` keeps
the first of them, as the JAX package does.

    pred = SamPredictor(params, build.sam_vit_l())    # on the card
    pred = SamPredictor(params, cfg, device="cpu")    # plain versions
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.data.tools.mask_toolbox import SegToolBox, get_preprocess_shape
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import image_encoder, mask_decoder, prompt_encoder


class SamPredictor:
    def __init__(self, params, cfg: sam_build.SamConfig, device=None):
        """`params` ({"image_encoder", "prompt_encoder", "mask_decoder"})
        must lie on `device` (the card unless "cpu" is asked for)."""
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seg_tool = SegToolBox(sam_size=cfg.vision.img_size)
        self._embedding: Optional[torch.Tensor] = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    def set_image(self, image: np.ndarray) -> None:
        """image: RGB uint8 [H, W, 3]."""
        self.original_size = image.shape[:2]
        resized = self.seg_tool.apply_image(image)
        self.input_size = resized.shape[:2]
        pre = torch.as_tensor(self.seg_tool.preprocess(resized)[None], device=self.device)
        self._embedding = image_encoder.encode(self.params["image_encoder"], self.cfg.vision, pre)

    def _scale_coords(self, coords: np.ndarray) -> np.ndarray:
        oh, ow = self.original_size
        nh, nw = get_preprocess_shape(oh, ow, self.cfg.vision.img_size)
        out = np.asarray(coords, np.float32).copy()
        out[..., 0] *= nw / ow
        out[..., 1] *= nh / oh
        return out

    @torch.no_grad()
    def _decode(self, sparse: torch.Tensor, dense: torch.Tensor):
        """The mask decoder's three multimask outputs for one prompt:
        (low_res [1, 3, 4g, 4g], iou [1, 3])."""
        p, cfg = self.params, self.cfg
        return mask_decoder.decode_masks(
            p["mask_decoder"], cfg.decoder, self._embedding,
            prompt_encoder.dense_positional_embedding(p["prompt_encoder"], cfg.prompt),
            sparse, dense, multimask_output=True,
        )

    @torch.no_grad()
    def predict(
        self,
        point_coords: Optional[np.ndarray] = None,  # [N, 2] (x, y) pixels
        point_labels: Optional[np.ndarray] = None,  # [N] 1 fg / 0 bg
        box: Optional[np.ndarray] = None,  # [4] xyxy pixels
        multimask_output: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (masks [M, H, W] bool, iou_predictions [M],
        low_res_logits [M, 4g, 4g])."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        dev = self.device
        points = None
        if point_coords is not None:
            points = (
                torch.as_tensor(self._scale_coords(point_coords), device=dev)[None],
                torch.as_tensor(np.asarray(point_labels, np.int32), device=dev)[None],
            )
        boxes = None
        if box is not None:
            corners = self._scale_coords(np.asarray(box, np.float32).reshape(2, 2))
            boxes = torch.as_tensor(corners.reshape(1, 1, 4), device=dev)
        sparse, dense = prompt_encoder.encode_prompts(
            self.params["prompt_encoder"], self.cfg.prompt, batch=1, points=points, boxes=boxes,
        )
        low_res, iou = self._decode(sparse, dense)
        low_res = low_res[0].float().cpu().numpy()
        iou = iou[0].float().cpu().numpy()
        if not multimask_output:
            low_res, iou = low_res[:1], iou[:1]
        masks = sam_build.postprocess_masks_host(
            low_res, input_size=self.input_size, original_size=self.original_size,
            img_size=self.cfg.vision.img_size,
        )
        return masks > 0, iou, low_res
