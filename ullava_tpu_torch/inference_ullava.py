"""Stage-2 inference CLI of the port: RES / REC / salient segmentation chat
(counterpart of the root `inference_ullava.py`).

    python -m ullava_tpu_torch.inference_ullava --cfg_path <yaml> \
        --image <path> --query "Segment the dog." [--save_dir ./vis] \
        [--device cpu]

CLIP (224, white pad) and SAM (1024) preprocessing, `ullava.evaluate`
(generation, [SEG]/[LOC] readout, SAM decode) on the card unless
`--device` (or `device=`) says otherwise, then the host post-processing:
binary masks at the image's own size and boxes denormalized from the
padded square. `save_dir` writes the mask, overlay and box PNGs (cv2,
imported only then). The image is a path (decoded with PIL) or, from
Python, a uint8 HWC RGB array.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np
import torch

from ullava_tpu_torch.inference_ullava_core import build_prompt, load_image

logger = logging.getLogger("inference_ullava")


def save_visualizations(save_dir: str, image: np.ndarray, results) -> None:
    import cv2

    os.makedirs(save_dir, exist_ok=True)
    for i, m in enumerate(results["masks"]):
        cv2.imwrite(os.path.join(save_dir, f"mask_{i}.png"), m * 255)
        overlay = image.copy()
        overlay[m > 0] = overlay[m > 0] * 0.5 + np.array([255, 0, 0]) * 0.5
        cv2.imwrite(os.path.join(save_dir, f"overlay_{i}.png"),
                    cv2.cvtColor(overlay.astype(np.uint8), cv2.COLOR_RGB2BGR))
    if results["boxes"]:
        canvas = cv2.cvtColor(image.copy(), cv2.COLOR_RGB2BGR)
        for box in results["boxes"]:
            x0, y0, x1, y1 = [int(v) for v in box]
            cv2.rectangle(canvas, (x0, y0), (x1, y1), (0, 0, 255), 2)
        cv2.imwrite(os.path.join(save_dir, "bbox.png"), canvas)
    logger.info("saved visualizations to %s", save_dir)


def prepare_query(u_cfg, tokenizer, image: np.ndarray, query: str, conv_type: str, device,
                  device_preprocess: bool = False):
    """The model's inputs for one query about a uint8 HWC RGB `image`: the
    conversation's prompt ids, CLIP's padded 224 square and SAM's
    normalized 1024 square, each a batch of one on `device`. Returns
    (the `ullava.evaluate` keyword inputs, the conversation, the (h, w) of
    the image resized for SAM before its padding).

    device_preprocess=True ships one uint8 canvas (the longest side
    resized to SAM's size on the host) and runs CLIP's white pad, resize
    and normalization and SAM's normalization as torch ops on `device`
    (`ops/image_ops.py`); else both inputs are made on the host."""
    from ullava_tpu_torch.data.processors import CLIPProcessor
    from ullava_tpu_torch.data.tools.mask_toolbox import SegToolBox
    from ullava_tpu_torch.ops import image_ops

    conv = build_prompt(conv_type, query, u_cfg.core.vision.num_patches)
    ids = np.asarray(tokenizer(conv.get_prompt())["input_ids"], np.int64)
    sam_size = u_cfg.sam.vision.img_size
    if device_preprocess:
        canvas, resize = image_ops.make_canvas(image, sam_size)
        images, images_sam = image_ops.preprocess_canvas(
            torch.as_tensor(canvas[None], device=device),
            torch.tensor([resize], dtype=torch.int32, device=device),
            u_cfg.core.vision.image_size,
        )
    else:
        image_clip = CLIPProcessor(image_size=u_cfg.core.vision.image_size, aspect_ratio="pad")(image)
        seg_tool = SegToolBox(sam_size=sam_size)
        resized = seg_tool.apply_image(image)
        resize = resized.shape[:2]
        images = torch.as_tensor(image_clip[None], device=device)
        images_sam = torch.as_tensor(seg_tool.preprocess(resized)[None], device=device)
    inputs = {
        "input_ids": torch.as_tensor(ids[None], device=device),
        "prompt_lens": torch.tensor([len(ids)], dtype=torch.int32, device=device),
        "images": images,
        "images_sam": images_sam,
    }
    return inputs, conv, tuple(resize)


def answer(u_cfg, params, tokenizer, image: np.ndarray, query: str, conv_type="conv_sep2",
           temperature=0.2, top_p=None, max_new_tokens=64, device=None,
           generator: Optional[torch.Generator] = None, device_preprocess: bool = False):
    """Answer one query about a uint8 HWC RGB `image` on a built model
    (`build.build_ullava`'s config and params, on `device`). Returns
    {"text", "masks" (uint8 [H, W] each), "boxes" (xyxy in the image's
    pixels)}. `device_preprocess` is `prepare_query`'s."""
    from ullava_tpu_torch.data.tools.mask_toolbox import DetToolBox
    from ullava_tpu_torch.models import ullava
    from ullava_tpu_torch.models.generate import GenerateConfig
    from ullava_tpu_torch.models.sam.build import postprocess_masks_host
    from ullava_tpu_torch.models.tools import keyword_stop_ids

    height, width = image.shape[:2]
    inputs, conv, resize = prepare_query(
        u_cfg, tokenizer, image, query, conv_type, device, device_preprocess)
    prompt_len = int(inputs["prompt_lens"][0])

    stops = keyword_stop_ids(tokenizer, [conv.sep2 or conv.sep])
    out = ullava.evaluate(
        params, u_cfg,
        GenerateConfig(max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                       stop_token_ids=stops, vocab_size=len(tokenizer)),
        **inputs, generator=generator,
    )

    T = int(out["lengths"][0])
    text = tokenizer.decode(out["sequences"][0, prompt_len:T].cpu().numpy(),
                            skip_special_tokens=True).strip()
    results = {"text": text, "masks": [], "boxes": []}
    n_seg = int(out["seg_valid"][0].sum())
    if n_seg:
        masks = postprocess_masks_host(
            out["low_res_masks"][0, :n_seg].float().cpu().numpy(),
            input_size=resize, original_size=(height, width),
            img_size=u_cfg.sam.vision.img_size,
        )
        results["masks"] = [(m > 0).astype(np.uint8) for m in masks]
    det_tool = DetToolBox()
    boxes = out["pred_boxes"][0].float().cpu().numpy()
    for j in range(int(out["loc_valid"][0].sum())):
        results["boxes"].append(det_tool.denormalize_padded_xyxy(boxes[j], width, height))
    return results


def run_once(cfg, image, query, temperature=0.2, top_p=None, max_new_tokens=64,
             save_dir=None, tokenizer=None, device=None,
             generator: Optional[torch.Generator] = None):
    """Build the model from `cfg` on `device` (the card when None) and
    answer one query about `image` (`answer`)."""
    from ullava_tpu_torch import resolve_device
    from ullava_tpu_torch.models import build as model_build

    device = resolve_device(device)
    model_cfg = cfg.model_cfg
    if tokenizer is None:
        tokenizer = model_build.build_tokenizer(model_cfg.get("llm_path"))
    u_cfg, params = model_build.build_ullava(model_cfg, tokenizer, device=device)

    image = load_image(image)
    results = answer(u_cfg, params, tokenizer, image, query,
                     model_cfg.get("conv_type", "conv_sep2"), temperature, top_p,
                     max_new_tokens, device, generator)
    if save_dir:
        save_visualizations(save_dir, image, results)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--query", required=True)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--max_new_tokens", type=int, default=64)
    parser.add_argument("--save_dir", default="./vis")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    from ullava_tpu_torch.config import Config
    import ullava_tpu_torch.models.build  # noqa: F401  (registers the archs)

    res = run_once(Config(args.cfg_path), args.image, args.query, args.temperature,
                   args.top_p, args.max_new_tokens, args.save_dir, device=args.device)
    print("ASSISTANT:", res["text"])
    print(f"{len(res['masks'])} masks, {len(res['boxes'])} boxes")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
