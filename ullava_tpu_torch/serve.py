"""Serving entry point of the port: batch a few preprocessed RES requests
and run `ullava.evaluate` on them, greedy by default (counterpart of the
RES serve of `bench.py`; the tokenizer-driven CLI from checkpoint files is
`inference_ullava.py`).

A request is a dict with
  input_ids  - the prompt's token ids (sequence of ints), including the
               `<img_beg>` marker followed by the image patch slots;
  image      - [224, 224, 3] float, CLIP-normalized NHWC;
  image_sam  - [1024, 1024, 3] float, SAM-normalized and zero-padded NHWC.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ullava_tpu_torch import kernels, resolve_device
from ullava_tpu_torch.models import ullava
from ullava_tpu_torch.models.generate import GenerateConfig


def collate(requests: Sequence[Dict[str, Any]], device) -> Dict[str, torch.Tensor]:
    """Right-pad the prompts into one batch and move it to `device`."""
    lens = [len(r["input_ids"]) for r in requests]
    ids = np.zeros((len(requests), max(lens)), np.int64)
    for i, r in enumerate(requests):
        ids[i, : lens[i]] = np.asarray(r["input_ids"], np.int64)

    def stack(key):
        return torch.as_tensor(np.stack([np.asarray(r[key], np.float32) for r in requests]))

    return {
        "input_ids": torch.as_tensor(ids).to(device),
        "prompt_lens": torch.tensor(lens, dtype=torch.int32).to(device),
        "images": stack("image").to(device),
        "images_sam": stack("image_sam").to(device),
    }


def serve(
    model: Tuple[ullava.UllavaConfig, Dict[str, Any]],
    requests: Sequence[Dict[str, Any]],
    device=None,
    gen: GenerateConfig = GenerateConfig(max_new_tokens=32, temperature=0.0),
) -> Dict[str, Any]:
    """Serve one batch of requests. Returns the generated sequences (one
    list of ids per request, prompt included), the low-res masks
    [B, max_masks, 256, 256], the boxes [B, max_boxes, 4], their validity,
    and the launch count of each kernel during this call."""
    cfg, params = model
    device = resolve_device(device)
    before = kernels.launch_counts()
    out = ullava.evaluate(params, cfg, gen, **collate(requests, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = kernels.launch_counts()
    lengths = out["lengths"].tolist()
    seqs = out["sequences"].cpu().numpy()
    return {
        "sequences": [seqs[i, : n].tolist() for i, n in enumerate(lengths)],
        "low_res_masks": out["low_res_masks"],
        "pred_boxes": out["pred_boxes"],
        "seg_valid": out["seg_valid"],
        "loc_valid": out["loc_valid"],
        "launches": {k: after[k] - before[k] for k in after},
    }
