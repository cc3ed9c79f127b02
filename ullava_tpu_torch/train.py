"""Training on synthetic batches: stage 1 and stage 2 (counterparts of
what `train_ullava_core.py:66-92` and `train_ullava.py:82-86` wire once a
model and a loader exist, and of `bench.py`'s synthetic batches,
`bench.py:139-159` and `:863-882`). The YAML-, dataset- and
tokenizer-driven CLIs are `train_ullava_core.py`, `train_ullava.py` and
`eval_ullava.py` in this package.

    from ullava_tpu_torch import train
    batch = train.make_batch(cfg, batch=4, seq=1024, device="cuda")
    state = train.train_stage1(cfg, core_params, train.SyntheticLoader([batch] * 8),
                               {"learning_rate": 2e-3, "output_dir": "out"})

    cfg, params = train.build_stage2(ucfg, ullava.init_params(ucfg))  # int8 towers, LoRA r=8
    batch = train.make_stage2_batch(cfg, batch=4, seq=512, device="cuda")
    state = train.train_stage2(cfg, params, train.SyntheticLoader([batch] * 8),
                               {"learning_rate": 2e-4, "output_dir": "out"})

Stage 1's freeze policy follows `cfg.projector_from_scratch`: pretraining
trains the projector and the input embeddings, finetuning the LLM and the
projector; CLIP is always frozen. Stage 2 trains the LoRA adapters, the
input embeddings and `lm_head` (`STAGE2_LORA`), or the whole LLM without
adapters (`STAGE2`), and in both the [SEG]/[LOC] heads and the SAM mask
decoder but its IoU head; CLIP, the projector and the SAM image and
prompt encoders are frozen. Everything runs on "cuda" unless the caller
passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.constants import IGNORE_INDEX
from ullava_tpu_torch.models import llama, ullava
from ullava_tpu_torch.models.ullava_core import UllavaCoreConfig
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import (
    TrainState,
    make_stage1_step,
    make_stage2_step,
    make_train_state,
)
from ullava_tpu_torch.training.trainer import Trainer


def make_batch(cfg: UllavaCoreConfig, batch: int, seq: int, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """A synthetic stage-1 batch (numpy seed): random text ids (below 1000
    and the vocabulary size) with the image span after `<img_beg>` at
    position 1, labels IGNORE_INDEX over the image prefix, full
    `attn_lens`, and normal [B, H, W, 3] images."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    P = cfg.vision.num_patches
    ids = rng.integers(5, min(1000, cfg.llm.vocab_size), size=(batch, seq)).astype(np.int64)
    ids[:, 1] = cfg.img_start_id
    ids[:, 2:2 + P] = 3
    ids[:, 2 + P] = cfg.img_end_id
    labels = ids.copy()
    labels[:, :2 + P + 1] = IGNORE_INDEX
    side = cfg.vision.image_size
    images = rng.standard_normal((batch, side, side, 3)).astype(np.float32)
    return {
        "input_ids": torch.as_tensor(ids, device=device),
        "labels": torch.as_tensor(labels, device=device),
        "attn_lens": torch.full((batch,), seq, dtype=torch.int32, device=device),
        "images": torch.as_tensor(images, device=device),
    }


class SyntheticLoader:
    """A fixed list of batches as the Trainer's loader (one epoch = the
    list; `iter_from` skips without touching the skipped batches)."""

    def __init__(self, batches: Sequence[Dict[str, Any]]):
        self.batches = list(batches)

    def __len__(self) -> int:
        return len(self.batches)

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        return iter(self.batches)

    def iter_from(self, start: int):
        return iter(self.batches[start:])


def build_stage1(
    cfg: UllavaCoreConfig, core_params: Dict[str, Any], training_cfg: Mapping[str, Any],
    total_steps: int,
) -> Tuple[TrainState, Callable, Callable]:
    """(state, step_fn, lr schedule) for stage 1: the schedule and AdamW
    from `training_cfg`, the freeze policy by `projector_from_scratch`.
    The params are trained in place under a 'core' key."""
    schedule, tx = _schedule_and_optimizer(training_cfg, 2e-3, total_steps)
    patterns = optim.STAGE1_PRETRAIN if cfg.projector_from_scratch else optim.STAGE1_FINETUNE
    state, labels = make_train_state({"core": core_params}, tx, patterns)
    return state, make_stage1_step(cfg, tx, labels), schedule


def _schedule_and_optimizer(training_cfg: Mapping[str, Any], default_lr: float, total_steps: int):
    schedule = optim.make_lr_schedule(
        float(training_cfg.get("learning_rate", default_lr)),
        max(total_steps, 1),
        warmup_ratio=float(training_cfg.get("warmup_ratio", 0.03)),
        schedule=training_cfg.get("lr_scheduler_type", "linear"),
    )
    tx = optim.make_optimizer(schedule, weight_decay=float(training_cfg.get("weight_decay", 0.0)))
    return schedule, tx


def train_stage1(
    cfg: UllavaCoreConfig, core_params: Dict[str, Any], loader, training_cfg: Mapping[str, Any],
    device=None,
) -> TrainState:
    """Stage-1 training of `core_params` (on `device`) over `loader`'s
    batches, which are moved to `device`, for
    `training_cfg["num_train_epochs"]` epochs; checkpoints and resume
    under `training_cfg["output_dir"]` (see `Trainer`)."""
    device = resolve_device(device)
    epochs = int(training_cfg.get("num_train_epochs", 1))
    state, step, schedule = build_stage1(cfg, core_params, training_cfg, len(loader) * epochs)
    return _run(state, step, schedule, loader, training_cfg, device)


def _run(state, step, schedule, loader, training_cfg, device) -> TrainState:
    def step_on_device(state, batch):
        return step(state, {k: torch.as_tensor(v).to(device) for k, v in batch.items()})

    trainer = Trainer(state=state, step_fn=step_on_device, train_loader=loader,
                      training_cfg=training_cfg, lr_schedule=schedule)
    return trainer.train(resume=True)


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------


def build_stage2(
    cfg: ullava.UllavaConfig,
    params: Dict[str, Any],
    *,
    quantize: Optional[str] = "int8_towers",
    lora_r: int = 8,
    lora_alpha: float = 16,
    device=None,
) -> Tuple[ullava.UllavaConfig, Dict[str, Any]]:
    """The stage-2 model as `models/build.py:252-283` makes it from a YAML
    config: `quantize` "int8_towers" gives the frozen SAM image encoder
    and CLIP int8 weights (`ullava.quantize_towers`; the encoder then runs
    its fused kernels weight-only, `mlp_w8a8` off), "int8" the LLM as well,
    None neither; `lora_r` > 0 sets `lora_scale = lora_alpha / lora_r` and
    attaches adapters to q_proj and v_proj (generator on `device`).
    Updates `params` in place and returns (cfg, params)."""
    device = resolve_device(device)
    if quantize not in (None, "int8", "int8_towers"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize is not None:
        ullava.quantize_towers(params)
    if quantize == "int8":
        ullava.quantize_llm(params)
    if lora_r > 0:
        llm_cfg = dataclasses.replace(cfg.core.llm, lora_scale=float(lora_alpha) / lora_r)
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, llm=llm_cfg))
        params["core"]["llm"] = llama.add_lora(
            params["core"]["llm"], llm_cfg, torch.Generator(device=device).manual_seed(7), r=lora_r)
    return cfg, params


def make_stage2_batch(cfg: ullava.UllavaConfig, batch: int, seq: int, seed: int = 0,
                      device=None) -> Dict[str, torch.Tensor]:
    """A synthetic stage-2 batch (numpy seed), as `bench.py:863-882`
    builds it: random text ids (below 1000 and the vocabulary size) with
    the image span after `<img_beg>` at position 1, [SEG] at 2 + P + 2 and
    [LOC] at 2 + P + 4, labels equal to the ids, full `attn_lens`, normal
    CLIP and SAM images, random binary masks at the loss frame and random
    boxes in `max_masks` / `max_boxes` slots of which the first is valid,
    and an unpadded SAM frame (`input_hw` = its size)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    P, F = cfg.core.vision.num_patches, cfg.mask_loss_frame
    ids = rng.integers(5, min(1000, cfg.core.llm.vocab_size), size=(batch, seq)).astype(np.int64)
    ids[:, 1] = cfg.core.img_start_id
    ids[:, 2:2 + P] = 3
    ids[:, 2 + P] = cfg.core.img_end_id
    ids[:, 2 + P + 2] = cfg.seg_token_idx
    ids[:, 2 + P + 4] = cfg.loc_token_idx
    side, img = cfg.core.vision.image_size, cfg.sam.vision.img_size
    images = rng.standard_normal((batch, side, side, 3)).astype(np.float32)
    images_sam = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
    gt_masks = (rng.random((batch, cfg.max_masks, F, F)) > 0.5).astype(np.float32)
    gt_boxes = rng.random((batch, cfg.max_boxes, 4)).astype(np.float32)

    def first_valid(n):
        return torch.arange(n, device=device).expand(batch, n) == 0

    return {
        "input_ids": torch.as_tensor(ids, device=device),
        "labels": torch.as_tensor(ids, device=device),
        "attn_lens": torch.full((batch,), seq, dtype=torch.int32, device=device),
        "images": torch.as_tensor(images, device=device),
        "images_sam": torch.as_tensor(images_sam, device=device),
        "gt_masks": torch.as_tensor(gt_masks, device=device),
        "mask_valid": first_valid(cfg.max_masks),
        "gt_boxes": torch.as_tensor(gt_boxes, device=device),
        "box_valid": first_valid(cfg.max_boxes),
        "input_hw": torch.full((batch, 2), img, dtype=torch.int32, device=device),
    }


def build_stage2_step(
    cfg: ullava.UllavaConfig, params: Dict[str, Any], training_cfg: Mapping[str, Any],
    total_steps: int,
) -> Tuple[TrainState, Callable, Callable]:
    """(state, step_fn, lr schedule) for stage 2: the schedule and AdamW
    from `training_cfg` (lr 2e-4 unless it says otherwise,
    `configs/train/ullava_lora.yaml`), the freeze policy `STAGE2_LORA`
    when the LLM carries adapters, else `STAGE2`."""
    schedule, tx = _schedule_and_optimizer(training_cfg, 2e-4, total_steps)
    lora = "q_proj_lora_a" in params["core"]["llm"]["layers"][0]
    state, labels = make_train_state(params, tx, optim.STAGE2_LORA if lora else optim.STAGE2)
    return state, make_stage2_step(cfg, tx, labels), schedule


def train_stage2(
    cfg: ullava.UllavaConfig, params: Dict[str, Any], loader, training_cfg: Mapping[str, Any],
    device=None,
) -> TrainState:
    """Stage-2 training of `params` (on `device`, as `build_stage2` made
    them) over `loader`'s batches, which are moved to `device`, for
    `training_cfg["num_train_epochs"]` epochs; checkpoints and resume
    under `training_cfg["output_dir"]` (see `Trainer`)."""
    device = resolve_device(device)
    epochs = int(training_cfg.get("num_train_epochs", 1))
    state, step, schedule = build_stage2_step(cfg, params, training_cfg, len(loader) * epochs)
    return _run(state, step, schedule, loader, training_cfg, device)
