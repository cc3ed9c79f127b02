"""Training entry point of the port: stage 1 (counterpart of what
`train_ullava_core.py:66-92` wires once a model and a loader exist, and of
`bench.py`'s synthetic stage-1 batch, `bench.py:139-159`; the dataset- and
tokenizer-driven CLI waits for those files).

    from ullava_tpu_torch import train
    batch = train.make_batch(cfg, batch=4, seq=1024, device="cuda")
    state = train.train_stage1(cfg, core_params, train.SyntheticLoader([batch] * 8),
                               {"learning_rate": 2e-3, "output_dir": "out"})

The freeze policy follows `cfg.projector_from_scratch`: pretraining trains
the projector and the input embeddings, finetuning the LLM and the
projector; CLIP is always frozen. Everything runs on "cuda" unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.constants import IGNORE_INDEX
from ullava_tpu_torch.models.ullava_core import UllavaCoreConfig
from ullava_tpu_torch.training import optim
from ullava_tpu_torch.training.train_step import TrainState, make_stage1_step, make_train_state
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
    schedule = optim.make_lr_schedule(
        float(training_cfg.get("learning_rate", 2e-3)),
        max(total_steps, 1),
        warmup_ratio=float(training_cfg.get("warmup_ratio", 0.03)),
        schedule=training_cfg.get("lr_scheduler_type", "linear"),
    )
    tx = optim.make_optimizer(schedule, weight_decay=float(training_cfg.get("weight_decay", 0.0)))
    patterns = optim.STAGE1_PRETRAIN if cfg.projector_from_scratch else optim.STAGE1_FINETUNE
    state, labels = make_train_state({"core": core_params}, tx, patterns)
    return state, make_stage1_step(cfg, tx, labels), schedule


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

    def step_on_device(state, batch):
        return step(state, {k: torch.as_tensor(v).to(device) for k, v in batch.items()})

    trainer = Trainer(state=state, step_fn=step_on_device, train_loader=loader,
                      training_cfg=training_cfg, lr_schedule=schedule)
    return trainer.train(resume=True)
