"""Training loop: the HF-Trainer-equivalent loop (counterpart of
`ullava_tpu/training/trainer.py`). With `mesh=` each batch is sharded
over (dp, fsdp) before the step (`parallel.sharding.shard_batch`).

Epoch loop, per-step logging (loss, lr, grad norm, samples/s),
`save_steps` cadence with `save_total_limit` rotation, resume from the
latest `checkpoint-*`, a per-epoch evaluation hook and a final save.
`callbacks` see the loop's events (`TrainerCallback`).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence

from ullava_tpu_torch.parallel.sharding import shard_batch
from ullava_tpu_torch.training import checkpoint as ckpt
from ullava_tpu_torch.training.train_step import TrainState

logger = logging.getLogger(__name__)


class TrainerCallback:
    """The events of `Trainer.train`, each a no-op here: a subclass
    overrides those it reads (to record or time steps and evals)."""

    def on_train_begin(self, state: TrainState) -> None:
        """After the resume, before the first step."""

    def on_epoch_begin(self, epoch: int, start_batch: int) -> None:
        """Before an epoch's first batch is asked for (`start_batch` is
        where a resumed epoch starts)."""

    def on_step_begin(self, state: TrainState, batch) -> None:
        pass

    def on_step_end(self, state: TrainState, batch, metrics) -> None:
        pass

    def on_evaluate_begin(self) -> None:
        pass

    def on_evaluate_end(self, results) -> None:
        pass


class Trainer:
    def __init__(
        self,
        *,
        state: TrainState,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        train_loader,  # len(), set_epoch(e), iteration; iter_from(i) if it can skip
        training_cfg,  # mapping: num_train_epochs, save_steps, ...
        lr_schedule: Optional[Callable] = None,
        eval_fn: Optional[Callable] = None,  # params -> dict of metrics
        output_dir: Optional[str] = None,
        callbacks: Sequence[TrainerCallback] = (),
        mesh=None,  # a (dp, fsdp, tp) DeviceMesh of a sharded state
    ):
        self.mesh = mesh
        self.state = state
        self.step_fn = step_fn
        self.loader = train_loader
        self.cfg = training_cfg
        self.lr_schedule = lr_schedule
        self.eval_fn = eval_fn
        self.output_dir = output_dir or training_cfg.get("output_dir", "./output")
        self.callbacks = tuple(callbacks)

    def _fire(self, event: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, event)(*args)

    def _get(self, key, default):
        return self.cfg.get(key, default)

    def train(self, resume: bool = True) -> TrainState:
        epochs = int(self._get("num_train_epochs", 1))
        logging_steps = int(self._get("logging_steps", 1))
        save_steps = int(self._get("save_steps", 5000))
        save_total_limit = self._get("save_total_limit", None)
        eval_each_epoch = self._get("evaluation_strategy", "no") == "epoch"

        start_step = 0
        if resume:
            latest = ckpt.latest_checkpoint(self.output_dir)
            if latest:
                logger.info("resuming from %s", latest)
                self.state = ckpt.restore_checkpoint(latest, self.state)
                start_step = int(self.state.step)
        self._fire("on_train_begin", self.state)

        steps_per_epoch = len(self.loader)
        # Resume fast-forward by index arithmetic: whole epochs before the
        # resume point are skipped outright; the resume epoch starts at its
        # batch offset (a loader with `iter_from` skips without fetching).
        resume_epoch = min(start_step // steps_per_epoch, epochs) if steps_per_epoch else 0
        global_step = resume_epoch * steps_per_epoch
        t_last = time.perf_counter()
        for epoch in range(resume_epoch, epochs):
            self.loader.set_epoch(epoch)
            start_batch = start_step - global_step if global_step < start_step else 0
            global_step += start_batch
            self._fire("on_epoch_begin", epoch, start_batch)
            if hasattr(self.loader, "iter_from"):
                epoch_iter = self.loader.iter_from(start_batch)
            else:  # plain iterables: skip by draining
                epoch_iter = iter(self.loader)
                for _ in range(start_batch):
                    next(epoch_iter)
            for batch in epoch_iter:
                self._fire("on_step_begin", self.state, batch)
                step_batch = batch if self.mesh is None else shard_batch(batch, self.mesh)
                self.state, metrics = self.step_fn(self.state, step_batch)
                self._fire("on_step_end", self.state, batch, metrics)
                global_step += 1

                if global_step % logging_steps == 0:
                    loss = float(metrics["loss"])
                    dt = time.perf_counter() - t_last
                    t_last = time.perf_counter()
                    ips = logging_steps * self._batch_size(batch) / max(dt, 1e-9)
                    lr = float(self.lr_schedule(global_step)) if self.lr_schedule else None
                    extra = {k: round(float(v), 4) for k, v in metrics.items() if k != "loss"}
                    logger.info(
                        "epoch %d step %d loss %.4f lr %s %.1f samples/s %s",
                        epoch, global_step, loss,
                        f"{lr:.2e}" if lr is not None else "-", ips, extra,
                    )
                if save_steps and global_step % save_steps == 0:
                    ckpt.save_checkpoint(self.output_dir, global_step, self.state, save_total_limit)
            if eval_each_epoch and self.eval_fn is not None:
                self._fire("on_evaluate_begin")
                results = self.eval_fn(self.state.params)
                self._fire("on_evaluate_end", results)
                logger.info("epoch %d eval: %s", epoch, results)

        ckpt.save_checkpoint(self.output_dir, global_step, self.state, save_total_limit)
        return self.state

    @staticmethod
    def _batch_size(batch: Dict[str, Any]) -> int:
        for v in batch.values():
            if hasattr(v, "shape") and len(v.shape) > 0:
                return int(v.shape[0])
        return 1
