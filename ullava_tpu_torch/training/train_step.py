"""The stage-1 and stage-2 train steps, unsharded or over a (dp, fsdp,
tp) mesh (counterpart of `ullava_tpu/training/train_step.py`).

Freeze policy = `requires_grad` from the label tree: gradients are taken
with respect to the trainable leaves only, so the frozen 7B and ViT
towers never get weight gradients or Adam moments. The step updates the
parameters in place and returns the state with the new step count.

Sharded (`shard_train_state`, then `jit_step`): the parameters and the
AdamW moments are `DTensor`s (a moment takes its parameter's placement by
tree position), each rank computes its own part of the global batch, the
losses divide by global counts, a gradient comes back reduce-scattered
onto its parameter's shards (and all-reduced over dp), and each rank
updates its shards. `jit_step` keeps the JAX name for the reader; it
compiles nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ullava_tpu_torch.models import ullava, ullava_core
from ullava_tpu_torch.parallel.collectives import data_parallel, global_sum
from ullava_tpu_torch.parallel.sharding import local_batch, mesh_of, place, shard_batch, shard_params
from ullava_tpu_torch.training.optim import (
    AdamW,
    global_norm,
    partition_params,
    trainable_labels,
)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any  # full model params
    opt_state: Any  # optimizer state over the trainable leaves only


def make_train_state(
    params: Any, tx: AdamW, trainable_patterns: Sequence[str]
) -> Tuple[TrainState, Any]:
    """Returns (state, labels); the optimizer state covers only the
    trainable leaves."""
    labels = trainable_labels(params, trainable_patterns)
    return TrainState(step=0, params=params, opt_state=tx.init(partition_params(params, labels))), labels


def shard_train_state(state: TrainState, mesh, tx: AdamW, labels: Any) -> TrainState:
    """Place the params per the partition rules (`parallel.sharding`) and
    each AdamW moment as its parameter, by TREE POSITION (the moments
    list the trainable leaves in tree order), so two same-shaped params
    with different placements never trade layouts. The step count is a
    Python int, the same on every rank."""
    params = shard_params(state.params, mesh)
    train = partition_params(params, labels)
    opt = state.opt_state
    opt_state = {"count": opt["count"],
                 **{k: [place(m, p.device_mesh, p.placements) for m, p in zip(opt[k], train)]
                    for k in ("mu", "nu")}}
    return TrainState(step=state.step, params=params, opt_state=opt_state)


def _placed(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements: a mesh axis on
    which it is still a partial sum (the data axes, or tp for a weight used
    sliced or inside the tp region) is all-reduced, one axis at a time."""
    if not isinstance(g, DTensor) or tuple(g.placements) == tuple(p.placements):
        return g
    if any(gp != pp and not (gp.is_partial() and pp.is_replicate())
           for gp, pp in zip(g.placements, p.placements)):
        return g.redistribute(p.device_mesh, p.placements)
    loc = g.to_local().contiguous()
    for i, gp in enumerate(g.placements):
        if gp.is_partial():
            dist.all_reduce(loc, group=p.device_mesh.get_group(i))
    return DTensor.from_local(loc, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


def trainable_grads(loss_fn: Callable, params: Any, labels: Any, batch: Dict[str, Any]):
    """(loss, aux metrics, gradients): `loss_fn` at `params` and the
    gradients of the leaves `labels` trains, in tree order. A leaf the
    batch does not reach (the projector on text-only batches) has a zero
    gradient, as under jax.grad. On DTensor params each gradient is a
    DTensor of its parameter's placements."""
    train = partition_params(params, labels)
    loss, aux = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, train, allow_unused=True)
    return loss, aux, [torch.zeros_like(p) if g is None else _placed(g, p)
                       for p, g in zip(train, grads)]


def _make_step(loss_fn: Callable, tx: AdamW, labels: Any) -> Callable:
    """Generic step: (loss, aux metrics) -> gradients of the trainable
    leaves -> clip and AdamW in place. Metrics: the loss, the global norm
    of the gradients before the clip, and the aux metrics."""

    def step(state: TrainState, batch: Dict[str, Any]):
        loss, aux, grads = trainable_grads(loss_fn, state.params, labels, batch)
        metrics = {"loss": global_sum(loss.detach()), "grad_norm": global_norm(grads),
                   **{k: global_sum(v.detach()) for k, v in aux.items()}}
        opt_state = tx.update(grads, state.opt_state, partition_params(state.params, labels))
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return step


def make_stage1_step(cfg: ullava_core.UllavaCoreConfig, tx: AdamW, labels: Any) -> Callable:
    """Batch keys: input_ids, labels, attn_lens, optionally images/videos.
    Stage-1 params live under a 'core' key, so the freeze patterns are
    shared between stages."""

    def loss_fn(params, batch):
        out = ullava_core.forward(
            params["core"], cfg,
            input_ids=batch["input_ids"],
            labels=batch["labels"],
            attn_lens=batch.get("attn_lens"),
            images=batch.get("images"),
            videos=batch.get("videos"),
        )
        return out["loss"], {}

    return _make_step(loss_fn, tx, labels)


_STAGE2_KEYS = (
    "input_ids", "labels", "attn_lens", "images", "images_sam",
    "gt_masks", "mask_valid", "gt_boxes", "box_valid", "input_hw",
)
STAGE2_AUX = ("ce_loss", "mask_bce_loss", "mask_dice_loss", "bbox_loss")


def stage2_loss(cfg: ullava.UllavaConfig) -> Callable:
    """The stage-2 loss (params, batch) -> (loss, aux metrics). Batch
    keys: `_STAGE2_KEYS` (missing ones are left out); the aux metrics are
    the weighted CE, mask BCE, mask dice and box losses."""

    def loss_fn(params, batch):
        out = ullava.forward(params, cfg, **{k: batch[k] for k in _STAGE2_KEYS if k in batch})
        return out["loss"], {k: out[k] for k in STAGE2_AUX}

    return loss_fn


def make_stage2_step(cfg: ullava.UllavaConfig, tx: AdamW, labels: Any) -> Callable:
    """The step over `stage2_loss`: its metrics add the aux losses."""
    return _make_step(stage2_loss(cfg), tx, labels)


def jit_step(step_fn: Callable) -> Callable:
    """The step on sharded state (`shard_train_state`): the batch, the
    whole global batch on every rank or already `shard_batch`ed, is split
    over (dp, fsdp) and each rank runs `step_fn` on its part, with the
    losses' counts and the metrics summed over the data ranks. On an
    unsharded state it is `step_fn`. (The JAX name; nothing is compiled.)"""

    def step(state: TrainState, batch: Dict[str, Any]):
        mesh = mesh_of(state.params)
        if mesh is None:
            return step_fn(state, batch)
        with data_parallel(mesh):
            return step_fn(state, local_batch(shard_batch(batch, mesh)))

    return step
