"""Checkpoint save and resume (counterpart of
`ullava_tpu/training/checkpoint.py`, with `torch.save` in place of orbax).

The same layout: `checkpoint-{step}` directories under the output
directory, `save_total_limit` rotation, and resume from the latest one. A
checkpoint holds one file, `state.pt`: the tree of a `TrainState` (step,
params, optimizer state) or of bare params, with tensors moved to the
CPU. `restore_checkpoint` copies the saved values into the tensors of a
target of the same structure, so they keep their device, dtype and
`requires_grad`. A sharded state (`DTensor` leaves) is gathered whole
for the file, which rank 0 writes, and restored into each rank's shards.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ullava_tpu_torch.parallel.sharding import place
from ullava_tpu_torch.training.train_step import TrainState

_FILE = "state.pt"


def _ckpt_path(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")


def _fields(state: TrainState) -> dict:
    # Not dataclasses.asdict, which deep-copies every tensor.
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, TrainState):
        return {"train_state": _to_cpu(_fields(tree))}
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, DTensor):
        return tree.detach().full_tensor().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def save_checkpoint(
    output_dir: str, step: int, state: Any, save_total_limit: Optional[int] = None
) -> str:
    """Save a TrainState or a params tree to checkpoint-{step}."""
    path = _ckpt_path(output_dir, step)
    tree = _to_cpu(state)  # every rank: gathering a sharded leaf is collective
    if not _multi_rank() or dist.get_rank() == 0:
        save_tree(path, tree)
        if save_total_limit:
            rotate_checkpoints(output_dir, save_total_limit)
    if _multi_rank():
        dist.barrier()
    return path


def save_tree(path: str, tree: Any) -> str:
    """Write `tree` (CPU tensors) as checkpoint directory `path`, replacing
    what was there: the directory `load_saved` and `pretrained_*` read."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(tree, os.path.join(path, _FILE))
    return path


def rotate_checkpoints(output_dir: str, limit: int) -> None:
    for step in list_checkpoints(output_dir)[:-limit]:
        shutil.rmtree(_ckpt_path(output_dir, step), ignore_errors=True)


def list_checkpoints(output_dir: str) -> List[int]:
    if not os.path.isdir(output_dir):
        return []
    steps = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    steps = list_checkpoints(output_dir)
    return _ckpt_path(output_dir, steps[-1]) if steps else None


@torch.no_grad()
def _copy_into(target: Any, saved: Any, saved_shapes: bool = False) -> Any:
    if isinstance(target, dict):
        if set(target) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} != {sorted(target)}")
        return {k: _copy_into(target[k], saved[k], saved_shapes) for k in target}
    if isinstance(target, (list, tuple)):
        if len(target) != len(saved):
            raise ValueError(f"checkpoint list of {len(saved)} != {len(target)}")
        return [_copy_into(t, s, saved_shapes) for t, s in zip(target, saved)]
    if isinstance(target, torch.Tensor):
        if target.dtype != saved.dtype or (target.shape != saved.shape and not saved_shapes):
            raise ValueError(f"checkpoint leaf {saved.dtype} {tuple(saved.shape)} != "
                             f"{target.dtype} {tuple(target.shape)}")
        if target.shape != saved.shape:
            return saved.to(target.device)
        if isinstance(target, DTensor):
            shards = place(saved.to(target.device), target.device_mesh, target.placements)
            target.to_local().copy_(shards.to_local())
            return target
        return target.copy_(saved)
    return saved


def load_saved(path: str) -> Any:
    """The tree saved in checkpoint directory `path` (tensors on the CPU)."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu",
                      weights_only=True)


def trained_params(saved: Any) -> Optional[Any]:
    """The params of a saved TrainState (what the trainer writes), or None
    for a saved bare params tree."""
    if isinstance(saved, dict) and set(saved) == {"train_state"}:
        return saved["train_state"]["params"]
    return None


def restore_saved(saved: Any, target: Any, saved_shapes: bool = False) -> Any:
    """`restore_checkpoint` from a tree `load_saved` returned."""
    if isinstance(target, TrainState):
        tree = _copy_into(_fields(target), saved["train_state"], saved_shapes)
        return TrainState(**tree)
    return _copy_into(target, saved, saved_shapes)


def restore_checkpoint(path: str, target: Any, saved_shapes: bool = False) -> Any:
    """Restore into the structure of `target` (a TrainState or a params
    tree): its tensors are overwritten in place and returned. With
    `saved_shapes`, a saved leaf of another shape than its target's comes
    back at its saved shape (as orbax restores), on the target's device."""
    return restore_saved(load_saved(path), target, saved_shapes)
