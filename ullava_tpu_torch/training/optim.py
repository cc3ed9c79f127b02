"""Optimizer construction: AdamW + freeze policies + LR schedules
(counterpart of `ullava_tpu/training/optim.py`).

Freeze policies are path patterns over the parameter tree, as in the JAX
package: stage-1 pretraining trains only the vision projector and the
input embeddings, stage-1 finetuning the LLM and the projector (CLIP
always frozen). Paths join dict keys with "/" and skip list indices, so a
per-layer leaf of the port's `layers` list has the path of the JAX tree's
stacked leaf ("core/llm/layers/q_proj") and the JAX regexes hold as they
are. `partition_params` sets `requires_grad` from the labels: a frozen
leaf never gets a gradient, so autograd forms no weight gradient of the
frozen towers (the memory the JAX package saves by differentiating the
trainable subtree alone).

`make_optimizer` is optax's `chain(clip_by_global_norm, adamw)` written
out: the same clip (by `g * max / |g|` once `|g| >= max`), the same Adam
moments in the parameter's dtype and bias corrections, the same schedule
step (the update count before this update), every op in the leaf's dtype
with the constants rounded to it (bit for bit with optax on bf16 leaves).
It updates the parameters IN PLACE (the JAX version returns new arrays).
On `DTensor` parameters (`parallel/`) each rank updates its own shards
with the moments placed as their parameter; `global_norm`, and so the
clip, sums the squares over every shard.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

# Trainable-path regexes of each stage.
STAGE1_PRETRAIN = (
    r"^core/projector/",
    r"^core/llm/embed_tokens$",
)
STAGE1_FINETUNE = (
    r"^core/llm/",
    r"^core/projector/",
)
STAGE2 = (
    r"^core/llm/",
    r"^seg_projector/",
    r"^det_projector/",
    r"^det_decoder/",
    r"^sam/mask_decoder/(?!iou_head)",  # iou head frozen (reference quirk)
)
# The adapters as `llama.add_lora` names them. (The JAX package's pattern,
# `(q|v)_lora_(a|b)`, names no leaf, so there no adapter trains: a
# departure on purpose.)
STAGE2_LORA = (
    r"^core/llm/layers/(q|v)_proj_lora_(a|b)$",
    r"^core/llm/embed_tokens$",
    r"^core/llm/lm_head$",
    r"^seg_projector/",
    r"^det_projector/",
    r"^det_decoder/",
    r"^sam/mask_decoder/(?!iou_head)",
)

# Paths relative to a bare stage-1 param tree (no 'core/' prefix).
STAGE1_PRETRAIN_BARE = (r"^projector/", r"^llm/embed_tokens$")
STAGE1_FINETUNE_BARE = (r"^llm/", r"^projector/")

Schedule = Callable[[int], float]


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf in tree order; list indices are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from named_leaves(v, prefix)
    else:
        yield prefix, tree


def _map(fn, tree: Any, labels: Any = None, prefix: str = "") -> Any:
    """`fn(path, leaf, label)` over a tree (and a label tree of the same
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if labels is None else labels[k],
                        f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, None if labels is None else labels[i], prefix)
                for i, v in enumerate(tree)]
    return fn(prefix, tree, labels)


def trainable_labels(params: Any, patterns: Sequence[str]) -> Any:
    """'train' / 'freeze' label tree; integer leaves (int8 weights) are
    always frozen."""
    regs = [re.compile(p) for p in patterns]

    def label(path, leaf, _):
        if isinstance(leaf, torch.Tensor) and not leaf.is_floating_point():
            return "freeze"
        return "train" if any(r.search(path) for r in regs) else "freeze"

    return _map(label, params)


def partition_params(params: Any, labels: Any) -> List[torch.Tensor]:
    """Set `requires_grad` on every leaf from its label and return the
    trainable leaves in tree order."""
    train: List[torch.Tensor] = []

    def mark(_, leaf, lab):
        if isinstance(leaf, torch.Tensor):
            leaf.requires_grad_(lab == "train")
            if lab == "train":
                train.append(leaf)
        return leaf

    _map(mark, params, labels)
    return train


def merge_params(train: Any, frozen: Any) -> Any:
    """The tree of `train` with its None leaves taken from `frozen` (the
    JAX `merge_params` over the two halves `partition_params` gives
    there; here the trainable leaves live in the tree itself)."""
    if isinstance(train, dict):
        return {k: merge_params(v, frozen[k]) for k, v in train.items()}
    if isinstance(train, (list, tuple)):
        return [merge_params(a, b) for a, b in zip(train, frozen)]
    return frozen if train is None else train


def make_lr_schedule(
    learning_rate: float,
    total_steps: int,
    warmup_ratio: float = 0.03,
    schedule: str = "linear",
) -> Schedule:
    """Linear warmup from 0 joined to linear, cosine or constant decay
    (optax's `join_schedules` of `linear_schedule` and the decay, as the
    JAX package builds it; HF-Trainer-equivalent)."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay_steps = max(total_steps - warmup, 1)

    def ramp(count, steps):  # optax.linear_schedule(0 -> 1) over `steps`
        return min(max(count, 0), steps) / steps

    if schedule == "linear":
        decay = lambda c: learning_rate * (1.0 - ramp(c, decay_steps))  # noqa: E731
    elif schedule == "cosine":
        decay = lambda c: learning_rate * 0.5 * (  # noqa: E731
            1.0 + math.cos(math.pi * min(c, decay_steps) / decay_steps))
    elif schedule == "constant":
        decay = lambda c: learning_rate  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {schedule}")

    def lr(step: int) -> float:
        return learning_rate * ramp(step, warmup) if step < warmup else decay(step - warmup)

    return lr


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's `global_norm`: each leaf's sum of squares in its dtype
    (squares in the leaf's dtype, summed in fp32), summed over leaves. A
    DTensor leaf sums its shards' fp32 sums over the mesh axes it is
    sharded on."""
    total = None
    for t in tensors:
        loc = _local(t)
        sq = (loc * loc).float().sum()
        if isinstance(t, DTensor):
            for i, p in enumerate(t.placements):
                if isinstance(p, Shard):
                    dist.all_reduce(sq, group=t.device_mesh.get_group(i))
        sq = sq.to(t.dtype)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class AdamW:
    """`optax.chain(clip_by_global_norm(grad_clip), adamw(...))` over a list
    of trainable tensors, updated in place. State: {"count", "mu", "nu"},
    the moments in each parameter's dtype."""

    def __init__(self, learning_rate: Union[float, Schedule], *, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 1.0):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [torch.zeros_like(p, requires_grad=False) for p in params],
                "nu": [torch.zeros_like(p, requires_grad=False) for p in params]}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """Apply one update to `params` in place; returns the new state."""
        g_norm = global_norm(grads) if self.grad_clip else None
        grads, params = [_local(g) for g in grads], [_local(p) for p in params]
        if self.grad_clip:
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, g / g_norm.to(g.dtype) * self.grad_clip) for g in grads]
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** count
        step = torch.tensor(-self.lr(state["count"]), dtype=f32)
        consts = {}
        for p, g, mu, nu in zip(params, grads, map(_local, state["mu"]), map(_local, state["nu"])):
            # Every op in the leaf's dtype, each constant a tensor of that
            # dtype, as JAX rounds optax's Python scalars to the leaf's
            # dtype (in bf16, b2 = 0.999 is 1.0 and b1 is 0.8984375).
            dt = p.dtype
            if (dt, p.device) not in consts:
                consts[dt, p.device] = torch.tensor(
                    [1 - self.b1, self.b1, 1 - self.b2, self.b2, self.eps, self.weight_decay],
                    dtype=dt).to(p.device).unbind()
            c1, b1, c2, b2, eps, wd = consts[dt, p.device]
            mu.copy_(c1 * g + b1 * mu)
            nu.copy_(c2 * (g * g) + b2 * nu)
            u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt)) + eps)
            u = u + wd * p
            p.copy_(p + u * step.to(dt))
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(
    learning_rate: Union[float, Schedule],
    *,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW over the TRAINABLE leaves only (see `partition_params`), after
    a clip by the global norm (none when `grad_clip` is 0)."""
    return AdamW(learning_rate, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                 grad_clip=grad_clip)
