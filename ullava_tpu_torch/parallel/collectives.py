"""The collectives of the sharded paths, with autograd where a gradient
crosses them.

Tensor parallelism in the LLaMA decoder is explicit (Megatron's scheme,
in place of the propagation XLA does for the JAX package): the input of
the column-parallel projections enters the tp region through
`copy_to_tp` (identity forward, all-reduce of the gradient), and the
row-parallel outputs leave it through `reduce_from_tp` (all-reduce
forward, identity backward). `gather_from_tp` concatenates the ranks'
shards of a dim (its backward takes the rank's slice back). Over a tp
group of one rank each of them is the identity and issues nothing, so a
(dp, fsdp, 1) mesh's decode loop runs no per-layer collective.

`data_parallel(mesh)` marks the training step's extent: inside it
`global_sum` adds a count over the data ranks (dp x fsdp), so that a loss
divides by the global count of valid tokens, masks or boxes, as the JAX
step computes over the global batch (a mean of per-rank means is another
loss). Outside it `global_sum` is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class TPGroup:
    size: int
    rank: int
    group: Any  # the ProcessGroup of this rank's tp axis


def tp_group(leaf: Any) -> Optional[TPGroup]:
    """The tp group of a DTensor weight's mesh (None for a plain tensor)."""
    if isinstance(leaf, dict):  # an int8 {"q", "scale"} leaf
        leaf = leaf.get("q")
    if not isinstance(leaf, DTensor):
        return None
    mesh = leaf.device_mesh
    return TPGroup(mesh.size(mesh.mesh_dim_names.index("tp")), mesh.get_local_rank("tp"),
                   mesh.get_group("tp"))


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


# `all_gather_single` where this torch has it (the older name is deprecated).
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _stack(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size, *x.shape]: every rank's `x`, in rank order. The buffer is the
    concatenation along dim 0, the one layout gloo takes."""
    x = x.contiguous()
    buf = x.new_empty((size * x.numel(),))
    _gather_into(buf, x.reshape(-1), group=group)
    return buf.reshape((size,) + tuple(x.shape))


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, in rank order."""
    dim = dim % x.ndim
    buf = _stack(x, group, size)
    return buf.movedim(0, dim).reshape(x.shape[:dim] + (size * x.shape[dim],) + x.shape[dim + 1:])


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return _all_gather(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


def copy_to_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.size == 1 else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.size == 1 else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: TPGroup, dim: int = -1) -> torch.Tensor:
    return x if tp.size == 1 else _GatherFromTP.apply(x, tp, dim)


def all_gather_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """[tp, *x.shape]: every tp rank's `x` (no autograd)."""
    return x[None] if tp.size == 1 else _stack(x, tp.group, tp.size)


# ---------------------------------------------------------------------------
# Data-parallel extent of a training step
# ---------------------------------------------------------------------------

_DATA_MESHES: List[Any] = []


@contextlib.contextmanager
def data_parallel(mesh) -> Iterator[None]:
    """Within the block, `global_sum` reduces over `mesh`'s (dp, fsdp)."""
    _DATA_MESHES.append(mesh)
    try:
        yield
    finally:
        _DATA_MESHES.pop()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` (a count or a metric, no gradient) summed over the data ranks
    of the enclosing `data_parallel` block; `t` itself outside one."""
    if not _DATA_MESHES:
        return t
    mesh = _DATA_MESHES[-1]
    out = t.detach()
    for axis in ("dp", "fsdp"):
        out = _all_reduce(out, mesh.get_group(axis))
    return out


def gather_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The data ranks' `x` concatenated along dim 0 (fsdp inner, dp outer:
    the order in which `shard_batch` split the batch)."""
    for axis in ("fsdp", "dp"):
        x = _all_gather(x, mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), 0)
    return x


def all_data_done(done: torch.Tensor, mesh) -> bool:
    """Whether every rank of this rank's fsdp group is done (decode steps
    gather weights over fsdp, so its ranks stop together)."""
    flag = done.all().to(torch.int32).reshape(1)
    if mesh.size(mesh.mesh_dim_names.index("fsdp")) > 1:
        flag = _all_reduce(flag, mesh.get_group("fsdp"), dist.ReduceOp.MIN)
    return bool(flag.item())
