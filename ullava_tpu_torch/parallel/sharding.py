"""Parameter placements by tree-path rules, and the local tensors the
kernels take (counterpart of `ullava_tpu/parallel/sharding.py`).

One rule table maps parameter paths (joined with '/') to (fsdp_dim,
tp_dim) placements; everything else replicates. The optimizer moments
take their parameter's placement (`training/train_step.py`). Paths are
`training/optim.py:named_leaves` paths, which skip list indices, so a
per-layer leaf of a `layers` list takes the rule of the JAX tree's
stacked `[L, ...]` leaf; the dims are negative, so they name the same
axes of both. A dim that does not divide by its mesh axis replicates
instead. Int8 leaves (`{"q", "scale"}`) and LoRA adapters match no rule
and replicate, in both packages.

`shard_params` gives `DTensor` leaves; a kernel never sees one. Model
code takes the local tensor of a weight through `local_weight` (the
weight's fsdp shards gathered by a differentiable `redistribute`, whose
backward reduce-scatters the gradient onto the shard, as ZeRO-3 does)
or `whole` (a subtree gathered entire, for the towers and heads that run
unsharded). Both assume the training step's semantics: each data rank
holds its own part of the batch, so a weight's gradient is a partial sum
over the data ranks.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

from ullava_tpu_torch.parallel.mesh import AXIS_NAMES, data_rank, mesh_sizes

# path-regex -> (fsdp axis position, tp axis position); None = replicated dim.
# Positions are negative (from the right), so per-layer leaves and the JAX
# tree's stacked [L, ...] leaves share rules.
_RULES: Tuple[Tuple[str, Tuple[Optional[int], Optional[int]]], ...] = (
    # LLaMA decoder
    (r"llm/embed_tokens$", (-1, -2)),        # [V, D]: V on tp, D on fsdp
    (r"llm/layers/(q|k|v)_proj$", (-2, -1)),  # [D, H*hd]
    (r"llm/layers/o_proj$", (-1, -2)),        # [H*hd, D]
    (r"llm/layers/(gate|up)_proj$", (-2, -1)),
    (r"llm/layers/down_proj$", (-1, -2)),
    (r"llm/lm_head$", (-2, -1)),              # [D, V]
    # CLIP tower (frozen, fsdp-shard the big matrices)
    (r"vision/layers/(q|k|v)_proj$", (-2, -1)),
    (r"vision/layers/out_proj$", (-1, -2)),
    (r"vision/layers/fc1$", (-2, -1)),
    (r"vision/layers/fc2$", (-1, -2)),
    (r"vision/patch_proj$", (-2, None)),
    # mm projector
    (r"projector/fc\d+/w$", (-2, -1)),
    # SAM encoder (frozen; shard the big weights over fsdp)
    (r"sam/image_encoder/(window|global)_blocks/qkv$", (-2, -1)),
    (r"sam/image_encoder/(window|global)_blocks/proj$", (-1, -2)),
    (r"sam/image_encoder/(window|global)_blocks/fc1$", (-2, -1)),
    (r"sam/image_encoder/(window|global)_blocks/fc2$", (-1, -2)),
    # seg/det heads
    (r"(seg|det)_projector/fc\d+/w$", (-2, -1)),
)

Spec = Tuple[Optional[str], ...]  # per tensor dim: the mesh axis sharding it, or None


def _spec_for(path: str, ndim: int, shape, mesh_shape: Dict[str, int]) -> Spec:
    """The JAX `PartitionSpec` of a leaf, as a tuple of axis names."""
    for pat, (fsdp_dim, tp_dim) in _RULES:
        if re.search(pat, path):
            axes: list = [None] * ndim
            if fsdp_dim is not None and mesh_shape.get("fsdp", 1) > 1:
                d = ndim + fsdp_dim
                if 0 <= d < ndim and shape[d] % mesh_shape["fsdp"] == 0:
                    axes[d] = "fsdp"
            if tp_dim is not None and mesh_shape.get("tp", 1) > 1:
                d = ndim + tp_dim
                if 0 <= d < ndim and axes[d] is None and shape[d] % mesh_shape["tp"] == 0:
                    axes[d] = "tp"
            return tuple(axes)
    return (None,) * ndim  # replicate


def placements_of(spec: Spec) -> Tuple[Placement, ...]:
    """A spec as one placement per mesh axis: Shard(d) where tensor dim d
    is on that axis, else Replicate()."""
    return tuple(Shard(spec.index(a)) if a in spec else Replicate() for a in AXIS_NAMES)


def spec_of(placements: Sequence[Placement], ndim: int) -> Spec:
    """The inverse of `placements_of`, to hold placements to JAX specs."""
    axes: list = [None] * ndim
    for a, p in zip(AXIS_NAMES, placements):
        if isinstance(p, Shard):
            axes[p.dim] = a
    return tuple(axes)


def _map_leaves(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, prefix) for v in tree]
    return fn(prefix, tree)


def param_partition_specs(params: Any, mesh) -> Any:
    """Tree of placement tuples (one per mesh axis) matching `params`;
    `mesh` is a DeviceMesh or a mapping {axis: size}. Non-tensor leaves
    map to None."""
    sizes = mesh_sizes(mesh)

    def leaf_spec(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        return placements_of(_spec_for(path, leaf.ndim, leaf.shape, sizes))

    return _map_leaves(leaf_spec, params)


def place(t: torch.Tensor, mesh, placements) -> DTensor:
    """`t` (the same values on every rank) as a DTensor of `placements`:
    each rank keeps a copy of its own shard (`torch.chunk`'s, of a dim the
    mesh axis divides), no data moves, and a replicated tensor is wrapped
    as it is, its storage and strides kept (a column-major int8 `q` stays
    so); `requires_grad` carries over."""
    loc = t.detach()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = loc.shape[p.dim] // mesh.size(i)
            loc = loc.narrow(p.dim, mesh.get_local_rank(i) * n, n)
    sharded = loc is not t and loc.shape != t.shape
    if sharded:  # the global shape and stride follow from the even shards
        d = DTensor.from_local(loc.contiguous(), mesh, placements, run_check=False)
    else:
        d = DTensor.from_local(loc, mesh, placements, run_check=False, shape=t.shape,
                               stride=t.stride())
    return d.requires_grad_(t.requires_grad) if t.is_floating_point() else d


def shard_params(params: Any, mesh) -> Any:
    """Place a replicated param tree onto the mesh per the rules: every
    tensor leaf becomes a DTensor."""
    specs = param_partition_specs(params, mesh)

    def put(leaf, pl):
        return place(leaf, mesh, pl) if isinstance(leaf, torch.Tensor) else leaf

    def rec(tree, spec):
        if isinstance(tree, dict):
            return {k: rec(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rec(v, s) for v, s in zip(tree, spec)]
        return put(tree, spec)

    return rec(params, specs)


def batch_placements(ndim: int) -> Tuple[Placement, ...]:
    """Batches shard dim 0 over the combined data axes (dp, fsdp)."""
    return (Shard(0), Shard(0), Replicate()) if ndim else (Replicate(),) * 3


def shard_batch(batch: Any, mesh) -> Any:
    """Every tensor of `batch` (the whole global batch, the same on every
    rank) as a DTensor sharded on dim 0 over (dp, fsdp); DTensors pass.
    A batch dim that does not divide by dp * fsdp raises ValueError."""
    n = data_rank(mesh)[1]

    def put(x):
        if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
            return x
        if x.ndim and x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over {n} data shards")
        return place(x, mesh, batch_placements(x.ndim))

    return {k: put(v) for k, v in batch.items()}


def local_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's part of a sharded batch, as plain tensors."""
    return {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}


def mesh_of(tree: Any):
    """The DeviceMesh of the first DTensor leaf of `tree`, or None."""
    if isinstance(tree, DTensor):
        return tree.device_mesh
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = mesh_of(v)
            if m is not None:
                return m
    return None


def local_weight(w: Any, dim: Optional[int] = None, inside: bool = False) -> Any:
    """The plain tensor this rank computes with for weight `w` (a tensor,
    a DTensor or an int8 `{"q", "scale"}` leaf of either):

    - `dim` given: this rank's tp shard along `dim` (column-, row- or
      vocab-parallel use). A weight the rules shard there is already it; a
      replicated one (int8, or a dim that does not divide) is sliced here,
      its gradient then partial over tp.
    - `dim` None and `inside`: the whole weight, used on tp-sharded
      activations (a LoRA adapter inside the column-parallel region): its
      gradient is partial over tp.
    - `dim` None: the whole weight, used on replicated activations (norms,
      the frozen towers, the heads): its gradient is the same on every tp
      rank.

    fsdp shards are gathered by a differentiable redistribute. On the data
    axes the gradient is a partial sum (each rank's own batch). A plain
    tensor passes unchanged (no mesh)."""
    if isinstance(w, dict) and "q" in w and "scale" in w:
        return {"q": local_weight(w["q"], dim),
                "scale": local_weight(w["scale"], -1 if dim == -1 else None)}
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    tp_i = mesh.mesh_dim_names.index("tp")
    tp_p = w.placements[tp_i]
    d = None if dim is None else dim % w.ndim
    sharded = d is not None and isinstance(tp_p, Shard) and tp_p.dim == d
    target = [Replicate()] * mesh.ndim
    grads: list = [Partial()] * mesh.ndim
    if sharded:
        target[tp_i] = grads[tp_i] = tp_p
    elif d is None and not inside:
        grads[tp_i] = Replicate()
    if tuple(target) != tuple(w.placements):
        w = w.redistribute(mesh, target)
    loc = w.to_local(grad_placements=grads)
    tp = mesh.size(tp_i)
    if d is not None and not sharded and tp > 1:
        n = loc.shape[d]
        if n % tp:
            raise ValueError(f"dim {d} of {n} does not split over tp={tp}")
        r = mesh.get_local_rank("tp")
        loc = loc.narrow(d, r * (n // tp), n // tp)
    return loc


def whole(tree: Any) -> Any:
    """`local_weight(leaf)` over a subtree: every DTensor leaf gathered
    entire; a (sub)tree without DTensors comes back as it is (the same
    object)."""
    if isinstance(tree, DTensor):
        return local_weight(tree)
    if isinstance(tree, dict):
        out = {k: whole(v) for k, v in tree.items()}
        return tree if all(out[k] is v for k, v in tree.items()) else out
    if isinstance(tree, (list, tuple)):
        out = [whole(v) for v in tree]
        return tree if all(a is b for a, b in zip(out, tree)) else out
    return tree


def unshard(tree: Any) -> Any:
    """The tree with every DTensor leaf gathered whole (`full_tensor`, a
    collective on every rank) and detached; other leaves as they are."""
    if isinstance(tree, DTensor):
        return tree.detach().full_tensor()
    if isinstance(tree, dict):
        return {k: unshard(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unshard(v) for v in tree]
    return tree
