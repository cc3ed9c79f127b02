"""Weight bridge from a JAX parameter tree (as numpy arrays) to the port.

The port keeps the JAX layouts, so the bridge is a copy: arrays become
tensors of the same dtype and shape, except that the stacked per-layer
containers (`layers` of LLaMA and CLIP, `window_blocks` and
`global_blocks` of the SAM encoder), whose leaves carry a leading [L]
axis, are unstacked into lists of per-layer dicts. Lists (the SAM mask
decoder's layers, its hypernetwork MLPs) stay lists. An int8 weight leaf
`{"q": int8 [L, in, out], "scale": f32 [L, 1, out]}` is carried as it
is: int8 stays int8, and both arrays unstack with their layer; `q` is
stored column-major as `ops/quant.py` lays it out (same shape and values).

The input holds numpy arrays only (`jax.tree_util.tree_map(np.asarray,
params)` on the JAX side); bf16 arrays arrive as ml_dtypes bfloat16 and
are carried over exactly through float32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.ops.quant import column_major, is_quantized

STACKED = ("layers", "window_blocks", "global_blocks")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _take(node: Any, i: int) -> Any:
    """Layer `i` of a stacked container whose leaves may be int8 dicts."""
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return node[i]


def _unstack(node: dict, device) -> list:
    first = next(iter(node.values()))
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_convert(_take(node, i), device) for i in range(len(first))]


def _convert(node: Any, device) -> Any:
    if is_quantized(node):
        return {"q": column_major(_tensor(node["q"], device)),
                "scale": _tensor(node["scale"], device)}
    if isinstance(node, dict):
        return {
            k: _unstack(v, device) if k in STACKED and isinstance(v, dict) else _convert(v, device)
            for k, v in node.items()
        }
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return _tensor(node, device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Numpy copy of a JAX parameter tree (e.g. of `ullava.init_params`)
    -> the port's parameter dicts on `device`."""
    return _convert(tree, resolve_device(device))
