"""Projector heads (counterpart of `ullava_tpu/models/projector.py`):
vision -> LLM projector ('mlp' one linear, 'mlp2x' Linear-GELU-Linear),
the [SEG]/[LOC] text heads Linear-ReLU-Linear and the box decoder
Linear-ReLU-Linear-ReLU-Linear."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from ullava_tpu_torch.models import linear_init

Params = Dict[str, Any]


def init_mlp(gen, dims: Sequence[int], dtype, device) -> Params:
    return {f"fc{i}": linear_init(gen, dims[i], dims[i + 1], dtype, device)
            for i in range(len(dims) - 1)}


def apply_mlp(params: Params, x: torch.Tensor, activation=F.relu) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        p = params[f"fc{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = activation(x)
    return x


def init_vision_projector(gen, in_dim, out_dim, projector_type="mlp", dtype=torch.float32,
                          device="cuda") -> Params:
    if projector_type == "mlp":
        return init_mlp(gen, [in_dim, out_dim], dtype, device)
    if projector_type == "mlp2x":
        return init_mlp(gen, [in_dim, out_dim, out_dim], dtype, device)
    raise NotImplementedError(f"projector type {projector_type}")


def apply_vision_projector(params: Params, feats: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return apply_mlp(params, feats, activation=lambda x: F.gelu(x, approximate="tanh"))


def init_text_head(gen, in_dim=4096, out_dim=256, dtype=torch.float32, device="cuda"):
    return init_mlp(gen, [in_dim, in_dim, out_dim], dtype, device)


def apply_text_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_mlp(params, x, activation=F.relu)


def init_box_decoder(gen, in_dim=256, dtype=torch.float32, device="cuda"):
    return init_mlp(gen, [in_dim, 256, 128, 4], dtype, device)


def apply_box_decoder(params: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_mlp(params, x, activation=F.relu)
