"""Model modules of the port (counterparts of `ullava_tpu/models/`)."""

import torch


def normal(gen: torch.Generator, shape, dtype, device, std: float = 0.02) -> torch.Tensor:
    """Random-normal parameter drawn in fp32 from `gen`, stored in `dtype`."""
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def uniform(gen: torch.Generator, shape, bound: float, dtype, device) -> torch.Tensor:
    """U(-bound, bound) parameter drawn in fp32 from `gen`."""
    return ((torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound).to(dtype)


def linear_init(gen, in_dim: int, out_dim: int, dtype, device):
    """Kaiming-uniform fan_in {"w": [in, out], "b": [out]} (torch nn.Linear
    default, as the JAX heads use)."""
    bound = (1.0 / in_dim) ** 0.5
    return {
        "w": uniform(gen, (in_dim, out_dim), bound, dtype, device),
        "b": uniform(gen, (out_dim,), bound, dtype, device),
    }
