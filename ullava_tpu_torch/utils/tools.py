"""Misc utilities (counterpart of `ullava_tpu/utils/tools.py`):
timestamped prints and global seeding for determinism."""

from __future__ import annotations

import datetime
import random

import numpy as np
import torch


def datetime_print(msg: str) -> None:
    print(f"[{datetime.datetime.now():%Y-%m-%d %H:%M:%S}] {msg}", flush=True)


def set_seed(seed: int = 42, device=None) -> torch.Generator:
    """Seed Python's, numpy's and torch's global RNGs (every card's too)
    and return a `torch.Generator` seeded `seed` on `device` (the CPU by
    default), for draws that take an explicit generator, as the JAX
    package returns a PRNGKey."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # seeds the CUDA generators as well
    return torch.Generator(device=device or "cpu").manual_seed(seed)
