"""Tracing and phase timing (counterpart of `ullava_tpu/utils/profiling.py`).

- `trace(logdir)`: a context manager around `torch.profiler`: host and,
  with a card, CUDA activity; the Chrome trace is written to `logdir`.
- `phase_timer(name)`: wall-clock phase timing that waits for the card
  (`torch.cuda.synchronize`) before it stops the clock, so asynchronous
  launches are counted.

The JAX module's `start_server` (a live `jax.profiler` server to attach
to) has no counterpart: `torch.profiler` records in-process only.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str, python_tracer: bool = False):
    """Profile the block; `python_tracer` adds Python call stacks (many
    host events: off by default, the device timeline is what the traces
    are for). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities, with_stack=python_tracer) as prof:
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def phase_timer(name: str, device=None):
    """Times a phase into the yielded dict's "seconds"; on a CUDA `device`
    (or the current card when `device` is "cuda") the clock stops after a
    `torch.cuda.synchronize`."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        box["seconds"] = dt
        logger.info("[phase] %s: %.3fs", name, dt)
