"""The port's `utils/` (counterpart of `ullava_tpu/utils/`): `set_seed`
seeds Python's, numpy's and torch's RNGs and returns a seeded
`torch.Generator`; `phase_timer` times a phase on the CPU (no card to
wait for); `trace` writes a Chrome trace of the block; `datetime_print`
stamps its line."""

import json
import random
import re

import numpy as np
import torch

from ullava_tpu_torch.utils import datetime_print, phase_timer, set_seed, trace


def test_set_seed_reproduces_every_rng():
    draws = []
    for _ in range(2):
        g = set_seed(123)
        assert isinstance(g, torch.Generator) and g.device.type == "cpu"
        draws.append((random.random(), float(np.random.rand()), float(torch.rand(1)),
                      torch.randn(3, generator=g).tolist()))
    assert draws[0] == draws[1]
    assert set_seed(124).initial_seed() == 124


def test_phase_timer_on_the_cpu():
    with phase_timer("sleep") as box:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert box["seconds"] > 0
    with phase_timer("cpu", device="cpu") as box2:
        pass
    assert 0 <= box2["seconds"] < box["seconds"] + 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and prof is not None
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_datetime_print(capsys):
    datetime_print("hello")
    out = capsys.readouterr().out
    assert re.fullmatch(r"\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] hello\n", out)
