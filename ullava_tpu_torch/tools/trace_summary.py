"""Summarize a `torch.profiler` trace: per-op self-time on the device
(counterpart of `tools/trace_summary.py`, which reads a JAX profile).

    python -m ullava_tpu_torch.tools.trace_summary <trace.json[.gz] or dir> [--by-shape] [-n 30]

Reads the Chrome trace that `torch.profiler.profile.export_chrome_trace`
(or `tensorboard_trace_handler`) writes, a `.json` or a `.json.gz`, or the
newest such file under a directory. It aggregates the device's tracks:
the events of categories `kernel`, `gpu_memcpy` and `gpu_memset`, one
track per (device, stream). Self-time subtracts the children nested in
an event of the same track, so an enclosing event is not counted twice;
events of different streams that overlap in time are not nested.
`--by-shape` keys on the name plus the launch's grid and block; `--cat`
names other categories to read (`cpu_op`: the host's op tracks, one a
thread). The text lines are the JAX tool's; a last line holds the same
numbers as one JSON object, for scripts.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = [p for pattern in ("*.json", "*.json.gz")
            for p in glob.glob(os.path.join(path, "**", pattern), recursive=True)]
    if not hits:
        raise SystemExit(f"no *.json or *.json.gz trace under {path}")
    return max(hits, key=os.path.getmtime)


def load_ops(fp: str, categories=DEVICE_CATEGORIES):
    """The complete events ("X") with a duration in `categories` (by
    default the device's) of the trace at `fp`."""
    opener = gzip.open if fp.endswith(".gz") else open
    with opener(fp, "rt") as f:
        data = json.load(f)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs
            if e.get("ph") == "X" and e.get("dur") and e.get("cat") in categories]


def self_times(ops, key_fn):
    """Interval-stack self-time over one track: an event's duration minus
    its nested children's. Returns ({key: us}, {key: count})."""
    ops = sorted(ops, key=lambda e: (e["ts"], -e["dur"]))
    stack, out, counts = [], collections.Counter(), collections.Counter()
    for e in ops:
        ts, dur = e["ts"], e["dur"]
        while stack and ts >= stack[-1][1]:
            stack.pop()
        key = key_fn(e)
        if stack:
            out[stack[-1][2]] -= dur
        out[key] += dur
        counts[key] += 1
        stack.append((ts, ts + dur, key))
    return out, counts


def _name(e) -> str:
    return re.sub(r"[\d.]+$", "", e["name"])


def _name_and_launch(e) -> str:
    a = e.get("args", {})
    return f"{_name(e)}: grid {a.get('grid')} block {a.get('block')}"[:200]


def summarize(path: str, by_shape: bool = False, n: int = 30,
              categories=DEVICE_CATEGORIES) -> dict:
    """{"trace", "total_ms", "ops": [[key, self ms, count], ...] (the top
    `n` by self-time)} of the events in `categories` of the trace at or
    under `path`."""
    fp = find_trace(path)
    ops = load_ops(fp, tuple(categories))
    if not ops:
        raise SystemExit(f"no {', '.join(categories)} events found (is this a device trace?)")
    key_fn = _name_and_launch if by_shape else _name
    tracks = collections.defaultdict(list)
    for e in ops:
        tracks[(e.get("pid"), e.get("tid"))].append(e)
    times, counts = collections.Counter(), collections.Counter()
    for track in tracks.values():
        t, c = self_times(track, key_fn)
        times.update(t)
        counts.update(c)
    return {"trace": fp, "total_ms": sum(times.values()) / 1000,
            "ops": [[key, us / 1000, counts[key]] for key, us in times.most_common(n)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--by-shape", action="store_true",
                    help="key on the name plus the launch's grid and block")
    ap.add_argument("-n", type=int, default=30)
    ap.add_argument("--cat", action="append", default=None,
                    help=f"event category to read (default: {', '.join(DEVICE_CATEGORIES)})")
    args = ap.parse_args(argv)

    res = summarize(args.path, args.by_shape, args.n, args.cat or DEVICE_CATEGORIES)
    print(f"trace: {res['trace']}")
    print(f"total device self-time: {res['total_ms']:.1f} ms")
    for key, ms, count in res["ops"]:
        print(f"{ms:9.2f} ms x{count:5d}  {key}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
