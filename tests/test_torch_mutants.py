"""Every deliberate bug that `chip_smoke.py` builds into a copy of a kernel
source (its `*_MUTANT*` tables, each entry a (source, define) pair) exists:
the define guards code under `#ifdef` or `#if defined(...)` in that source
or in a header it includes. A mutant renamed or removed from the source
would otherwise compile to the correct kernel and make its gate look
stronger than it is. One case a mutant; no card needed."""

import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "ullava_tpu_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _mutants():
    """(source, define) of every mutant table of chip_smoke.py: the
    module-level names that hold MUTANT, each a (source, define) pair or a
    dict of them."""
    found = set()
    for name, value in vars(chip_smoke).items():
        if "MUTANT" not in name:
            continue
        for pair in value.values() if isinstance(value, dict) else [value]:
            found.add(tuple(pair))
    return sorted(found)


def _with_headers(source):
    """The source and every header it includes, transitively."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.append(name)
        todo += re.findall(r'#include "([^"]+)"', (CSRC / name).read_text())
    return seen


_ALL = _mutants()


def test_the_tables_are_read():
    assert len(_ALL) >= 18, _ALL


@pytest.mark.parametrize("source,define", _ALL, ids=[f"{s}:{d}" for s, d in _ALL])
def test_mutant_exists(source, define):
    guard = re.compile(rf"#\s*if(def\s+{define}\b|\s+defined\s*\(?\s*{define}\b)")
    files = _with_headers(source)
    assert any(guard.search((CSRC / f).read_text()) for f in files), (source, define, files)
