"""COCO run-length-encoding codec, pycocotools' subset (counterpart of
`ullava_tpu/data/tools/rle.py`): compressed counts take the native host
library where it is loaded (`native.py`), else numpy.

- `decode`: compressed (LEB128-style char string) or uncompressed RLE ->
  binary mask (column-major runs, exactly COCO's layout);
- `encode`: binary mask -> compressed RLE;
- `fr_poly`: polygon(s) -> RLE via rasterization;
- `area`, `to_bbox`: RLE stats.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, Union[Sequence[int], bytes, str, Sequence[Sequence[int]]]]


def _counts_from_leb(s: bytes) -> List[int]:
    """COCO compressed counts: 6-bit varint with sign-extended deltas."""
    counts: List[int] = []
    i = 0
    prev2 = prev1 = 0  # counts[-2] reference for delta coding
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_to_leb(counts: Sequence[int]) -> bytes:
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x = int(x) - int(counts[i - 2])
        else:
            x = int(x)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            if c & 0x10:
                more = x != -1
            else:
                more = x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _norm_counts(rle: RLE) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, (bytes, bytearray)):
        return _counts_from_leb(bytes(counts))
    return [int(c) for c in counts]


def decode(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    """RLE(s) -> uint8 mask [H, W] or [H, W, N] (pycocotools layout).
    Compressed RLEs take the native C path when the library is built."""
    from ullava_tpu_torch.data.tools import native

    single = isinstance(rles, dict)
    rle_list = [rles] if single else list(rles)
    masks = []
    for r in rle_list:
        h, w = r["size"]
        counts_raw = r["counts"]
        if isinstance(counts_raw, str):
            counts_raw = counts_raw.encode()
        if isinstance(counts_raw, (bytes, bytearray)):
            m = native.rle_decode(bytes(counts_raw), h, w)
            if m is not None:
                masks.append(m)
                continue
        counts = _norm_counts(r)
        flat = np.zeros(h * w, np.uint8)
        pos = 0
        val = 0
        for c in counts:
            if val:
                flat[pos : pos + c] = 1
            pos += c
            val ^= 1
        masks.append(flat.reshape(w, h).T)  # column-major runs
    out = np.stack(masks, axis=-1)
    return out[..., 0] if single else out


def encode(mask: np.ndarray) -> RLE:
    """uint8 [H, W] mask -> compressed RLE."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    # run lengths, starting with a (possibly zero-length) run of zeros
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    if not flat.size:
        runs = [0]
    return {"size": [h, w], "counts": _counts_to_leb(runs)}


def _poly_counts(poly: Sequence[float], h: int, w: int) -> List[int]:
    """Exact port of pycocotools' polygon rasterizer (maskApi.c rleFrPoly).

    The algorithm: scale vertices by 5 and round to ints; walk every edge
    densely (one point per unit step of the dominant axis, the minor axis
    rounded); keep only the points where the upsampled x column changes
    and map them back to pixel space (a point survives iff it lands
    exactly on a pixel-column boundary); each surviving (x, y) toggles the
    mask from flat column-major index x*h+y onward (even-odd rule), so
    sorting the toggle indices and differencing yields the RLE counts.
    (pycocotools.mask.frPyObjects)."""
    scale = 5.0
    xy = np.asarray(poly, np.float64).reshape(-1, 2)
    k = xy.shape[0]
    # C: (int)(scale * v + .5) — truncation toward zero.
    x = np.trunc(scale * xy[:, 0] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            # C computes (ye-ys)/dx even when dx==0 (degenerate repeated
            # vertex -> 0/0); those points are dropped by the u-change
            # filter below, so a defined 0.0 slope is behavior-identical.
            s = (ye - ys) / dx if dx else 0.0
            t = np.arange(dx + 1, dtype=np.int64)
            if flip:
                t = dx - t
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            t = np.arange(dy + 1, dtype=np.int64)
            if flip:
                t = dy - t
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us) if us else np.zeros(0, np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)

    # Downsample: keep points where the upsampled column changes.
    toggles: List[int] = []
    if u.size > 1:
        changed = np.flatnonzero(u[1:] != u[:-1]) + 1  # j with u[j] != u[j-1]
        uj, ujm1 = u[changed], u[changed - 1]
        vj, vjm1 = v[changed], v[changed - 1]
        xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
        xd = (xd + 0.5) / scale - 0.5
        keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
        xd = xd[keep]
        yd = np.minimum(vj, vjm1)[keep].astype(np.float64)
        yd = (yd + 0.5) / scale - 0.5
        yd = np.ceil(np.clip(yd, 0, h))
        toggles = (xd.astype(np.int64) * h + yd.astype(np.int64)).tolist()

    # Toggle positions -> alternating run lengths (starts with a zeros run).
    a = np.sort(np.asarray(toggles + [h * w], dtype=np.int64))
    diffs = np.diff(np.concatenate([[0], a])).tolist()
    b = [int(diffs[0])]
    j = 1
    while j < len(diffs):
        if diffs[j] > 0:
            b.append(int(diffs[j]))
            j += 1
        else:  # zero-length run: merge the neighbors (parity unchanged)
            j += 1
            if j < len(diffs):
                b[-1] += int(diffs[j])
                j += 1
    return b


def fr_poly(polys: Sequence[Sequence[float]], h: int, w: int) -> List[RLE]:
    """Polygon(s) [x0,y0,x1,y1,...] -> per-polygon RLEs (frPyObjects).
    Uses the exact pycocotools integer rasterizer (see `_poly_counts`);
    the native C++ path, when built, implements the same algorithm."""
    from ullava_tpu_torch.data.tools import native

    out = []
    for poly in polys:
        counts = native.poly_counts(np.asarray(poly, np.float64), h, w)
        if counts is None:
            counts = _poly_counts(poly, h, w)
        out.append({"size": [h, w], "counts": _counts_to_leb(counts)})
    return out


def merge(rles: Sequence[RLE]) -> np.ndarray:
    """Union of multiple RLEs as a decoded mask (the reference's
    `np.sum(m, axis=2)` usage)."""
    m = decode(list(rles))
    return (m.sum(axis=-1) > 0).astype(np.uint8)


def area(rle: RLE) -> int:
    counts = _norm_counts(rle)
    return int(sum(counts[1::2]))


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE -> [x, y, w, h] (pycocotools toBbox semantics)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4, np.float64)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return np.asarray([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float64)
