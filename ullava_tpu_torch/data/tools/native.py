"""ctypes bindings to the native host-ops library (counterpart of
`ullava_tpu/data/tools/native.py`).

The library is compiled from `native/ullava_native.cpp` (COCO RLE decode
and encode, the polygon rasterizer, the nearest mask resize, SAM's
normalize + pad) with `g++` into `ullava_tpu_torch/kernels/build/` under
a name keyed by a hash of the source and flags (nothing is written into
`native/`). Each function returns None where the library is not loaded,
and its caller then runs the plain numpy version, as in the JAX package.
That happens only where `g++` is absent, which is logged; a failed build
logs the compiler's message and raises. `available()` says whether the library is loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE.parents[2] / "native" / "ullava_native.cpp",)
BUILD_DIR = _HERE.parents[1] / "kernels" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "rle_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]),
    "rle_encode": (ctypes.c_int, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
    "resize_nearest_u8": (None, [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int,
                                 ctypes.c_int]),
    "sam_normalize_pad": (None, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _f32p,
                                 _f32p]),
    "poly_counts": (ctypes.c_int, [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_int]),
}


def lib_path() -> Path:
    """Where the library of the current sources is, built or not."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libullava_native-{h.hexdigest()[:12]}.so"


def build() -> Optional[Path]:
    """Compile the library if no current one exists. None where `g++` is
    absent; RuntimeError, after logging the compiler's message, where the
    build fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        logger.warning("g++ not found: the native host library is not built; "
                       "the data layer runs its numpy paths")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        logger.error("native host library build failed:\n%s", proc.stdout + proc.stderr)
        raise RuntimeError(f"native host library build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # concurrent builders each write their own file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        path = build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
            logger.info("native host library loaded from %s", path)
        _tried = True
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, kind=_u8p):
    return a.ctypes.data_as(kind)


def rle_decode(counts: bytes, h: int, w: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w), np.uint8)
    rc = lib.rle_decode(counts, len(counts), h, w, _ptr(out))
    return out if rc == 0 else None


def rle_encode(mask: np.ndarray) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    buf = ctypes.create_string_buffer(max(h * w * 2, 64))
    n = lib.rle_encode(_ptr(mask), h, w, buf, len(buf))
    return buf.raw[:n] if n >= 0 else None


def resize_nearest(mask: np.ndarray, oh: int, ow: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.uint8)
    ih, iw = mask.shape
    out = np.empty((oh, ow), np.uint8)
    lib.resize_nearest_u8(_ptr(mask), ih, iw, _ptr(out), oh, ow)
    return out


def poly_counts(xy: np.ndarray, h: int, w: int) -> Optional[list]:
    """Polygon -> RLE counts by the native pycocotools rasterizer; None
    where the library is not loaded (the numpy rasterizer applies)."""
    lib = _load()
    if lib is None:
        return None
    xy = np.ascontiguousarray(np.asarray(xy, np.float64).reshape(-1))
    n_pts = xy.size // 2
    if n_pts < 1:
        return None
    # Upper bound on runs: one per dense boundary point + sentinel.
    pts = xy.reshape(-1, 2)
    per = np.abs(np.diff(np.vstack([pts, pts[:1]]), axis=0)).sum()
    max_out = int(5 * per) + 2 * n_pts + 16
    out = np.empty(max_out, np.int64)
    n = lib.poly_counts(_ptr(xy, ctypes.POINTER(ctypes.c_double)), n_pts, h, w,
                        _ptr(out, ctypes.POINTER(ctypes.c_int64)), max_out)
    return out[:n].tolist() if n >= 0 else None


def sam_normalize_pad(image: np.ndarray, size: int, mean: np.ndarray,
                      std: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.sam_normalize_pad(_ptr(image), h, w, size, _ptr(mean, _f32p), _ptr(std, _f32p),
                          _ptr(out, _f32p))
    return out

