"""Builds, binds and counts the hand-written Hopper kernels.

Each `csrc/*.cu` file compiles with `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with `ctypes`. Builds happen at first use, all sources at once
(one `nvcc` process each), into `kernels/build/`, keyed by a hash of the
sources and flags so a stale library is never loaded.

`launch(name, *args)` is the one place a kernel is launched: it calls the
C entry on the current stream, raises on a non-zero `cudaGetLastError`,
and only then adds one to that kernel's launch count.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass
class KernelSpec:
    name: str
    source: str  # file under csrc/
    symbol: str  # exported C entry point
    argtypes: Tuple
    replaces: str  # the TPU kernel, file:line of its definition
    launches: int = 0


KERNELS: Dict[str, KernelSpec] = {
    spec.name: spec
    for spec in (
        KernelSpec(
            "fused_rotary", "rope.cu", "ullava_fused_rotary",
            (P, P, P, P, I, I, I, P), "ullava_tpu/ops/rope.py:95",
        ),
        KernelSpec(
            "flash_attention_fwd_bsh", "flash_attention.cu",
            "ullava_flash_attention_fwd_bsh",
            (P, P, P, P, P, I, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/attention.py:354",
        ),
        KernelSpec(
            "fused_window_attention_grid", "sam_window_attention.cu",
            "ullava_fused_window_attention_grid", (P, P, P, P, I, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:181",
        ),
        KernelSpec(
            "fused_global_attention", "sam_global_attention.cu",
            "ullava_fused_global_attention", (P, P, P, P, P, P, I, F, I, P),
            "ullava_tpu/ops/sam_attention.py:490",
        ),
        KernelSpec(
            "rms_norm_residual_quant", "rms_quant.cu", "ullava_rms_norm_residual_quant",
            (P, P, P, P, P, P, I, I, F, P), "ullava_tpu/ops/norms.py:139",
        ),
        KernelSpec(
            "silu_mul_quant", "silu_mul_quant.cu", "ullava_silu_mul_quant",
            (P, P, P, P, I, I, P), "ullava_tpu/ops/mlp_kernel.py:390",
        ),
        KernelSpec(
            "prefill_quantize_write", "kv_quant_write.cu", "ullava_prefill_quantize_write",
            (P, P, P, P, P, P, I, I, I, I, I, I, P),
            "ullava_tpu/ops/decode_attention.py:508",
        ),
        KernelSpec(
            "decode_attention_int8_fused_write", "decode_attention_int8.cu",
            "ullava_decode_attention_int8_fused_write",
            (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/decode_attention.py:345",
        ),
        KernelSpec(
            "rms_norm_fwd", "rms_quant.cu", "ullava_rms_norm_fwd",
            (P, P, P, I, I, F, P), "ullava_tpu/ops/norms.py:77",
        ),
        KernelSpec(
            "fused_ln_linear", "ln_linear_int8.cu", "ullava_fused_ln_linear_int8",
            (P, P, P, P, P, P, P, P, P, P, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:491",
        ),
        KernelSpec(
            "fused_global_attention_y", "sam_global_attention_y.cu",
            "ullava_fused_global_attention_y", (P, P, P, P, I, I, F, I, P),
            "ullava_tpu/ops/sam_attention.py:652",
        ),
        KernelSpec(
            "fused_mlp_block", "mlp_block_int8.cu", "ullava_fused_mlp_block_int8",
            (P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:157",
        ),
        KernelSpec(
            "fused_ln_linear_dual", "ln_linear_int8.cu", "ullava_fused_ln_linear_dual_int8",
            (P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:622",
        ),
        KernelSpec(
            "fused_window_attention_rect", "sam_rect_attention.cu",
            "ullava_fused_window_attention_rect",
            (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:354",
        ),
    )
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot build")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every source that has no current library, all in parallel.
    Returns {source: seconds} for the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = sorted({s.source for s in KERNELS.values() if not _lib_path(s.source).exists()})
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    times = {}
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        times[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        if verbose:
            print(f"[nvcc {src}] {times[src]:.1f}s\n{log.strip()}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def _function(spec: KernelSpec):
    lib = _LIBS.get(spec.source)
    if lib is None:
        path = _lib_path(spec.source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.ullava_error_string.argtypes = (I,)
        lib.ullava_error_string.restype = ctypes.c_char_p
        _LIBS[spec.source] = lib
    fn = getattr(lib, spec.symbol)
    fn.argtypes = spec.argtypes
    fn.restype = I
    return fn, lib


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream; raise if it was refused."""
    spec = KERNELS[name]
    fn, lib = _function(spec)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: {lib.ullava_error_string(err).decode()}"
        )
    spec.launches += 1


def reset_launch_counts() -> None:
    for spec in KERNELS.values():
        spec.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: spec.launches for name, spec in KERNELS.items()}


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel operand: device, dtype, contiguity, 16-byte alignment."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
