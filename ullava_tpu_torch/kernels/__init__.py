"""Builds, binds and counts the hand-written Hopper kernels.

Each `csrc/*.cu` file compiles with `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with `ctypes`. Builds happen at first use, all sources at once
(one `nvcc` process each), into `kernels/build/`, keyed by a hash of the
sources and flags so a stale library is never loaded.

`launch(name, *args)` is the one place a kernel is launched: it calls the
C entry on the current stream, raises on a non-zero `cudaGetLastError`,
and only then adds one to that kernel's launch count.

`mutant(source, define)` routes the launches of one source's kernels, for
the duration of a `with` block, to a copy compiled with `-D<define>`: a
deliberate bug written into the source under that name, which a kernel's
correctness gate must catch (`chip_smoke.py`). Those launches are not
counted. Nothing else builds or loads such a copy.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# -fno-gnu-unique: a static local of an inline or template function (the
# "attribute set" flag of a core's `configure`) is otherwise an STB_GNU_UNIQUE
# symbol, which the dynamic linker shares between every library that
# defines it, even with RTLD_LOCAL; a mutant copy of a source would then
# skip its own cudaFuncSetAttribute.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique",
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
            (P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
            "ullava_tpu/ops/decode_attention.py:345",
        ),
        KernelSpec(
            "rms_norm_fwd", "rms_quant.cu", "ullava_rms_norm_fwd",
            (P, P, P, I, I, F, I, P), "ullava_tpu/ops/norms.py:57",
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
        KernelSpec(
            "flash_attention_fwd_lse", "flash_fwd_sm90.cu", "ullava_flash_attention_fwd_lse",
            (P, P, P, P, P, P, I, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/attention.py:173",
        ),
        # The flash backward: its pre-pass (delta, which the JAX package
        # leaves to XLA, and the dq accumulator zeroed), the fused pass (dk,
        # dv and dq's parts into the accumulator) in K16's slot, the dq
        # finish in K17's.
        KernelSpec(
            "flash_attention_bwd_delta", "flash_attention_bwd.cu",
            "ullava_flash_attention_bwd_delta", (P, P, P, P, I, I, I, P),
            "ullava_tpu/ops/attention.py:590",
        ),
        KernelSpec(
            "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "ullava_flash_attention_bwd_dkv",
            (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/attention.py:473",
        ),
        KernelSpec(
            "flash_attention_bwd_dq", "flash_attention_bwd.cu", "ullava_flash_attention_bwd_dq",
            (P, P, I, P), "ullava_tpu/ops/attention.py:529",
        ),
        KernelSpec(
            "rms_norm_bwd", "rms_norm_bwd.cu", "ullava_rms_norm_bwd",
            (P, P, P, P, P, P, I, I, I, F, P), "ullava_tpu/ops/norms.py:85",
        ),
        # The weight-only (w8a8=False) forms of K10, K13 and K12.
        KernelSpec(
            "fused_ln_linear_wq", "ln_linear_wq.cu", "ullava_fused_ln_linear_wq",
            (P, P, P, P, P, P, P, P, P, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:491",
        ),
        KernelSpec(
            "fused_ln_linear_dual_wq", "ln_linear_wq.cu", "ullava_fused_ln_linear_dual_wq",
            (P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:622",
        ),
        KernelSpec(
            "fused_mlp_block_wq", "mlp_block_wq.cu", "ullava_fused_mlp_block_wq",
            (P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:157",
        ),
        # The int8 score forms (`dots_i8`) of K3, K11 and K14: int8 qk and
        # bias codes, bf16 P V (bound and design in each source's header);
        # K11's runs on the global core after a pre-pass that quantizes
        # each row once (`_rq_rows`). And K2 at head_dim 64 (CLIP).
        KernelSpec(
            "fused_window_attention_grid_i8", "sam_window_attention.cu",
            "ullava_fused_window_attention_grid_i8", (P, P, P, P, I, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:181",
        ),
        KernelSpec(
            "global_attention_y_quant_i8", "sam_global_attention_y.cu",
            "ullava_global_attention_y_quant_i8", (P, P, P, P, P, P, P, P, I, I, P),
            "ullava_tpu/ops/sam_attention.py:552",
        ),
        KernelSpec(
            "fused_global_attention_y_i8", "sam_global_attention_y.cu",
            "ullava_fused_global_attention_y_i8", (P, P, P, P, P, P, P, I, I, F, I, P),
            "ullava_tpu/ops/sam_attention.py:652",
        ),
        KernelSpec(
            "fused_window_attention_rect_i8", "sam_rect_attention.cu",
            "ullava_fused_window_attention_rect_i8",
            (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:354",
        ),
        KernelSpec(
            "flash_attention_fwd_bsh_hd64", "flash_attention.cu",
            "ullava_flash_attention_fwd_bsh_hd64",
            (P, P, P, P, P, I, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/attention.py:354",
        ),
        # The packed head-major layout (`pack_sam_attention`), and the two
        # kernels no path of either package calls: the per-(window, head)
        # window kernel and the decode attention that does not write.
        KernelSpec(
            "fused_window_attention_packed", "sam_packed_attention.cu",
            "ullava_fused_window_attention_packed", (P, P, P, P, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:826",
        ),
        KernelSpec(
            "fused_global_attention_packed", "sam_packed_attention.cu",
            "ullava_fused_global_attention_packed", (P, P, P, P, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:920",
        ),
        KernelSpec(
            "fused_window_attention", "sam_window_attention.cu",
            "ullava_fused_window_attention", (P, P, P, P, P, P, I, F, P),
            "ullava_tpu/ops/sam_attention.py:70",
        ),
        KernelSpec(
            "decode_attention_int8", "decode_attention_int8.cu", "ullava_decode_attention_int8",
            (P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
            "ullava_tpu/ops/decode_attention.py:143",
        ),
        # The hd 64 forms (ViT-L's and ViT-B's heads) of K3, K14 and K4 and
        # K11's, bf16 scores, on the cores of their hd 80 forms.
        KernelSpec(
            "fused_window_attention_grid_hd64", "sam_window_attention.cu",
            "ullava_fused_window_attention_grid_hd64", (P, P, P, P, I, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:181",
        ),
        KernelSpec(
            "fused_window_attention_rect_hd64", "sam_rect_attention.cu",
            "ullava_fused_window_attention_rect_hd64",
            (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P),
            "ullava_tpu/ops/sam_attention.py:354",
        ),
        KernelSpec(
            "fused_global_attention_hd64", "sam_global_attention.cu",
            "ullava_fused_global_attention_hd64", (P, P, P, P, P, P, I, F, I, P),
            "ullava_tpu/ops/sam_attention.py:490",
        ),
        KernelSpec(
            "fused_global_attention_y_hd64", "sam_global_attention_y.cu",
            "ullava_fused_global_attention_y_hd64", (P, P, P, P, I, I, F, I, P),
            "ullava_tpu/ops/sam_attention.py:652",
        ),
        # The chunk-pipelined W8A8 MLP, whose only caller is the MLP
        # microbenchmark (`microbench/mlp_variants.py`).
        KernelSpec(
            "fused_mlp_block_v2", "mlp_block_v2_int8.cu", "ullava_fused_mlp_block_v2_int8",
            (P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, P),
            "ullava_tpu/ops/mlp_kernel.py:314",
        ),
    )
}

_LIBS: Dict[str, ctypes.CDLL] = {}  # "source" or "source:define" -> library
_MUTANTS: Dict[str, str] = {}  # source -> define of the copy its launches go to


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot build")


def lib_path(source: str, define: Optional[str] = None) -> Path:
    """Where the library of `source` (built with `-D<define>`) is, built or not."""
    flags = NVCC_FLAGS + ((f"-D{define}",) if define else ())
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    stem = Path(source).stem + (f"-{define}" if define else "")
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False, mutants=()) -> Dict[str, float]:
    """Compile every source that has no current library, and each
    (source, define) copy in `mutants`, all in parallel. Returns
    {source or "source:define": seconds} for what this call compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    wanted = sorted({(s.source, None) for s in KERNELS.values()} | set(mutants),
                    key=lambda sd: (sd[0], sd[1] or ""))
    procs = []
    t0 = time.perf_counter()
    for src, define in wanted:
        out = lib_path(src, define)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *((f"-D{define}",) if define else ()),
               "-o", str(tmp), str(CSRC / src)]
        key = src if define is None else f"{src}:{define}"
        procs.append((key, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    times = {}
    failed = []
    for key, out, tmp, proc in procs:
        log, _ = proc.communicate()
        times[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{key}:\n{log}")
            continue
        if verbose:
            print(f"[nvcc {key}] {times[key]:.1f}s\n{log.strip()}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def _library(source: str, define: Optional[str]) -> ctypes.CDLL:
    key = source if define is None else f"{source}:{define}"
    lib = _LIBS.get(key)
    if lib is None:
        path = lib_path(source, define)
        if not path.exists():
            build_all(mutants=[(source, define)] if define else ())
        lib = ctypes.CDLL(str(path))
        lib.ullava_error_string.argtypes = (I,)
        lib.ullava_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return lib


def _function(spec: KernelSpec):
    lib = _library(spec.source, _MUTANTS.get(spec.source))
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
    if spec.source not in _MUTANTS:
        spec.launches += 1


def kernel_attrs(source: str, symbol: str, *form: int) -> Dict[str, int]:
    """Registers a thread, shared bytes a block, spilled (local) bytes a
    thread and blocks an SM of one kernel of `source`, read on the card by
    its C entry `symbol` (cudaFuncGetAttributes and the occupancy
    calculator); `form` selects the kernel among the source's."""
    lib = _library(source, None)
    fn = getattr(lib, symbol)
    fn.argtypes = (I,) * len(form) + (P,)
    fn.restype = I
    out = (ctypes.c_int * 4)()
    err = fn(*form, out)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}: {lib.ullava_error_string(err).decode()}")
    return dict(zip(("registers", "smem_bytes", "spill_bytes", "blocks_per_sm"), out))


def run_check(source: str, symbol: str, *ptrs: int) -> None:
    """Call the C entry `symbol` of `source` that takes device pointers and
    the stream and launches a check (no kernel of a path): not counted."""
    lib = _library(source, None)
    fn = getattr(lib, symbol)
    fn.argtypes = (P,) * (len(ptrs) + 1)
    fn.restype = I
    err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}: {lib.ullava_error_string(err).decode()}")


@contextlib.contextmanager
def mutant(source: str, define: str):
    """Within the block, launches of `source`'s kernels run the copy built
    with `-D<define>` (a deliberate bug) and are not counted."""
    if source in _MUTANTS:
        raise RuntimeError(f"{source} already runs the mutant {_MUTANTS[source]}")
    _MUTANTS[source] = define
    try:
        yield
    finally:
        del _MUTANTS[source]


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
