"""Fused SwiGLU gate + per-row int8 quantize of the W8A8 prefill MLP
(counterpart of `ullava_tpu/ops/mlp_kernel.py:381-433`; the SAM encoder's
fused MLP and LN+linear kernels of that module wait for the int8 SAM
path)."""

from __future__ import annotations

from typing import Tuple

import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.ops.norms import MAX_ROW_WIDTH


def silu_mul_quant_plain(gate: torch.Tensor, up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `silu_mul_quant`: `g * sigmoid(g) * u` in fp32,
    raw per-row abs-max floored at 1e-12, rows rounded half to even."""
    gf, uf = gate.float(), up.float()
    h = gf * torch.sigmoid(gf) * uf
    amax = h.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    return torch.round(h * (127.0 / amax)).to(torch.int8), amax


def silu_mul_quant(
    gate: torch.Tensor,  # [rows, F] compute dtype
    up: torch.Tensor,  # [rows, F]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 rows, [rows, 1] f32 abs-max) of silu(gate) * up in one pass:
    the gated [rows, F] intermediate never reaches device memory in fp32
    or bf16, only its int8 rows do. Pair with
    `quant.apply_linear_a8_prequant` for the down projection. CUDA kernel
    `kernels/csrc/silu_mul_quant.cu` (bf16) for CUDA tensors, the plain
    version for CPU tensors."""
    if gate.ndim != 2 or up.shape != gate.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and up {tuple(up.shape)} must be equal 2-D")
    if gate.device.type == "cpu":
        return silu_mul_quant_plain(gate, up)
    rows, F = gate.shape
    if F % 8 or F > MAX_ROW_WIDTH:
        raise ValueError(f"silu_mul_quant: width {F} must be a multiple of 8, at most {MAX_ROW_WIDTH}")
    kernels.check_cuda_tensor("silu_mul_quant gate", gate, torch.bfloat16)
    kernels.check_cuda_tensor("silu_mul_quant up", up, torch.bfloat16)
    q = torch.empty((rows, F), dtype=torch.int8, device=gate.device)
    amax = torch.empty((rows, 1), dtype=torch.float32, device=gate.device)
    kernels.launch(
        "silu_mul_quant", gate.data_ptr(), up.data_ptr(), q.data_ptr(), amax.data_ptr(), rows, F
    )
    return q, amax
