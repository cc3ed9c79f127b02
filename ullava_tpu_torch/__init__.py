"""PyTorch + CUDA port of u-LLaVA serving for NVIDIA Hopper.

Mirrors the layout of the JAX package (`ops/`, `models/`, `models/sam/`)
module for module. Parameters keep the JAX layouts (linear weights
`[in, out]`, NHWC images); stacked `[L, ...]` layer leaves become Python
lists of per-layer dicts. Every Pallas kernel on the ported path has a
hand-written CUDA counterpart under `kernels/csrc/`; each wrapper runs its
plain PyTorch version only for CPU tensors.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev
