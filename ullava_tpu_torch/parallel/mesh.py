"""Mesh construction over `torch.distributed` (counterpart of
`ullava_tpu/parallel/mesh.py`).

Axes:
- ``dp``   data parallel (parameters replicated; gradients all-reduce)
- ``fsdp`` fully-sharded data parallel (parameters and optimizer state
           sharded; each layer gathers its weights just before use, the
           ZeRO-3 scheme)
- ``tp``   tensor parallel (attention heads, MLP columns and the
           vocabulary of the LLaMA decoder)

Batches shard over (dp, fsdp); weights over (fsdp, tp). The mesh spans
the ranks of the default process group in rank order, tp innermost:
`init_distributed` joins that group from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or makes a group of this process
alone. NCCL carries the card's collectives, gloo the CPU's.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: Optional[int] = None  # None -> inferred from the world size
    fsdp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        if self.dp is not None:
            return self
        denom = self.fsdp * self.tp
        if n_devices % denom:
            raise ValueError(f"{n_devices} devices not divisible by fsdp*tp={denom}")
        return dataclasses.replace(self, dp=n_devices // denom)


AXIS_NAMES = ("dp", "fsdp", "tp")


def world_size() -> int:
    """Ranks of the default group, or of the group torchrun describes
    before it is joined (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def init_distributed(device_type: str = "cuda", timeout_s: float = 600.0) -> None:
    """Join the default process group once (a no-op when it exists):
    from torchrun's environment where it is set, else a group of this
    process alone over an in-memory store. NCCL for "cuda", gloo for
    "cpu"; on the card each rank takes the device of its LOCAL_RANK."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda") -> DeviceMesh:
    """The (dp, fsdp, tp) mesh over every rank of the default group (joined
    here if it is not yet). Raises ValueError, before joining, where the
    world size does not divide by fsdp * tp or does not equal dp * fsdp *
    tp."""
    n = world_size()
    cfg = cfg.resolve(n)
    if cfg.dp * cfg.fsdp * cfg.tp != n:
        raise ValueError(f"mesh {cfg.dp}x{cfg.fsdp}x{cfg.tp} != {n} devices")
    init_distributed(device_type)
    return init_device_mesh(device_type, (cfg.dp, cfg.fsdp, cfg.tp), mesh_dim_names=AXIS_NAMES)


def mesh_sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh, or a mapping of sizes as given (the
    partition rules need the shape only)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.get(a, 1)) for a in AXIS_NAMES}


def data_rank(mesh: DeviceMesh) -> tuple:
    """(this rank's index among the data shards, their count): the
    (dp, fsdp) coordinate flattened, dp outer."""
    fsdp = mesh.size(1)
    return mesh.get_local_rank("dp") * fsdp + mesh.get_local_rank("fsdp"), mesh.size(0) * fsdp
