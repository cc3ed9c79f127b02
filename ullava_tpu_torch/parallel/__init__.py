"""Device-mesh parallelism over `torch.distributed` (counterpart of
`ullava_tpu/parallel/`): the (dp, fsdp, tp) mesh, parameter placements
by path rules, `DTensor` parameters and batches, and the collectives of
the sharded paths.

Data parallelism is a mesh axis; ZeRO-3-style parameter and optimizer
sharding is the `fsdp` axis (each layer gathers its weights just before
use); tensor parallelism is the `tp` axis, explicit in the LLaMA decoder
(heads, MLP columns and vocabulary). The JAX package gets all three from
`jax.sharding` and XLA's partitioner; here the model code takes each
weight's local tensor (`sharding.local_weight`, `sharding.whole`), so a
kernel never sees a DTensor.
"""

from ullava_tpu_torch.parallel.mesh import MeshConfig, init_distributed, make_mesh  # noqa: F401
from ullava_tpu_torch.parallel.sharding import (  # noqa: F401
    param_partition_specs,
    shard_batch,
    shard_params,
)
