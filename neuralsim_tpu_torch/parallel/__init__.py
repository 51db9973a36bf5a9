"""The mesh on ``torch.distributed`` (the names of
``neuralsim_tpu.parallel``): one process per rank, laid out as a ('data',
'model') mesh. ``distributed.initialize_distributed`` joins a process
group, ``launch.launch`` runs a function on N ranks of one host."""

from neuralsim_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_rays,
    shard_batch,
)

__all__ = ["make_mesh", "replicate", "shard_rays", "shard_batch"]
