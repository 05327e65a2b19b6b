"""Data parallelism over ``torch.distributed`` (port of pdgn_tpu/parallel):
one process per device, global batch-norm statistics, uneven shards."""

from pdgn_tpu_torch.parallel.distributed import (initialize_distributed,
                                                 local_batch_slice,
                                                 shard_rows)
from pdgn_tpu_torch.parallel.mesh import (Mesh, make_mesh, replicate,
                                          shard_batch)
from pdgn_tpu_torch.parallel.sync_bn import (DataAxis, all_reduce_sum,
                                             batch_norm,
                                             cross_replica_moments,
                                             per_replica_batch_norm,
                                             replica_local, set_group)

__all__ = [
    "DataAxis",
    "Mesh",
    "all_reduce_sum",
    "batch_norm",
    "cross_replica_moments",
    "initialize_distributed",
    "local_batch_slice",
    "make_mesh",
    "per_replica_batch_norm",
    "replica_local",
    "replicate",
    "set_group",
    "shard_batch",
    "shard_rows",
]
