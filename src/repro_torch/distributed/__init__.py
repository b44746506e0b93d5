"""repro_torch.distributed — the sharded bulk-access engine (paper §6.6 at
mesh scale), the port of the JAX package's ``repro.distributed``:

  mesh          a 1-D mesh of *logical* shards over torch devices (one
                card holds every shard of any mesh size)
  exchange      owner partitioning, pre-exchange dedup/combine and the
                index codecs, batched over a leading shard axis
  engine        ShardedEngine — a drop-in Engine whose bulk gather /
                scatter-RMW streams span the mesh, owner-local work on the
                row-table kernels; registers the "sharded" plan backend

Quick check on the CPU:

    from repro_torch.testing import harness
    harness.check_sharded_parity(device="cpu")   # gather+RMW vs NumPy
"""
from repro_torch.distributed.engine import (ExchangeInflight, ShardedEngine,
                                            ShardStats)
from repro_torch.distributed.exchange import (CODECS, bucket_capacity,
                                              combine_duplicates,
                                              dedup_stream,
                                              masked_unique_count,
                                              partition_by_owner)
from repro_torch.distributed.mesh import (Mesh, as_mesh, device_mesh,
                                          shard_row_ranges)

__all__ = [
    "ShardedEngine", "ShardStats", "ExchangeInflight", "Mesh",
    "device_mesh", "as_mesh", "shard_row_ranges", "partition_by_owner",
    "masked_unique_count", "dedup_stream", "combine_duplicates", "CODECS",
    "bucket_capacity",
]
