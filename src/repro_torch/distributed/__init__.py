"""repro_torch.distributed — the sharded bulk-access engine (paper §6.6 at
mesh scale), the port of the JAX package's ``repro.distributed``:

  mesh          1-D meshes: ``Mesh``, logical shards on one device (one
                card holds every shard of any mesh size), and
                ``ProcessMesh``, one shard per rank of a torch.distributed
                group, each rank's table slice on its own device
  exchange      owner partitioning, pre-exchange dedup/combine and the
                index codecs, batched over a leading shard axis; the
                process mesh's collectives (``all_to_all``, ``all_gather``,
                and the train step's ``all_reduce``, ``reduce_scatter``)
  engine        ShardedEngine — a drop-in Engine whose bulk gather /
                scatter-RMW streams span the mesh, owner-local work on the
                row-table kernels; ``gather_blocks`` reassembles a process
                mesh's per-rank results; registers the "sharded" plan
                backend

Quick check on the CPU:

    from repro_torch.testing import harness
    harness.check_sharded_parity(device="cpu")   # gather+RMW vs NumPy

On a process mesh (one process per rank, e.g. ``torchrun
--nproc-per-node=N``), after ``torch.distributed.init_process_group``:

    mesh = process_mesh()                 # device: cuda:{LOCAL_RANK}
    eng = ShardedEngine(mesh, use_kernel=True)
    lo, hi = eng.rank_rows(len(A))
    block = eng.sharded_gather(A[lo:hi], idx, n_rows=len(A))
    whole = gather_blocks(block, mesh)    # == A[idx] on every rank
"""
from repro_torch.distributed.engine import (ExchangeInflight, ShardedEngine,
                                            ShardStats, gather_blocks)
from repro_torch.distributed.exchange import (CODECS, Exchange, all_gather,
                                              all_reduce, all_to_all,
                                              bucket_capacity,
                                              combine_duplicates,
                                              dedup_stream,
                                              masked_unique_count,
                                              partition_by_owner,
                                              reduce_scatter)
from repro_torch.distributed.mesh import (Mesh, ProcessMesh, as_mesh,
                                          device_mesh, process_mesh,
                                          shard_row_ranges)

__all__ = [
    "ShardedEngine", "ShardStats", "ExchangeInflight", "Mesh",
    "device_mesh", "as_mesh", "shard_row_ranges", "partition_by_owner",
    "masked_unique_count", "dedup_stream", "combine_duplicates", "CODECS",
    "bucket_capacity", "ProcessMesh", "process_mesh", "gather_blocks",
    "all_to_all", "all_gather", "all_reduce", "reduce_scatter",
    "Exchange",
]
