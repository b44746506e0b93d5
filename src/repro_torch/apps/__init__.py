"""repro_torch.apps — end-to-end iterative applications on the access engine.

One app per Table-1 / serving domain (the counterparts of ``repro.apps``),
each runnable eager and pipelined on one device, each bit-exact against
a sequential NumPy oracle:

  spmv           SpMV power iteration       (scientific — NAS CG shape)
  bfs            level-synchronous BFS push  (graph — GAP BFS, range fuser)
  hashjoin       hash-join probe             (database — conditional ILD/IST)
  kv_serve       paged-attention KV decode   (LLM serving — page-table ILD,
                                             unique-writer appends, pool
                                             grown mid-flight)
  embedding_bag  embedding lookup/update     (recsys — duplicate-dest
                                             segment-combined RMW push)

Every app exposes ``make_problem``/``make_graph``, ``reference`` (the
oracle), ``run(..., mode=, service=, mesh=, device=)`` and a seeded
``demo``/``demo_reference`` pair. ``device=None`` means CUDA; ``mesh``
must be None until the sharded engine is ported (ROADMAP A11).
"""
from repro_torch.apps import bfs, embedding_bag, hashjoin, kv_serve, spmv

APPS = {"spmv": spmv, "bfs": bfs, "hashjoin": hashjoin,
        "kv_serve": kv_serve, "embedding_bag": embedding_bag}

__all__ = ["spmv", "bfs", "hashjoin", "kv_serve", "embedding_bag", "APPS"]
