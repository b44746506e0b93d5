"""What every app's ``run`` shares: the placement of a run (its mode, the
service the scheduler modes submit to, the device), the row-sharded
tables over a process mesh, and the per-tenant blocks of a multi-tenant
batch (embedding bags, KV sequences).

Over a ``distributed.ProcessMesh`` (``mesh=`` or a service built on one)
each rank runs the app, SPMD: the app's state stays whole on every rank,
each table the engine reads or updates is submitted as the rank's slice
(``ShardedEngine.slice_of``), a gather resolves to its whole result, and
an update's slice is put back together whole (``whole``), so ``run``
returns on every rank what it returns on one device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.core.device import resolve_device
from repro_torch.serve.access_service import AccessService

MODES = ("eager", "sequential", "pipelined")


def placement(mode: str, service, mesh, device, **service_kw):
    """Check ``mode``; return the service the scheduler modes submit to
    (``service``, else a private one on ``device`` with ``service_kw``,
    over a ``ShardedEngine`` when ``mesh`` is given; None for the eager
    mode, which ignores ``mesh`` as the reference does) and the device the
    run's tensors live on (``device`` for the eager mode, else the service
    engine's)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "eager":
        return None, resolve_device(device)
    if service is None:
        service = AccessService(auto_flush=0, device=device, mesh=mesh,
                                **service_kw)
    return service, service.scheduler.engine.device


def _process_engine(service):
    eng = service.scheduler.engine
    return eng if getattr(eng, "process", False) else None


def whole(service, out: torch.Tensor, n_rows: int) -> torch.Tensor:
    """An update's result (a rank's slice over a process mesh) as the
    whole table, on every rank; ``out`` itself elsewhere."""
    eng = _process_engine(service)
    return out if eng is None else eng.whole(out, n_rows)


def by_tenant(tenants: Sequence[str]) -> Dict[str, List[int]]:
    """Item ids per tenant, tenants in first-seen order."""
    by: Dict[str, List[int]] = {}
    for i, tname in enumerate(tenants):
        by.setdefault(tname, []).append(i)
    return by


def collate(by: Dict[str, List[int]], per_tenant_out: Dict) -> torch.Tensor:
    """Reassemble per-tenant output blocks (rows in ``by`` order) into
    item order: one scatter through the concatenated item ids."""
    items = [i for members in by.values() for i in members]
    blocks = torch.cat([per_tenant_out[t] for t in by])
    out = torch.empty_like(blocks)
    out[torch.as_tensor(items, device=blocks.device)] = blocks
    return out
