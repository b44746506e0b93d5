"""What every app's ``run`` shares: the placement of a run (its mode, the
service the scheduler modes submit to, the device), and the per-tenant
blocks of a multi-tenant batch (embedding bags, KV sequences)."""
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
