"""repro_torch.serve — the serving layer on top of the shared scheduler.

Ported so far (the counterparts of ``repro.serve``'s):

  AccessService            async multi-tenant frontend (connect/submit/
                           flush, controllers, telemetry, ``explain()``)
  CoreClient               one tenant's handle (``AccessService.connect``)
  FlushController,         window-sizing policies: fixed threshold vs the
  FixedWindowController,   adaptive EOQ controller fed by measured arrival
  AdaptiveFlushController  rate, flush overhead and plan-IR coalescing gain
  plan_gain                the coalescing-gain extractor the controller uses
  Telemetry, TenantStats   per-tenant submit->redeem latency, histograms

Still to port (ROADMAP A9/A12): the traffic generator and replay, the
paged-KV pool server, the in-model page pool and the serve loop.
"""
from repro_torch.serve.access_service import (AccessService,  # noqa: F401
                                              AdaptiveFlushController,
                                              CoreClient,
                                              FixedWindowController,
                                              FlushController, plan_gain)
from repro_torch.serve.telemetry import Telemetry, TenantStats  # noqa: F401

__all__ = ["AccessService", "AdaptiveFlushController", "CoreClient",
           "FixedWindowController", "FlushController", "plan_gain",
           "Telemetry", "TenantStats"]
