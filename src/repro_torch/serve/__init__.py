"""repro_torch.serve — the serving layer on top of the shared scheduler.

Public surface (the counterparts of ``repro.serve``'s):

  AccessService            async multi-tenant frontend (connect/submit/
                           flush, controllers, telemetry, ``explain()``)
  CoreClient               one tenant's handle (``AccessService.connect``)
  FlushController,         window-sizing policies: fixed threshold vs the
  FixedWindowController,   adaptive EOQ controller fed by measured arrival
  AdaptiveFlushController  rate, flush overhead and plan-IR coalescing gain
  plan_gain                the coalescing-gain extractor the controller uses
  VirtualClock             a clock its caller sets (replay, process meshes)
  Telemetry, TenantStats   per-tenant submit->redeem latency, histograms
  TrafficConfig, Trace,    open-loop workload generator + committed traces
  TrafficEvent,            (digests equal the reference's)
  generate_trace
  replay_trace,            virtual-time replay against a service
  ReplayResult
  KvPoolServer,            paged-KV decode-batch driver: shared prefixes,
  KvSequence               one flush window per batch, mid-flight growth
  PagedKVCache             in-model page pool (no scheduler)
  ServeLoop                continuous-batching-lite model host
"""
from repro_torch.serve.access_service import (AccessService,  # noqa: F401
                                              AdaptiveFlushController,
                                              CoreClient,
                                              FixedWindowController,
                                              FlushController, VirtualClock,
                                              plan_gain)
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: F401
from repro_torch.serve.kv_driver import KvPoolServer, KvSequence  # noqa: F401
from repro_torch.serve.serve import ServeLoop  # noqa: F401
from repro_torch.serve.telemetry import Telemetry, TenantStats  # noqa: F401
from repro_torch.serve.traffic import (ReplayResult, Trace,  # noqa: F401
                                       TrafficConfig, TrafficEvent,
                                       generate_trace, replay_trace)

__all__ = ["AccessService", "AdaptiveFlushController", "CoreClient",
           "FixedWindowController", "FlushController", "plan_gain",
           "VirtualClock",
           "PagedKVCache", "KvPoolServer", "KvSequence", "ServeLoop",
           "Telemetry", "TenantStats", "ReplayResult", "Trace",
           "TrafficConfig", "TrafficEvent", "generate_trace",
           "replay_trace"]
