"""repro_torch.pipeline — decoupled access/execute drivers (DESIGN.md §7).

  DecoupledLoop    double-buffered access/execute pipeline over a
                   Scheduler or AccessService (flush-window lookahead)
  AccessWindow     one dispatched access phase (non-blocking redeem)
  run_sequential   strictly-coupled baseline (barrier after every phase)
"""
from repro_torch.pipeline.decoupled import (AccessWindow, DecoupledLoop,
                                      run_sequential)

__all__ = ["AccessWindow", "DecoupledLoop", "run_sequential"]
