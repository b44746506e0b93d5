"""repro_torch — DX100's Indirect Access path on PyTorch and CUDA (Hopper).

The counterpart of the JAX package ``repro``, module for module:
``repro_torch.core`` (ISA, engine, compiler, reorder, bulk ops, the
multi-tenant scheduler), ``repro_torch.plan`` and ``repro_torch.analysis``
(the AccessPlan IR and its checks), ``repro_torch.pipeline`` (the
decoupled access/execute loop), ``repro_torch.serve`` (the AccessService
front end, its flush controllers and telemetry), ``repro_torch.apps`` (the
five Table-1 apps) and ``repro_torch.kernels`` (hand-written CUDA kernels
with plain PyTorch versions). Entry points run on the CUDA device unless
given ``device="cpu"``.
"""
from repro_torch.core import (Access, BinOp, Compare, Engine, LegalityError,
                              Load, Pattern, RangeLoop, Var, bulk_gather,
                              bulk_rmw, bulk_scatter, compile_pattern,
                              run_tiled)

__all__ = [
    "Engine", "bulk_gather", "bulk_scatter", "bulk_rmw", "compile_pattern",
    "run_tiled", "Pattern", "Access", "Load", "BinOp", "Compare",
    "RangeLoop", "Var", "LegalityError",
]
