"""Static analysis of the port's programs, flush windows and AccessPlan IR
(DESIGN.md §12), the counterparts of ``repro.analysis``'s:

  * ``analysis.program``  — interval-domain abstract interpretation of
    ``AccessProgram``s: per-access index ranges, OOB/def-use/dead-write
    defects, affine/strided/indirect classification (a coalescing prior
    for the cost model);
  * ``analysis.hazards``  — order-dependence detection over one flush
    window's leaves, emitting the DX0xx diagnostic catalog;
    ``Scheduler(strict=True)`` raises ``HazardError`` on ERRORs.
  * ``analysis.verify``   — inter-pass structural invariants of the
    lowering pipeline, enabled by ``LowerContext(verify=True)``
    (``DX100_PLAN_VERIFY``).
"""
from repro_torch.analysis.diagnostics import (  # noqa: F401
    CATALOG, ERROR, WARN, Diagnostic, HazardError, errors, warnings,
)
from repro_torch.analysis.hazards import scan_window  # noqa: F401
from repro_torch.analysis.program import (  # noqa: F401
    AccessRecord, Interval, ProgramAnalysis, TileState, analyze_program,
    coalescing_prior,
)
from repro_torch.analysis.verify import (  # noqa: F401
    VerificationError, check_pass,
)
