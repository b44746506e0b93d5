"""Static analysis of the port's flush windows and AccessPlan IR
(DESIGN.md §12), the counterparts of ``repro.analysis``'s:

  * ``analysis.hazards``  — order-dependence detection over one flush
    window's leaves, emitting the DX0xx diagnostic catalog;
    ``Scheduler(strict=True)`` raises ``HazardError`` on ERRORs.
  * ``analysis.verify``   — inter-pass structural invariants of the
    lowering pipeline, enabled by ``LowerContext(verify=True)``
    (``DX100_PLAN_VERIFY``).

The JAX package's interval analyzer of programs (``analysis.program``)
is not ported yet.
"""
from repro_torch.analysis.diagnostics import (  # noqa: F401
    CATALOG, ERROR, WARN, Diagnostic, HazardError, errors, warnings,
)
from repro_torch.analysis.hazards import scan_window  # noqa: F401
from repro_torch.analysis.verify import (  # noqa: F401
    VerificationError, check_pass,
)
