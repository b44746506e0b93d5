"""Typed diagnostic catalog for the static-analysis subsystem (DX0xx).

Every defect the analyzer or the window hazard detector can report is a
``Diagnostic`` carrying a stable code from the catalog below, a severity,
and enough context (table, tenants, tickets, instruction position) to act
on it. Severity is a *contract*, not a judgement call:

  ERROR  the window/program is order-dependent or malformed — results
         depend on scheduling decisions the engine is free to make
         (§3.1 reorder freedom), so no oracle can pin them down.
         ``Scheduler(strict=True)`` refuses to execute these windows.
  WARN   defined behaviour, but either tolerance-only reproducible
         (reordered float reductions), snapshot-semantics dependent
         (reads and writes of one table in one window), or probably
         not what the author meant (dead writes, guaranteed-OOB).
         Strict mode executes these; they surface in
         ``FlushReport.diagnostics`` / ``explain()`` / telemetry.

The catalog (see DESIGN.md §12 for the paper-section mapping):

  DX001  ERROR  use of an undefined tile or register
  DX002  WARN   dead tile write (overwritten before any read)
  DX003  WARN   guaranteed out-of-bounds access (clamps/drops, §8 policy)
  DX010  ERROR  mixed RMW ops on one table within a flush window
  DX011  WARN   gather and RMW on one table within a flush window
  DX012  ERROR  duplicate writers: differently-shaped program launches
                write one caller array in one window
  DX013  WARN   program-written array also touched by another leaf
  DX020  WARN   floating-point ADD/MUL RMW (reordered reduction is
                tolerance-only reproducible)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ERROR = "ERROR"
WARN = "WARN"

#: code -> (severity, one-line summary). The summary is the catalog
#: entry; per-instance messages add the concrete table/tile/op context.
CATALOG = {
    "DX001": (ERROR, "use of an undefined tile or register"),
    "DX002": (WARN, "dead tile write: overwritten before any read"),
    "DX003": (WARN, "guaranteed out-of-bounds access "
                    "(loads clamp, stores drop)"),
    "DX010": (ERROR, "mixed RMW ops on one table in one flush window"),
    "DX011": (WARN, "gather and RMW on one table in one flush window "
                    "(gathers read the window-initial snapshot)"),
    "DX012": (ERROR, "duplicate writers: differently-shaped program "
                     "launches write one caller array in one window"),
    "DX013": (WARN, "program-written array also touched by another "
                    "leaf in the window"),
    "DX020": (WARN, "floating-point ADD/MUL RMW: reordered reduction "
                    "is tolerance-only reproducible"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One reported defect. Hashable and array-free by construction so a
    diagnostics tuple can ride on a long-lived (stripped) plan/report."""
    code: str
    severity: str
    message: str
    table: Optional[str] = None       # table/region label, if any
    tenants: Tuple[str, ...] = ()
    tids: Tuple[int, ...] = ()
    ip: Optional[int] = None          # instruction position, if any

    def render(self) -> str:
        loc = f" @ip{self.ip}" if self.ip is not None else ""
        who = f" tenants={','.join(self.tenants)}" if self.tenants else ""
        return f"{self.code} {self.severity}{loc}: {self.message}{who}"


def make(code: str, message: str, *, table=None, tenants=(), tids=(),
         ip=None) -> Diagnostic:
    """Build a Diagnostic with the catalog severity for ``code``."""
    severity, _ = CATALOG[code]
    return Diagnostic(code=code, severity=severity, message=message,
                      table=None if table is None else str(table),
                      tenants=tuple(tenants), tids=tuple(tids), ip=ip)


def errors(diags) -> tuple:
    return tuple(d for d in diags if d.severity == ERROR)


def warnings(diags) -> tuple:
    return tuple(d for d in diags if d.severity == WARN)


class HazardError(RuntimeError):
    """Raised by ``Scheduler(strict=True)`` when the pending window
    carries ERROR-severity diagnostics. The window is NOT consumed: the
    queues are left intact so the caller can ``explain()`` the offending
    plan, drop the offending submissions, or re-flush with
    ``strict=False``."""

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        super().__init__(
            "order-dependent flush window refused (strict hazard mode): "
            + "; ".join(d.render() for d in self.diagnostics))
