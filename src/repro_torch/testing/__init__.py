"""repro_torch.testing — helpers for holding the port against the JAX
package, and the seeded case generators the serving layer needs.

``pattern_from`` rebuilds a port ``Pattern`` from any object with the same
class names and fields (a ``repro.core.compiler.Pattern``, say), so tests
can feed the reference's conformance and fuzz patterns to the port without
the port importing the reference. ``generate_case`` and
``generate_traffic_case`` are the reference fuzzer's generators (the same
NumPy draws, the port's pattern classes); the oracle, conformance registry
and parity harness are still to port (ROADMAP A).
"""
from repro_torch.testing.fuzzer import (FuzzCase, generate_case,
                                        generate_traffic_case)
from repro_torch.testing.patterns import pattern_from

__all__ = ["pattern_from", "FuzzCase", "generate_case",
           "generate_traffic_case"]
