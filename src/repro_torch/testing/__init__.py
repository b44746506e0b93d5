"""repro_torch.testing — helpers for holding the port against the JAX
package.

``pattern_from`` rebuilds a port ``Pattern`` from any object with the same
class names and fields (a ``repro.core.compiler.Pattern``, say), so tests
can feed the reference's conformance and fuzz patterns to the port without
the port importing the reference.
"""
from repro_torch.testing.patterns import pattern_from

__all__ = ["pattern_from"]
