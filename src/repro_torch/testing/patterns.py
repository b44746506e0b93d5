"""Duck-typed conversion of pattern IR objects into the port's classes."""
from __future__ import annotations

import dataclasses
import numbers

from repro_torch.core import compiler

_CLASSES = {cls.__name__: cls for cls in (
    compiler.Var, compiler.Load, compiler.BinOp, compiler.Compare,
    compiler.RangeLoop, compiler.Access, compiler.Pattern)}


def pattern_from(obj):
    """Rebuild ``obj`` — a Pattern or any node of the pattern IR — as the
    port's class of the same name, field by field. Scalars pass through
    (NumPy scalars become Python ones); sequences are rebuilt as tuples."""
    if obj is None or isinstance(obj, (str, bool)):
        return obj
    if isinstance(obj, numbers.Integral):
        return int(obj)
    if isinstance(obj, numbers.Real):
        return float(obj)
    if isinstance(obj, (list, tuple)):
        return tuple(pattern_from(x) for x in obj)
    cls = _CLASSES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"cannot convert {type(obj).__name__!r}: not a "
                        f"pattern IR class ({sorted(_CLASSES)})")
    return cls(**{f.name: pattern_from(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})
