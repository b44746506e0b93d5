"""AdamW with optionally-quantized moments.

The port of the JAX package's ``optim.adamw``:
  * moment quantization (``state_dtype="bfloat16"``): halves the
    optimizer state's memory;
  * the update math runs in f32 whatever the storage dtype;
  * the update is out of place, as the reference's: it returns new
    params and a new state and leaves its inputs as they were.

State is ``{"mu", "nu", "step"}``: two trees shaped like the params, and
``step``, a 0-d int32 tensor on the params' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def adamw_init(params, *, state_dtype="bfloat16"):
    dt = _dtype(state_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """Returns (new_params, new_state). ``lr`` is a float or a 0-d tensor
    (a schedule's value)."""
    step = state["step"] + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + eps)
                          + weight_decay * p32)
        return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    is_out = lambda x: isinstance(x, tuple) and len(x) == 3 and \
        isinstance(x[0], torch.Tensor)
    pick = lambda i: tree_map(lambda t: t[i], out, is_leaf=is_out)
    return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}
