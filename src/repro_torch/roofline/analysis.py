"""Roofline terms of a step, counted by running it (no hardware needed).

  compute    = FLOPs      / (chips x 989e12 FLOP/s bf16, dense)
  memory     = bytes      / (chips x 3.35e12 B/s HBM3)
  collective = coll_bytes / (chips x 450e9 B/s NVLink, per direction)

The H100 SXM's figures, from NVIDIA's data sheet. The port of the JAX
package's ``roofline.analysis``, whose constants and counts are a TPU's
and XLA's: ``model_flops``, ``count_params``, ``active_param_fraction``
and ``roofline_terms`` keep its formulas; ``analyze_compiled`` (XLA's
``cost_analysis`` and HLO text) becomes ``analyze_step``, which runs a
function once and counts FLOPs with ``torch.utils.flop_counter``'s
``FlopCounterMode`` (matmuls, convolutions and attention; elementwise ops
count none) and bytes as the operand plus result bytes of every aten op
that is not a view. Run under ``FakeTensorMode`` (``launch.dryrun``) it
allocates nothing. The step runs on one device, so it moves no
collective bytes; ``roofline_terms`` takes them from a caller that has
them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.tree import tree_leaves

# NVIDIA H100 SXM (data sheet): dense bf16 tensor-core peak, HBM3, NVLink
HW = {
    "peak_flops_bf16": 989e12,     # per chip
    "hbm_bytes_per_s": 3.35e12,    # per chip
    "nvlink_bytes_per_s": 450e9,   # per chip, per direction
}


def model_flops(cfg, *, batch: int, seq: int, kind: str = "train",
                n_params: Optional[int] = None,
                n_active_params: Optional[int] = None) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed.
    Train counts fwd+bwd (6x); prefill/decode count fwd only (2x)."""
    n = n_active_params if n_active_params is not None else n_params
    tokens = batch * seq if kind != "decode" else batch * 1
    mult = 6 if kind == "train" else 2
    return float(mult) * float(n) * float(tokens)


@dataclasses.dataclass
class RooflineReport:
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_ratio: float

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   coll_bytes: Dict[str, int], chips: int,
                   model_flops_total: float = 0.0) -> RooflineReport:
    """All inputs are PER-CHIP except model_flops_total (whole step)."""
    compute_s = hlo_flops / HW["peak_flops_bf16"]
    memory_s = hlo_bytes / HW["hbm_bytes_per_s"]
    total_coll = float(sum(coll_bytes.values()))
    collective_s = total_coll / HW["nvlink_bytes_per_s"]
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)), key=lambda kv: kv[1])[0]
    per_chip_model = model_flops_total / max(chips, 1)
    useful = per_chip_model / hlo_flops if hlo_flops else 0.0
    return RooflineReport(
        flops=hlo_flops, bytes_accessed=hlo_bytes, coll_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dom, model_flops_total=model_flops_total,
        useful_ratio=useful)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Sum of operand and result bytes over the aten ops that run (views
    move no data and count none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.ops += 1
            self.bytes += _nbytes(list(args)) + _nbytes(kwargs or {}) \
                + _nbytes(out if isinstance(out, (list, tuple)) else [out])
        return out


def count_step(fn: Callable, *args, **kwargs):
    """Run ``fn`` once; returns (its result, FLOPs, bytes, aten ops)."""
    bytes_mode = _ByteCounter()
    flops_mode = FlopCounterMode(display=False)
    with flops_mode, bytes_mode:
        out = fn(*args, **kwargs)
    return out, float(flops_mode.get_total_flops()), \
        float(bytes_mode.bytes), bytes_mode.ops


def analyze_step(fn: Callable, *args, chips: int = 1,
                 model_flops_total: float = 0.0,
                 coll_bytes: Optional[Dict[str, int]] = None,
                 **kwargs) -> RooflineReport:
    """The roofline terms of one call ``fn(*args, **kwargs)``, counted as
    it runs (on one device: FLOPs and bytes are the per-chip counts)."""
    _, flops, nbytes, _ = count_step(fn, *args, **kwargs)
    return roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                          coll_bytes=dict(coll_bytes or {}), chips=chips,
                          model_flops_total=model_flops_total)


def count_params(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


def active_param_fraction(cfg) -> float:
    """MoE: fraction of expert params active per token (top_k/n_experts),
    non-expert params always active."""
    if cfg.n_experts == 0:
        return 1.0
    # expert share of per-layer params (approx): 3*D*F*E vs attn+router
    expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
    if cfg.family == "hybrid":
        # only layers at moe_period carry experts
        moe_layers = cfg.n_layers // cfg.moe_period
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * (
            moe_layers / cfg.n_layers)
    attn = 2 * cfg.d_model * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
    other = attn + cfg.d_model * cfg.n_experts
    dense_frac = other / (other + expert)
    active = dense_frac + (1 - dense_frac) * (cfg.top_k
                                              / max(cfg.n_experts, 1))
    return active
