"""LR schedules: cosine (default) and WSD (Warmup-Stable-Decay, the
minicpm-2b schedule from arXiv:2404.06395).

The port of the JAX package's ``optim.schedules``. A step is a Python int
or a 0-d tensor; the result is a 0-d f32 tensor on the step's device (the
CPU for an int), computed in the reference's order: with an int step the
Python-float parts are rounded to f32 where JAX rounds them, and the
cosine of a CPU step is the C library's ``cosf``, the routine XLA's CPU
backend calls (``torch.cos`` rounds about 5% of arguments the other way),
so a schedule on the CPU is the reference's bit for bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.restype, cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return cosf


def _cos(x: torch.Tensor) -> torch.Tensor:
    """cos of an f32 tensor: ``cosf`` per element of a plain CPU tensor,
    else ``torch.cos`` (a CUDA tensor, or a fake one in the dry run)."""
    if x.device.type != "cpu" or type(x) is not torch.Tensor:
        return torch.cos(x)
    cosf = _libm_cosf()
    return torch.tensor([cosf(v) for v in x.reshape(-1).tolist()],
                        dtype=torch.float32).reshape(x.shape)


def _step(step):
    """(step as f32 tensor or Python float, its device)."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32), step.device
    return float(step), torch.device("cpu")


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _where(cond, a, b, device) -> torch.Tensor:
    return torch.where(torch.as_tensor(cond, device=device), _f32(a, device),
                       _f32(b, device))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    step, dev = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    t = _f32((step - warmup) / max(total - warmup, 1), dev).clamp(0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + _cos(_f32(math.pi, dev) * t)))
    return _where(step < warmup, warm, cos, dev)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor: float = 0.0
                 ) -> torch.Tensor:
    """Warmup -> Stable (flat) -> Decay (last decay_frac of training)."""
    step, dev = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    decay_start = total * (1 - decay_frac)
    t = _f32((step - decay_start) / max(total - decay_start, 1),
             dev).clamp(0.0, 1.0)
    decay = peak_lr * (1 - (1 - floor) * t)
    return _where(step < warmup, warm,
                  _where(step < decay_start, peak_lr, decay, dev), dev)


def make_schedule(name: str, *, peak_lr: float = 3e-4, warmup: int = 100,
                  total: int = 10000):
    if name == "cosine":
        return lambda s: cosine_schedule(s, peak_lr=peak_lr, warmup=warmup,
                                         total=total)
    if name == "wsd":
        return lambda s: wsd_schedule(s, peak_lr=peak_lr, warmup=warmup,
                                      total=total)
    raise ValueError(f"unknown schedule {name!r}")
