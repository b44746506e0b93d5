"""Device resolution shared by the port's entry points.

Entry points (``Engine``, the bulk ops) run on the card unless the caller
names another device: ``device=None`` means ``"cuda"``, and a missing CUDA
device is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the resolved device is CUDA and no
    CUDA device is available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return device


def on(x, device: torch.device) -> torch.Tensor:
    """``x`` (tensor, NumPy array or sequence) as a tensor on ``device``;
    a no-op for a tensor already there."""
    return torch.as_tensor(x, device=device)


def synchronize(device: torch.device) -> None:
    """Wait for everything queued on ``device``'s current stream (a no-op
    on the CPU, where every op has already run)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
