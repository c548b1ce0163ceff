"""Device helpers that every layer may use: naming one device one way, and
making a device current for the work issued on it."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve", "on_device"]


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit index for a bare
    ``"cuda"`` (the current card), so that ``"cuda"`` and ``"cuda:0"``
    compare equal when card 0 is current."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(device: torch.device):
    """Make ``device`` current for the kernels and allocations issued in
    the block (a no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
