"""Energy-dispersal XOR (torch port of :func:`dabjax.fec.prbs.disperse`).

The sequence itself is dabjax's :func:`dabjax.fec.prbs.prbs`."""

from __future__ import annotations

import functools

import torch

from dabjax.fec.prbs import prbs

__all__ = ["disperse"]


@functools.lru_cache(maxsize=None)
def _seq(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(prbs(n), device=device).to(dtype)


def disperse(bits: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """XOR integer 0/1 ``bits`` (..., n) with the PRBS. Self-inverse."""
    if n is None:
        n = bits.shape[-1]
    return torch.bitwise_xor(bits, _seq(n, bits.dtype, bits.device))
