"""MSC time de-interleaver (torch port of :mod:`dabjax.msc.deinterleave`).

out[t, i] = in[t + 15 - DELAYS[i mod 16], i] over a block of consecutive
CIFs: 16 time slices of the [..., T, n/16, 16] view.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DELAYS", "HISTORY", "time_deinterleave"]

#: Receive-side delay per bit index mod 16 (dab-concurrent.cpp:41-43).
DELAYS = np.array([15, 7, 11, 3, 13, 5, 9, 1, 14, 6, 10, 2, 12, 4, 8, 0])
#: CIFs of history needed for a fully-primed de-interleave.
HISTORY = 15


def time_deinterleave(subch_soft: torch.Tensor) -> torch.Tensor:
    """``subch_soft`` [..., T, n_bits] (T > 15 consecutive CIFs) ->
    [..., T - 15, n_bits]; output t is logical frame t + 15's CIF."""
    T, n = subch_soft.shape[-2:]
    x = subch_soft.reshape(subch_soft.shape[:-1] + (n // 16, 16))
    cols = [x[..., HISTORY - int(DELAYS[j]): T - int(DELAYS[j]), :, j]
            for j in range(16)]
    out = torch.stack(cols, dim=-1)              # [..., T-15, n/16, 16]
    return out.reshape(subch_soft.shape[:-2] + (T - HISTORY, n))
