"""Depuncturing straight from a protection profile (torch).

Port of :func:`dabjax.fec.puncture.depuncture_profile`.  The profiles and
keep-masks are dabjax's own (:func:`dabjax.fec.puncture.puncture_mask`);
the depuncture is one precomputed index gather over the transmitted soft
bits with an appended zero slot that every punctured position reads
("do not know").  Exact for any input values.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from dabjax.fec.puncture import puncture_mask

__all__ = ["depuncture_profile"]


@functools.lru_cache(maxsize=None)
def _gather_index(lengths: tuple, pis: tuple, device: torch.device):
    """((n_full,) int64 index into ``[soft[:n_tx], 0]``, n_tx)."""
    mask = puncture_mask(lengths, pis)
    n_tx = int(mask.sum())
    idx = np.full(mask.shape[0], n_tx, np.int64)    # zero slot
    idx[mask] = np.arange(n_tx)
    return torch.as_tensor(idx, device=device), n_tx


def depuncture_profile(soft: torch.Tensor, lengths: Sequence[int],
                       pis: Sequence[int]) -> torch.Tensor:
    """``soft`` (..., >= n_tx) -> (..., 4*(nbits+6)) full-rate soft bits.

    Trailing entries beyond the profile's transmitted length (UEP
    padding) are ignored, as in dabjax."""
    idx, n_tx = _gather_index(tuple(lengths), tuple(pis), soft.device)
    zero = soft.new_zeros(soft.shape[:-1] + (1,))
    padded = torch.cat([soft[..., :n_tx], zero], dim=-1)
    return padded.index_select(-1, idx)
