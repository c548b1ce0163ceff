"""CIF assembly: demodulated soft bits -> Common Interleaved Frames (torch
port of :mod:`dabjax.msc.cif`)."""

from __future__ import annotations

import torch

from dabjax.constants import CIF_BITS, CU_BITS, DabParams

__all__ = ["cifs_from_soft", "slice_subchannel"]


def cifs_from_soft(soft: torch.Tensor, p: DabParams) -> torch.Tensor:
    """[F, L-1, 2K] frame soft bits -> [F * cifs_per_frame, 55296] CIFs
    (the FIC symbols are skipped)."""
    F = soft.shape[0]
    return soft[:, p.fic_symbols:, :].reshape(F * p.cifs_per_frame,
                                              CIF_BITS)


def slice_subchannel(cifs: torch.Tensor, start_addr: int, length_cus: int
                     ) -> torch.Tensor:
    """CU-range slice of a batch of CIFs (msc-handler.cpp:183-192)."""
    lo = start_addr * CU_BITS
    return cifs[..., lo: lo + length_cus * CU_BITS]
