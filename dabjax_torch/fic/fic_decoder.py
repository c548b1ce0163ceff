"""FIC channel decoder: OFDM soft bits -> CRC-gated FIB bits (torch).

Port of :mod:`dabjax.fic.fic_decoder`: depuncture (21 x PI_16 + 3 x PI_15
+ PI_X; Mode III 29 + 3), Viterbi, energy dispersal and the CRC16 gate,
batched over [frames, codewords].  FIG parsing stays on the host
(:class:`dabjax.fic.fib.EnsembleDB`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dabjax.constants import DabParams
from dabjax_torch.fec import prbs, puncture, viterbi
from dabjax_torch.fec.crc import check_crc16_bits

__all__ = ["fic_codewords_per_frame", "fic_profile", "decode_fic"]


def fic_codewords_per_frame(p: DabParams) -> int:
    """Mode I: 4 codewords per frame, Mode IV: 2, Modes II/III: 1."""
    return {1: 4, 2: 1, 3: 1, 4: 2}[p.mode]


def fic_profile(p: DabParams) -> Tuple[list, int, int]:
    """(depuncture profile blocks, payload bits, FIBs per codeword)."""
    if p.mode == 3:
        return [29, 3], 1024, 4
    return [21, 3], 768, 3


def decode_fic(fic_soft: torch.Tensor, p: DabParams
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fic_soft`` [F, fic_symbols, 2K] -> ``(fib_bits [F, n_fibs, 256]
    int32 after energy dispersal incl. CRC, crc_ok [F, n_fibs] bool)``."""
    F = fic_soft.shape[0]
    n_cw = fic_codewords_per_frame(p)
    blocks, nbits, fibs_per_cw = fic_profile(p)
    cw = fic_soft.reshape(F, n_cw, -1)
    full = puncture.depuncture_profile(cw, blocks, [16, 15])
    bits = prbs.disperse(viterbi.viterbi_decode(full, nbits))
    fibs = bits.reshape(F, n_cw * fibs_per_cw, 256)
    return fibs, check_crc16_bits(fibs, inverted=True)
