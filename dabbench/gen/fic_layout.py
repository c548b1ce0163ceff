"""FIC layout per transmission mode (copied from the port's
``fic/fic_decoder.py``, which imports torch kernels the transmitter does
not need)."""

from __future__ import annotations

from typing import Tuple

__all__ = ["fic_codewords_per_frame", "fic_profile"]


def fic_codewords_per_frame(p) -> int:
    """Mode I: 4 codewords per frame, Mode IV: 2, Modes II/III: 1."""
    return {1: 4, 2: 1, 3: 1, 4: 2}[p.mode]


def fic_profile(p) -> Tuple[list, int, int]:
    """(depuncture profile blocks, payload bits, FIBs per codeword)."""
    if p.mode == 3:
        return [29, 3], 1024, 4
    return [21, 3], 768, 3
