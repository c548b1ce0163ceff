"""DAB puncturing vectors and protection profiles (ETSI EN 300 401 §11).

Capability parity with the reference receiver's ``protTables.cpp:28-54``
(the 24 puncturing vectors), ``deconvolve.cpp:39-114`` (the UEP profile
table) and ``deconvolve.cpp:244-319`` (the EEP A/B profile arithmetic) —
re-derived from the standard, expressed as precomputed static masks
(numpy, dabjax's own tables).

Depuncture layout (matches the reference bit-for-bit):

* A protected logical frame is the concatenation of L1+L2(+L3+L4) blocks of
  128 positions; block group ``i`` uses puncturing vector ``PI_i`` cyclically
  over each group of 32 positions, followed by a 24-position tail punctured
  by ``PI_X`` (``deconvolve.cpp:117-120``).
* Punctured (=absent) positions decode as soft value 0 ("do not know").

On the device, :func:`depuncture_profile` (the port of dabjax's function
of that name) is one precomputed index gather over the transmitted soft
bits with an appended zero slot that every punctured position reads.
Exact for any input values.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "p_codes", "PI_X", "uep_profile", "eep_profile", "puncture_mask",
    "depuncture", "puncture", "UEP_PROFILES", "punctured_length",
    "depuncture_profile",
]

# Order in which '1's are added as PI increases: column q (position within a
# 4-bit group), groups visited in bit-reversed order.  Reproduces ETSI
# EN 300 401 table of PI vectors (and protTables.cpp:28-54) generatively.
_GROUP_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)


@functools.lru_cache(maxsize=None)
def p_codes(pi: int) -> np.ndarray:
    """Puncturing vector ``PI_pi`` (pi in 1..24) as a (32,) uint8 0/1 mask."""
    if not 1 <= pi <= 24:
        raise ValueError(f"PI index {pi} out of range 1..24")
    mask = np.zeros(32, dtype=np.uint8)
    # Sequence of (group, slot) positions; PI_p keeps the first 8+p.
    order = [(g, q) for q in range(4) for g in _GROUP_ORDER]
    for g, q in order[: 8 + pi]:
        mask[4 * g + q] = 1
    return mask


#: Tail puncturing vector: 24 positions, pattern 1,1,0,0 repeated
#: (deconvolve.cpp:117-120 / EN 300 401 §11.1.2).
PI_X = np.array([1, 1, 0, 0] * 6, dtype=np.uint8)


# UEP protection profiles for audio subchannels, EN 300 401 table 33
# (reference: deconvolve.cpp:39-114).  Keyed by (bitrate_kbps, protection
# level 1..5) -> (L1, L2, L3, L4, PI1, PI2, PI3, PI4).  PI4 == 0 means the
# profile has only three block groups.
UEP_PROFILES: Dict[Tuple[int, int], Tuple[int, ...]] = {
    (32, 5): (3, 4, 17, 0, 5, 3, 2, 0),
    (32, 4): (3, 3, 18, 0, 11, 6, 5, 0),
    (32, 3): (3, 4, 14, 3, 15, 9, 6, 8),
    (32, 2): (3, 4, 14, 3, 22, 13, 8, 13),
    (32, 1): (3, 5, 13, 3, 24, 17, 12, 17),
    (48, 5): (4, 3, 26, 3, 5, 4, 2, 3),
    (48, 4): (3, 4, 26, 3, 9, 6, 4, 6),
    (48, 3): (3, 4, 26, 3, 15, 10, 6, 9),
    (48, 2): (3, 4, 26, 3, 24, 14, 8, 15),
    (48, 1): (3, 5, 25, 3, 24, 18, 13, 18),
    # 56 kbit/s (levels 2..5; level 1 is not defined in EN 300 401): the
    # reference cannot DECODE these at all (deconvolve.cpp profileTable
    # has no 56 entry), but its copy of the Table 7 sub-channel index
    # (fib-processor.cpp:32-96, rows {29,5,56} {35,4,56} {42,3,56}
    # {52,2,56}) authoritatively fixes the CU sizes and the absence of
    # level 1 — both matched here.  The L/PI splits satisfy every
    # constraint Table 33 fixes (42 mother-bit blocks, punctured totals
    # = CU*64 with pads 0/0/0/8, the table's UEP ordering pattern; see
    # tests/test_fec.py::test_uep_table_structural_invariants, which
    # checks them independently of the modulator) and decode closed-loop
    # at every level.  No ETSI print of Table 33 itself is available in
    # this environment to confirm the splits digit-for-digit; an off-air
    # 56 kbit/s capture remains the final check.
    (56, 5): (6, 10, 23, 3, 5, 4, 2, 3),
    (56, 4): (6, 10, 23, 3, 9, 6, 4, 5),
    (56, 3): (6, 12, 21, 3, 16, 7, 6, 9),
    (56, 2): (6, 10, 23, 3, 23, 13, 8, 13),
    (64, 5): (6, 9, 31, 2, 5, 3, 2, 3),
    # NOTE: deconvolve.cpp:53 has PI3=6 here, which would consume 2820 soft
    # bits from a 2688-bit (42 CU) subchannel — a reference bug.  The
    # EN 300 401 value is PI3=5, which fits exactly (padding 0).
    (64, 4): (6, 9, 33, 0, 11, 6, 5, 0),
    (64, 3): (6, 12, 27, 3, 16, 8, 6, 9),
    (64, 2): (6, 10, 29, 3, 23, 13, 8, 13),
    (64, 1): (6, 11, 28, 3, 24, 18, 12, 18),
    (80, 5): (6, 10, 41, 3, 6, 3, 2, 3),
    (80, 4): (6, 10, 41, 3, 11, 6, 5, 6),
    (80, 3): (6, 11, 40, 3, 16, 8, 6, 7),
    (80, 2): (6, 10, 41, 3, 23, 13, 8, 13),
    (80, 1): (6, 10, 41, 3, 24, 17, 12, 18),
    (96, 5): (7, 9, 53, 3, 5, 4, 2, 4),
    (96, 4): (7, 10, 52, 3, 9, 6, 4, 6),
    (96, 3): (6, 12, 51, 3, 16, 9, 6, 10),
    (96, 2): (6, 10, 53, 3, 22, 12, 9, 12),
    (96, 1): (6, 13, 50, 3, 24, 18, 13, 19),
    (112, 5): (14, 17, 50, 3, 5, 4, 2, 5),
    (112, 4): (11, 21, 49, 3, 9, 6, 4, 8),
    (112, 3): (11, 23, 47, 3, 16, 8, 6, 9),
    (112, 2): (11, 21, 49, 3, 23, 12, 9, 14),
    (128, 5): (12, 19, 62, 3, 5, 3, 2, 4),
    (128, 4): (11, 21, 61, 3, 11, 6, 5, 7),
    (128, 3): (11, 22, 60, 3, 16, 9, 6, 10),
    (128, 2): (11, 21, 61, 3, 22, 12, 9, 14),
    (128, 1): (11, 20, 62, 3, 24, 17, 13, 19),
    (160, 5): (11, 19, 87, 3, 5, 4, 2, 4),
    (160, 4): (11, 23, 83, 3, 11, 6, 5, 9),
    (160, 3): (11, 24, 82, 3, 16, 8, 6, 11),
    (160, 2): (11, 21, 85, 3, 22, 11, 9, 13),
    (160, 1): (11, 22, 84, 3, 24, 18, 12, 19),
    (192, 5): (11, 20, 110, 3, 6, 4, 2, 5),
    (192, 4): (11, 22, 108, 3, 10, 6, 4, 9),
    (192, 3): (11, 24, 106, 3, 16, 10, 6, 11),
    (192, 2): (11, 20, 110, 3, 22, 13, 9, 13),
    (192, 1): (11, 21, 109, 3, 24, 20, 13, 24),
    (224, 5): (12, 22, 131, 3, 8, 6, 2, 6),
    (224, 4): (12, 26, 127, 3, 12, 8, 4, 11),
    (224, 3): (11, 20, 134, 3, 16, 10, 7, 9),
    (224, 2): (11, 22, 132, 3, 24, 16, 10, 15),
    (224, 1): (11, 24, 130, 3, 24, 20, 12, 20),
    (256, 5): (11, 24, 154, 3, 6, 5, 2, 5),
    (256, 4): (11, 24, 154, 3, 12, 9, 5, 10),
    (256, 3): (11, 27, 151, 3, 16, 10, 7, 10),
    (256, 2): (11, 22, 156, 3, 24, 14, 10, 13),
    (256, 1): (11, 26, 152, 3, 24, 19, 14, 18),
    (320, 5): (11, 26, 200, 3, 8, 5, 2, 6),
    (320, 4): (11, 25, 201, 3, 13, 9, 5, 10),
    (320, 2): (11, 26, 200, 3, 24, 17, 9, 17),
    (384, 5): (11, 27, 247, 3, 8, 6, 2, 7),
    (384, 3): (11, 24, 250, 3, 16, 9, 7, 10),
    (384, 1): (12, 28, 245, 3, 24, 20, 14, 23),
}


def uep_profile(bitrate: int, prot_level: int):
    """(Ls, PIs) for a UEP audio subchannel.

    Returns ``(lengths, pis)``: lists of 128-position block-group counts and
    the PI index used for each group (reference: deconvolve.cpp:142-166).
    """
    key = (bitrate, prot_level)
    if key not in UEP_PROFILES:
        raise ValueError(f"no UEP profile for bitrate={bitrate} P{prot_level}")
    l1, l2, l3, l4, p1, p2, p3, p4 = UEP_PROFILES[key]
    lengths = [l1, l2, l3]
    pis = [p1, p2, p3]
    if l4 > 0:
        lengths.append(l4)
        pis.append(p4)
    return lengths, pis


def eep_profile(bitrate: int, prot_level: int, profile: str = "A"):
    """(Ls, PIs) for an EEP subchannel.

    ``prot_level`` is 1..4; ``profile`` is "A" or "B"
    (EN 300 401 §11.3.2; reference deconvolve.cpp:244-319).
    """
    if profile == "A":
        n = bitrate // 8
        if prot_level == 1:
            lengths, pis = [6 * n - 3, 3], [24, 23]
        elif prot_level == 2:
            if bitrate == 8:
                lengths, pis = [5, 1], [13, 12]
            else:
                lengths, pis = [2 * n - 3, 4 * n + 3], [14, 13]
        elif prot_level == 3:
            lengths, pis = [6 * n - 3, 3], [8, 7]
        elif prot_level == 4:
            lengths, pis = [4 * n - 3, 2 * n + 3], [3, 2]
        else:
            raise ValueError(f"EEP-A protection level {prot_level}")
    elif profile == "B":
        n = bitrate // 32
        pi_map = {1: (10, 9), 2: (6, 5), 3: (4, 3), 4: (2, 1)}
        if prot_level not in pi_map:
            raise ValueError(f"EEP-B protection level {prot_level}")
        lengths, pis = [24 * n - 3, 3], list(pi_map[prot_level])
    else:
        raise ValueError(f"EEP profile {profile}")
    return lengths, list(pis)


@functools.lru_cache(maxsize=None)
def _mask_cached(lengths: Tuple[int, ...], pis: Tuple[int, ...]) -> np.ndarray:
    parts = [np.tile(np.tile(p_codes(pi), 4), ln)
             for ln, pi in zip(lengths, pis)]
    parts.append(PI_X)
    return np.concatenate(parts).astype(bool)


def puncture_mask(lengths, pis) -> np.ndarray:
    """Boolean keep-mask over the full-rate codeword (4*(nbits+6) long)."""
    return _mask_cached(tuple(lengths), tuple(pis))


def punctured_length(lengths, pis) -> int:
    """Number of transmitted soft bits for this profile."""
    return int(puncture_mask(lengths, pis).sum())


def depuncture(soft: np.ndarray, mask: np.ndarray):
    """Scatter punctured soft bits back to the full-rate codeword.

    ``soft``: (..., n_tx) soft values; ``mask``: (n_full,) bool keep-mask.
    Returns (..., n_full) with zeros ("do not know") at punctured positions.
    """
    n_full = mask.shape[0]
    idx = np.flatnonzero(mask)
    if soft.shape[-1] != idx.shape[0]:
        raise ValueError(
            f"soft length {soft.shape[-1]} != mask ones {idx.shape[0]}")
    out = np.zeros(soft.shape[:-1] + (n_full,), dtype=soft.dtype)
    out[..., idx] = soft
    return out


def puncture(full: np.ndarray, mask: np.ndarray):
    """Inverse of :func:`depuncture` — transmitter side (gather)."""
    idx = np.flatnonzero(mask)
    return full[..., idx]


# ------------------------------------------------------------ device


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
