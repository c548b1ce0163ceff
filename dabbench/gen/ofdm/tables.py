"""OFDM reference tables: CAZAC phase reference and frequency interleaver.

Spec constants from ETSI EN 300 401 §14.3 (phase reference symbol) and
§14.6 (frequency interleaving).  Capability parity with the reference's
``phasetable.cpp:26-185`` and ``mapper.cpp:33-117``, expressed as
precomputed numpy arrays that feed XLA gathers.
"""

from __future__ import annotations

import functools

import numpy as np

from dabbench.gen.constants import DabParams

__all__ = ["phase_ref_carriers", "phase_ref_bins", "freq_interleave_map",
           "carrier_bins"]

# h_{i,j} tables, EN 300 401 table 48 (phasetable.cpp:146-156).  Each row is
# periodic with period 16 over j in 0..31.
_H = np.array([
    [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1],
    [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0],
    [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3],
    [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2],
], dtype=np.int64)

# (k_min, k_max, i, n) rows per mode, EN 300 401 tables 44-47
# (phasetable.cpp:26-121, incl. the 2014 fix for the {97,128} row).
_PHASE_TABLES = {
    1: [
        (-768, -737, 0, 1), (-736, -705, 1, 2), (-704, -673, 2, 0),
        (-672, -641, 3, 1), (-640, -609, 0, 3), (-608, -577, 1, 2),
        (-576, -545, 2, 2), (-544, -513, 3, 3), (-512, -481, 0, 2),
        (-480, -449, 1, 1), (-448, -417, 2, 2), (-416, -385, 3, 3),
        (-384, -353, 0, 1), (-352, -321, 1, 2), (-320, -289, 2, 3),
        (-288, -257, 3, 3), (-256, -225, 0, 2), (-224, -193, 1, 2),
        (-192, -161, 2, 2), (-160, -129, 3, 1), (-128, -97, 0, 1),
        (-96, -65, 1, 3), (-64, -33, 2, 1), (-32, -1, 3, 2),
        (1, 32, 0, 3), (33, 64, 3, 1), (65, 96, 2, 1), (97, 128, 1, 1),
        (129, 160, 0, 2), (161, 192, 3, 2), (193, 224, 2, 1),
        (225, 256, 1, 0), (257, 288, 0, 2), (289, 320, 3, 2),
        (321, 352, 2, 3), (353, 384, 1, 3), (385, 416, 0, 0),
        (417, 448, 3, 2), (449, 480, 2, 1), (481, 512, 1, 3),
        (513, 544, 0, 3), (545, 576, 3, 3), (577, 608, 2, 3),
        (609, 640, 1, 0), (641, 672, 0, 3), (673, 704, 3, 0),
        (705, 736, 2, 1), (737, 768, 1, 1),
    ],
    2: [
        (-192, -161, 0, 2), (-160, -129, 1, 3), (-128, -97, 2, 2),
        (-96, -65, 3, 2), (-64, -33, 0, 1), (-32, -1, 1, 2),
        (1, 32, 2, 0), (33, 64, 1, 2), (65, 96, 0, 2), (97, 128, 3, 1),
        (129, 160, 2, 0), (161, 192, 1, 3),
    ],
    # Mode III (EN 300 401 table 46).  The reference ships no Mode III
    # phase table (phasetable.cpp covers I/II/IV only) and no ETSI print
    # is available in this build environment, so these six rows are
    # recalled spec constants, verified round-trip (tx/modulator
    # <-> acquisition+demod, tests/test_modes_impairments.py) — an
    # off-air Mode III capture should confirm them before relying on
    # acquisition against real transmitters.
    3: [
        (-96, -65, 0, 2), (-64, -33, 1, 3), (-32, -1, 2, 0),
        (1, 32, 3, 2), (33, 64, 2, 2), (65, 96, 1, 3),
    ],
    4: [
        (-384, -353, 0, 0), (-352, -321, 1, 1), (-320, -289, 2, 1),
        (-288, -257, 3, 2), (-256, -225, 0, 2), (-224, -193, 1, 2),
        (-192, -161, 2, 0), (-160, -129, 3, 3), (-128, -97, 0, 3),
        (-96, -65, 1, 1), (-64, -33, 2, 3), (-32, -1, 3, 2),
        (1, 32, 0, 0), (33, 64, 3, 1), (65, 96, 2, 0), (97, 128, 1, 2),
        (129, 160, 0, 0), (161, 192, 3, 1), (193, 224, 2, 2),
        (225, 256, 1, 2), (257, 288, 0, 2), (289, 320, 3, 1),
        (321, 352, 2, 3), (353, 384, 1, 0),
    ],
}


def _phi(mode: int, k: int) -> float:
    """Phase phi_k of PRS carrier k (phasetable.cpp:172-185)."""
    for kmin, kmax, i, n in _PHASE_TABLES[mode]:
        if kmin <= k <= kmax:
            return np.pi / 2 * (_H[i][(k - kmin) % 16] + n)
    raise ValueError(f"carrier {k} out of range for mode {mode}")


@functools.lru_cache(maxsize=None)
def phase_ref_carriers(mode: int, K: int) -> np.ndarray:
    """PRS values for carriers k = -K/2..K/2 excluding 0, as (K,) complex64.

    Order: k = -K/2, .., -1, +1, .., +K/2.
    """
    ks = [k for k in range(-K // 2, K // 2 + 1) if k != 0]
    return np.exp(1j * np.array([_phi(mode, k) for k in ks])).astype(
        np.complex64)


@functools.lru_cache(maxsize=None)
def phase_ref_bins(mode: int, T_u: int, K: int) -> np.ndarray:
    """PRS as a (T_u,) FFT-bin vector (positive k -> bin k, negative ->
    bin T_u+k), zeros elsewhere — the layout of ``phasereference.cpp:41-48``.
    """
    table = np.zeros(T_u, dtype=np.complex64)
    carriers = phase_ref_carriers(mode, K)
    ks = np.array([k for k in range(-K // 2, K // 2 + 1) if k != 0])
    bins = np.where(ks < 0, T_u + ks, ks)
    table[bins] = carriers
    return table


_MAPPER_PARAMS = {1: (511, 256), 2: (127, 64), 3: (63, 32), 4: (255, 128)}


@functools.lru_cache(maxsize=None)
def freq_interleave_map(mode: int, T_u: int, K: int) -> np.ndarray:
    """Frequency-interleaver permutation: soft-bit pair index -> carrier k.

    Returns (K,) int32 of carrier indices in -K/2..K/2 (0 excluded):
    the DQPSK pair carrying soft bits (i, K+i) rides carrier ``map[i]``
    (EN 300 401 §14.6; mapper.cpp:33-117).
    """
    v1, lwb = _MAPPER_PARAMS[mode]
    upb = lwb + K
    tmp = np.zeros(T_u, dtype=np.int64)
    for i in range(1, T_u):
        tmp[i] = (13 * tmp[i - 1] + v1) % T_u
    sel = tmp[(tmp != T_u // 2) & (tmp >= lwb) & (tmp <= upb)]
    out = (sel - T_u // 2).astype(np.int32)
    assert out.shape[0] == K
    return out


@functools.lru_cache(maxsize=None)
def carrier_bins(mode: int, T_u: int, K: int) -> np.ndarray:
    """(K,) int32 FFT-bin index for soft-bit pair i (negative k wrapped)."""
    m = freq_interleave_map(mode, T_u, K)
    return np.where(m < 0, T_u + m, m).astype(np.int32)


def params_tables(p: DabParams):
    """Convenience bundle for a mode: (prs_bins, carrier_bins)."""
    return (phase_ref_bins(p.mode, p.T_u, p.K),
            carrier_bins(p.mode, p.T_u, p.K))
