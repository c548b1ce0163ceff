"""DAB convolutional code: K=7, rate 1/4 (ETSI EN 300 401 §11.1).

Generator polynomials in the reference receiver's register convention
(``viterbi.cpp:63``): the shift register holds the newest bit in the LSB
(``sr = (sr << 1) | bit``) and output ``k`` is ``parity(sr & POLYS[k])``.
These are the bit-reversed images of the ETSI octal generators
(0133, 0171, 0145, 0133); the code is identical on air.

The encoder lives here mainly for the modulator (golden-fixture synthesis)
and for Viterbi tests — the reference only carries a commented-out encoder
(``viterbi.cpp:202-220``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["POLYS", "K", "RATE", "encode", "expected_bits_table"]

POLYS = (0o155, 0o117, 0o123, 0o155)
K = 7           # constraint length
RATE = 4        # coded bits per data bit
NUM_STATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


def encode(bits: np.ndarray) -> np.ndarray:
    """Encode ``bits`` (0/1, shape (..., n)) -> (..., 4*(n+6)) coded bits.

    Appends the K-1 = 6 zero tail bits that drive the register back to
    state 0, as required by EN 300 401 §11.1.1.  Vectorized over leading axes.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    T = n + K - 1
    # Register value at step t holds bits t-6..t, newest in the LSB: a
    # sliding 7-bit window over [6 leading zeros | bits | 6 tail zeros].
    ext = np.concatenate([
        np.zeros(bits.shape[:-1] + (K - 1,), np.uint8),
        bits,
        np.zeros(bits.shape[:-1] + (K - 1,), np.uint8)], axis=-1)
    sw = np.lib.stride_tricks.sliding_window_view(ext, K, axis=-1)[..., :T, :]
    weights = (1 << np.arange(K - 1, -1, -1)).astype(np.uint32)
    win = (sw.astype(np.uint32) * weights).sum(axis=-1)      # (..., T)
    out = np.empty(bits.shape[:-1] + (T, RATE), np.uint8)
    for k, poly in enumerate(POLYS):
        out[..., k] = _parity(win & poly)
    return out.reshape(bits.shape[:-1] + (T * RATE,))


def expected_bits_table() -> np.ndarray:
    """(128, 4) expected coded bits for register value r=(state<<1)|input."""
    r = np.arange(128, dtype=np.uint32)[:, None]
    polys = np.array(POLYS, dtype=np.uint32)[None, :]
    return _parity(r & polys)
