"""Reed-Solomon codes over GF(2^8), gfpoly 0x11D, fcr 0, prim 1.

Two DAB instantiations share this codec:

* **RS(120,110)** (default) — DAB+ superframe protection, matching the
  reference's Karn-derived decoder (``mp4processor.cpp:71-74``: symsize 8,
  gfpoly 0o435, nroots 10, shortened by 135 from RS(255,245); decode
  semantics of ``rs-decoder.cpp:28-413``).
* **RS(204,188)** — MSC packet-mode FEC (EN 300 401 §5.3.5, FIG 0/14
  fec_scheme 1), the code implemented by the reference's built-but-unwired
  ``rscodec``/``reedSolomon`` classes (``src/backend/audio/rscodec.cpp``,
  ``src/backend/reed-solomon.cpp``); pass ``n=204, k=188``.

* ``rs_encode``       — systematic encoder (modulator / golden fixtures).
* ``rs_decode_np``    — scalar decoder: syndromes, Berlekamp-Massey, Chien,
                        Forney.
* ``rs_decode_batch`` — receiver fast path: all syndromes as one vectorized
                        GF multiply-accumulate; zero-syndrome codewords (the
                        overwhelmingly common case) short-circuit, the rest
                        take the scalar path.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

__all__ = ["rs_encode", "rs_decode_np", "rs_decode_batch"]

_GFPOLY = 0o435
_NROOTS = 10
_N = 120            # shortened codeword length
_K = 110


@functools.lru_cache(maxsize=None)
def _gf_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(log, alog) tables for GF(256), alpha = 0x02, poly 0o435."""
    alog = np.zeros(510, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        alog[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _GFPOLY
    alog[255:510] = alog[:255]
    return log, alog


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    log, alog = _gf_tables()
    return int(alog[log[a] + log[b]])


def _div(a: int, b: int) -> int:
    assert b != 0
    if a == 0:
        return 0
    log, alog = _gf_tables()
    return int(alog[(log[a] - log[b]) % 255])


def _pow_alpha(e: int) -> int:
    _, alog = _gf_tables()
    return int(alog[e % 255])


def _poly_eval(poly: List[int], x: int) -> int:
    """Evaluate sum_k poly[k] x^k."""
    acc = 0
    xp = 1
    for c in poly:
        if c:
            acc ^= _mul(c, xp)
        xp = _mul(xp, x) if xp else 0
        if x == 0:
            xp = 0
    return acc


@functools.lru_cache(maxsize=None)
def _genpoly(nroots: int = _NROOTS) -> Tuple[int, ...]:
    """Generator polynomial prod_{i<nroots} (x + alpha^i), low-order first."""
    g = [1]
    for i in range(nroots):
        root = _pow_alpha(i)
        ng = [0] * (len(g) + 1)
        for k, c in enumerate(g):
            ng[k] ^= _mul(c, root)
            ng[k + 1] ^= c
        g = ng
    return tuple(g)   # degree nroots; g[nroots] == 1


def rs_encode(data: np.ndarray, n: int = _N, k: int = _K) -> np.ndarray:
    """Systematic encode (..., k) data bytes -> (..., n) codewords."""
    nroots = n - k
    data = np.asarray(data, np.uint8)
    lead = data.shape[:-1]
    flat = data.reshape(-1, k)
    g = np.array(_genpoly(nroots)[:nroots][::-1], np.int32)  # high..low
    out = np.zeros((flat.shape[0], n), np.uint8)
    out[:, :k] = flat
    log, alog = _gf_tables()
    for r in range(flat.shape[0]):
        rem = [0] * nroots   # rem[0] = highest order
        for i in range(k):
            fb = rem[0] ^ int(flat[r, i])
            rem = rem[1:] + [0]
            if fb:
                lf = log[fb]
                for kk in range(nroots):
                    if g[kk]:
                        rem[kk] ^= int(alog[lf + log[g[kk]]])
        out[r, k:] = rem
    return out.reshape(lead + (n,))


@functools.lru_cache(maxsize=None)
def _syndrome_matrix(n: int = _N, nroots: int = _NROOTS) -> np.ndarray:
    """(nroots, n) int32: powmat[j, i] = alpha^{j * deg_i}, deg_i = n-1-i."""
    _, alog = _gf_tables()
    deg = np.arange(n)[::-1].astype(np.int64)
    j = np.arange(nroots)[:, None]
    return alog[(j * deg[None, :]) % 255].astype(np.int32)


def _syndromes_batch(cws: np.ndarray, n: int = _N,
                     nroots: int = _NROOTS) -> np.ndarray:
    """(..., n) codewords -> (..., nroots) syndromes, vectorized."""
    log, alog = _gf_tables()
    cws = np.asarray(cws, np.int32)
    pm = _syndrome_matrix(n, nroots)             # (nroots, n)
    lp = log[cws]                                # (..., 120)
    prod = alog[(lp[..., None, :] + log[pm]) % 255]
    prod = np.where(cws[..., None, :] == 0, 0, prod)
    return np.bitwise_xor.reduce(prod, axis=-1)


def rs_decode_np(cw: np.ndarray, n: int = _N, k: int = _K
                 ) -> Tuple[np.ndarray, int]:
    """Decode one n-byte codeword -> (k data bytes, n_corrected|-1)."""
    _N, _K, _NROOTS = n, k, n - k                # shadow module defaults
    cw = np.asarray(cw, np.int32).copy()
    s = [int(v) for v in _syndromes_batch(cw, _N, _NROOTS)]
    if not any(s):
        return cw[:_K].astype(np.uint8), 0

    # Berlekamp-Massey
    C = [1] + [0] * _NROOTS
    B = [1] + [0] * _NROOTS
    L, m, b = 0, 1, 1
    for n in range(_NROOTS):
        d = s[n]
        for i in range(1, L + 1):
            d ^= _mul(C[i], s[n - i])
        if d == 0:
            m += 1
        elif 2 * L <= n:
            T = C[:]
            coef = _div(d, b)
            for i in range(_NROOTS + 1 - m):
                C[i + m] ^= _mul(coef, B[i])
            L, B, b, m = n + 1 - L, T, d, 1
        else:
            coef = _div(d, b)
            for i in range(_NROOTS + 1 - m):
                C[i + m] ^= _mul(coef, B[i])
            m += 1
    if L > _NROOTS // 2:
        return cw[:_K].astype(np.uint8), -1

    log, alog = _gf_tables()

    def eval_many(poly: List[int], degs: np.ndarray) -> np.ndarray:
        """poly(alpha^{-d}) for each d, vectorized over positions."""
        pk = np.asarray(poly, np.int64)
        k = np.arange(pk.shape[0])
        exps = (log[pk][None, :] - degs[:, None] * k[None, :]) % 255
        terms = np.where(pk[None, :] == 0, 0, alog[exps])
        return np.bitwise_xor.reduce(terms, axis=1)

    # Chien search over valid positions (degree 0..N-1), one table pass
    all_deg = np.arange(_N, dtype=np.int64)
    err_deg = all_deg[eval_many(C[:L + 1], all_deg) == 0]
    if err_deg.shape[0] != L:
        return cw[:_K].astype(np.uint8), -1

    # Forney: Omega(x) = S(x) C(x) mod x^10
    omega = [0] * _NROOTS
    for i in range(_NROOTS):
        v = 0
        for k in range(0, min(i, L) + 1):
            v ^= _mul(C[k], s[i - k])
        omega[i] = v
    num = eval_many(omega, err_deg)
    # formal derivative C'(x): odd-power coefficients, evaluated batched
    kk = np.arange(1, L + 1, 2, dtype=np.int64)
    Ck = np.asarray(C, np.int64)[kk]
    exps = (log[Ck][None, :] - err_deg[:, None] * (kk - 1)[None, :]) % 255
    den = np.bitwise_xor.reduce(
        np.where(Ck[None, :] == 0, 0, alog[exps]), axis=1)
    if (den == 0).any():
        return cw[:_K].astype(np.uint8), -1
    nz = num != 0
    mag = np.where(
        nz, alog[(log[num] - log[den] + err_deg) % 255 + 255], 0)
    cw[_N - 1 - err_deg] ^= mag
    if _syndromes_batch(cw, _N, _NROOTS).any():
        return cw[:_K].astype(np.uint8), -1
    return cw[:_K].astype(np.uint8), int(L)


def rs_decode_batch(cws: np.ndarray, n: int = _N, k: int = _K
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode (..., n) codewords -> ((..., k) data, (...,) n_corrected).

    n_corrected is -1 where decoding failed (mirrors rs-decoder.cpp dec()).
    """
    cws = np.asarray(cws, np.uint8)
    lead = cws.shape[:-1]
    flat = cws.reshape(-1, n)
    synd = _syndromes_batch(flat, n, n - k)
    dirty = synd.any(axis=-1)
    data = flat[:, :k].copy()
    ncorr = np.zeros(flat.shape[0], np.int32)
    for i in np.flatnonzero(dirty):
        data[i], ncorr[i] = rs_decode_np(flat[i], n, k)
    return data.reshape(lead + (k,)), ncorr.reshape(lead)
