"""CRC gates used throughout DAB (ETSI EN 300 401 §5.2 / ETSI TS 102 563).

* ``crc16_ccitt``   — CRC-CCITT (poly 0x1021, init 0xFFFF), used for FIBs
  (transmitted inverted; ``dab-constants.h:311-339``), MSC data groups,
  packets, and DAB+ AUs (``mp4processor.cpp:40-61``); byte-wise, numpy.
* ``firecode``      — DAB+ superframe header fire code
  g(x)=(x^11+1)(x^5+x^3+x^2+x+1)  (``firecode-checker.cpp:33-94``).
* :func:`check_crc16_bits` — the batched CRC16 gate over bit tensors on
  the device (torch port of the device branch of dabjax's
  ``check_crc16_bits``), or over numpy arrays on the host (its numpy
  branch); :func:`check_crc16_inverted_bits` is its FIB-style form.

CUDA torch has no int32 matmul, so the gate's GF(2) product runs as a float32
matmul of 0/1 values and is reduced mod 2 afterwards.  It is exact: every
output is a count of ones of at most ``n - 16`` (240 for a FIB), and
integers up to 2^11 are exact even if a TF32 matmul mode is switched on
(10-bit mantissa for the 0/1 inputs, float32 accumulation).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["crc16_ccitt", "crc16_ccitt_batch", "crc16_append_bits",
           "check_crc16_bits", "check_crc16_inverted_bits", "firecode_check",
           "firecode_parity", "crc16_update_table"]


@functools.lru_cache(maxsize=None)
def crc16_update_table(poly: int = 0x1021) -> np.ndarray:
    """256-entry CRC-16 update table for MSB-first processing."""
    tab = np.empty(256, dtype=np.uint16)
    for b in range(256):
        acc = b << 8
        for _ in range(8):
            acc = ((acc << 1) ^ poly) if (acc & 0x8000) else (acc << 1)
            acc &= 0xFFFF
        tab[b] = acc
    return tab


_CRC16_BIG_M: np.ndarray = None     # grows on demand; rows are x^k mod g


def _crc16_big_matrix(nbits: int) -> np.ndarray:
    """Tail-sliceable CRC bit matrix: row i of the returned (L, 16) matrix
    is x^(L-1-i+16) mod g, so the CRC matrix for ANY message of n <= L bits
    is its last n rows (one cached allocation serves every length)."""
    global _CRC16_BIG_M
    if _CRC16_BIG_M is None or _CRC16_BIG_M.shape[0] < nbits:
        L = max(32768, 1 << int(np.ceil(np.log2(max(nbits, 16)))))
        m = _crc16_bits_matrix(L)
        _CRC16_BIG_M = m.astype(np.float32)
    return _CRC16_BIG_M


def crc16_ccitt(data: np.ndarray, init: int = 0xFFFF) -> int:
    """CRC-CCITT over bytes (uint8 array). Returns the 16-bit remainder.

    Fast path (init 0xFFFF, the only init DAB uses): one BLAS matvec of the
    message bits against the cached GF(2) remainder matrix — the former
    per-byte Python loop cost ~0.3 ms per AU, which dominated the DAB+
    host plane at 25 AUs/s/service."""
    data = np.asarray(data, dtype=np.uint8)
    if init == 0xFFFF and data.shape[0] >= 2:
        bits = np.unpackbits(data)
        n = bits.shape[0]
        m = _crc16_big_matrix(n)[-n:]
        # popcounts <= n < 2^24: exact in float32 BLAS
        crc = (bits.astype(np.float32) @ m).astype(np.int64) & 1
        crc ^= m[:16].astype(np.int64).sum(axis=0) & 1   # init-0xFFFF term
        return int(crc @ (1 << np.arange(15, -1, -1)))
    tab = crc16_update_table()
    acc = init
    for byte in data:
        acc = ((acc << 8) & 0xFFFF) ^ int(tab[(acc >> 8) ^ byte])
    return acc


def crc16_ccitt_batch(data: np.ndarray) -> np.ndarray:
    """CRC-CCITT over the last axis of a (..., n) uint8 byte tensor (numpy)."""
    tab = crc16_update_table()
    data = np.asarray(data, dtype=np.uint8)
    acc = np.full(data.shape[:-1], 0xFFFF, dtype=np.uint16)
    for i in range(data.shape[-1]):
        acc = ((acc << 8) & 0xFFFF) ^ tab[(acc >> 8) ^ data[..., i]]
    return acc


def _crc16_bits_matrix(nbits: int) -> np.ndarray:
    """(nbits+16, 16) GF(2) matrix M with crc_bits = bits_ext @ M mod 2.

    ``bits_ext`` is the message extended by 16 ones (the init-0xFFFF trick) —
    callers use :func:`check_crc16_bits` instead of this directly.
    """
    # CRC of a one-hot message of length L equals the column pattern; build
    # by shifting the polynomial. Row i = remainder of x^(L-1-i+16) mod g(x).
    g = 0x11021
    L = nbits
    rows = np.zeros((L, 16), dtype=np.uint8)
    rem = 1  # x^0
    # remainder of x^k mod g for k = 16 .. 16+L-1, computed incrementally.
    rem = 0x0001
    for _ in range(16):
        rem <<= 1
        if rem & 0x10000:
            rem ^= g
    # now rem = x^16 mod g
    for i in range(L):
        rows[L - 1 - i] = [(rem >> (15 - b)) & 1 for b in range(16)]
        rem <<= 1
        if rem & 0x10000:
            rem ^= g
    return rows


@functools.lru_cache(maxsize=None)
def _crc16_check_tables(nbits: int):
    m = _crc16_bits_matrix(nbits - 16)
    # Effect of the 0xFFFF init: equivalent to XORing the first 16 message
    # bits with ones => precompute the CRC contribution of that pattern.
    init_vec = np.zeros(nbits - 16, dtype=np.uint8)
    init_vec[:16] = 1
    init_crc = (init_vec @ m) & 1
    return m, init_crc


def crc16_append_bits(bits: np.ndarray, inverted: bool = True) -> np.ndarray:
    """Transmitter side: append the (optionally inverted) 16-bit CRC."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1] + 16
    m, init_crc = _crc16_check_tables(n)
    crc = ((bits @ m) & 1) ^ init_crc
    if inverted:
        crc = crc ^ 1
    return np.concatenate([bits, crc.astype(np.uint8)], axis=-1)


# ---------------------------------------------------------------- firecode

#: g(x) = (x^11+1)(x^5+x^3+x^2+x+1) coefficients, LSB-first
#: (firecode-checker.cpp:34).
_FIRE_G = (1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0)


@functools.lru_cache(maxsize=None)
def _firecode_table() -> np.ndarray:
    def run8(regs: np.ndarray) -> int:
        for _ in range(8):
            z = int(regs[15])
            for j in range(15, 0, -1):
                regs[j] = regs[j - 1] ^ (z & _FIRE_G[j])
            regs[0] = z
        v = 0
        for i in range(15, -1, -1):
            v = (v << 1) | int(regs[i])
        return v

    itab = np.empty(8, dtype=np.uint16)
    for i in range(8):
        regs = np.zeros(16, dtype=np.uint8)
        regs[8 + i] = 1
        itab[i] = run8(regs)
    tab = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        v = 0
        for j in range(8):
            if i & (1 << j):
                v ^= int(itab[j])
        tab[i] = v
    return tab


def firecode_check(header: np.ndarray) -> bool:
    """Check the DAB+ superframe fire code over the first 11 bytes.

    ``header``: >= 11 bytes; bytes [0:2] hold the parity word, bytes [2:11]
    are protected (ETSI TS 102 563 §5.2; firecode-checker.cpp:76-94).
    """
    x = np.asarray(header, dtype=np.uint8)
    tab = _firecode_table()
    state = (int(x[2]) << 8) | int(x[3])
    for i in list(range(4, 11)) + [0, 1]:
        istate = int(tab[state >> 8])
        state = ((istate & 0x00FF) ^ int(x[i])) | \
                ((istate ^ (state << 8)) & 0xFF00)
    return state == 0


def firecode_parity(payload9: np.ndarray) -> int:
    """Transmitter: 16-bit fire-code parity for 9 payload bytes.

    Computes the word such that ``firecode_check([p>>8, p&0xFF, *payload9])``
    passes.  Used by the DAB+ modulator for golden fixtures.
    """
    payload9 = np.asarray(payload9, dtype=np.uint8)
    assert payload9.shape == (9,)
    # The code is linear: state = A(payload) ^ B(parity). Solve B(p) = A.
    base = np.concatenate([np.zeros(2, np.uint8), payload9])
    # contribution of payload with zero parity:
    a = _firecode_run(base)
    # contribution of each parity bit:
    cols = []
    for b in range(16):
        v = np.zeros(11, np.uint8)
        v[0] = (1 << b >> 8) & 0xFF if b >= 8 else 0
        v[1] = (1 << b) & 0xFF if b < 8 else 0
        cols.append(_firecode_run(v))
    # Solve XOR-linear system over 16 unknown bits.
    mat = np.array([[ (c >> k) & 1 for c in cols] for k in range(16)],
                   dtype=np.uint8)  # (16 eq, 16 unknowns)
    rhs = np.array([(a >> k) & 1 for k in range(16)], dtype=np.uint8)
    sol = _gf2_solve(mat, rhs)
    p = 0
    for b in range(16):
        p |= int(sol[b]) << b
    return p


def _firecode_run(x: np.ndarray) -> int:
    tab = _firecode_table()
    state = (int(x[2]) << 8) | int(x[3])
    for i in list(range(4, 11)) + [0, 1]:
        istate = int(tab[state >> 8])
        state = ((istate & 0x00FF) ^ int(x[i])) | \
                ((istate ^ (state << 8)) & 0xFF00)
    return state


def _gf2_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve a @ x = b over GF(2); a is (n, n), b is (n,)."""
    a = a.copy() & 1
    b = b.copy() & 1
    n = a.shape[0]
    piv_col_of_row = [-1] * n
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, n):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            continue
        a[[row, piv]] = a[[piv, row]]
        b[[row, piv]] = b[[piv, row]]
        for r in range(n):
            if r != row and a[r, col]:
                a[r] ^= a[row]
                b[r] ^= b[row]
        piv_col_of_row[row] = col
        row += 1
    x = np.zeros(n, dtype=np.uint8)
    for r in range(n):
        c = piv_col_of_row[r]
        if c >= 0:
            x[c] = b[r]
    return x


# ------------------------------------------------------------ device gate

@functools.lru_cache(maxsize=None)
def _tables(nbits: int, device: torch.device):
    m, init_crc = _crc16_check_tables(nbits)
    return (torch.as_tensor(m, device=device).to(torch.float32),
            torch.as_tensor(init_crc, device=device).to(torch.int32))


def check_crc16_bits(bits, inverted: bool = True):
    """``bits`` (..., n) 0/1, the last 16 the stored CRC -> bool (...,):
    a tensor for a tensor, a numpy array (any length) for a numpy
    array."""
    n = bits.shape[-1]
    if isinstance(bits, np.ndarray):
        m, init_crc = _crc16_check_tables(n)
        msg, stored = bits[..., : n - 16], bits[..., n - 16:]
        crc = (msg.astype(np.uint8) @ m) & 1
        crc = crc ^ init_crc
        if inverted:
            crc = crc ^ 1
        return np.all(crc == stored, axis=-1)
    if n > 16 + (1 << 11):
        raise ValueError(f"{n}-bit message exceeds the exact matmul range")
    m, init_crc = _tables(n, bits.device)
    msg, stored = bits[..., : n - 16], bits[..., n - 16:]
    crc = (msg.to(torch.float32) @ m).to(torch.int32) & 1
    crc = crc ^ init_crc
    if inverted:
        crc = crc ^ 1
    return torch.all(crc == stored.to(torch.int32), dim=-1)


def check_crc16_inverted_bits(bits):
    """FIB-style CRC gate (CRC stored inverted), batched over leading axes."""
    return check_crc16_bits(bits, inverted=True)
