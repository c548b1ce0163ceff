"""Energy-dispersal PRBS, x^9 + x^5 + 1 (ETSI EN 300 401 §10).

The reference computes this with a 9-cell shift register seeded with all
ones (``fic-handler.cpp:100-108``, ``dab-concurrent.cpp:183-190``).  Here the
sequence is precomputed once per length (numpy, dabjax's :func:`prbs`) and
applied as one XOR: on numpy bits for the transmitter, on tensors for the
receive path (torch port of dabjax's ``disperse``).  :func:`words` packs it
32 bits a word for the traceback kernel that disperses as it stores bytes
(``viterbi_cuda.viterbi_traceback_packed_cuda``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["prbs", "disperse", "words", "words_on"]


@functools.lru_cache(maxsize=None)
def prbs(n: int) -> np.ndarray:
    """First ``n`` bits of the DAB energy-dispersal PRBS (uint8 0/1)."""
    reg = np.ones(9, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        b = reg[8] ^ reg[4]
        out[i] = b
        reg[1:] = reg[:-1]
        reg[0] = b
    return out


@functools.lru_cache(maxsize=None)
def _seq(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(prbs(n), device=device).to(dtype)


@functools.lru_cache(maxsize=None)
def words(n: int) -> np.ndarray:
    """The first ``n`` PRBS bits as uint32 [ceil(n / 32)]: bit j of word k
    is bit 32k + j (zeros past ``n``), the order in which the traceback
    kernel gathers a tile's decoded bits."""
    bits = np.zeros(-(-n // 32) * 32, dtype=np.uint64)
    bits[:n] = prbs(n)
    return (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def words_on(n: int, device: torch.device) -> torch.Tensor:
    """:func:`words` as int32 on ``device``, uploaded once (a CUDA graph's
    eager first call fills the cache before its capture)."""
    return torch.from_numpy(words(n).view(np.int32)).to(device)


def disperse(bits, n: int | None = None):
    """XOR integer 0/1 ``bits`` (..., n), a numpy array or a tensor, with
    the PRBS. Self-inverse."""
    if n is None:
        n = bits.shape[-1]
    if isinstance(bits, np.ndarray):
        return bits ^ prbs(n)
    return torch.bitwise_xor(bits, _seq(n, bits.dtype, bits.device))
