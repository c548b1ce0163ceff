"""Batched CRC16 gate over bit tensors (torch port of the device branch of
:func:`dabjax.fec.crc.check_crc16_bits`).

CUDA torch has no int32 matmul, so the GF(2) product runs as a float32
matmul of 0/1 values and is reduced mod 2 afterwards.  It is exact: every
output is a count of ones of at most ``n - 16`` (240 for a FIB), and
integers up to 2^11 are exact even if a TF32 matmul mode is switched on
(10-bit mantissa for the 0/1 inputs, float32 accumulation).
"""

from __future__ import annotations

import functools

import torch

from dabjax.fec.crc import _crc16_check_tables

__all__ = ["check_crc16_bits"]


@functools.lru_cache(maxsize=None)
def _tables(nbits: int, device: torch.device):
    m, init_crc = _crc16_check_tables(nbits)
    return (torch.as_tensor(m, device=device).to(torch.float32),
            torch.as_tensor(init_crc, device=device).to(torch.int32))


def check_crc16_bits(bits: torch.Tensor, inverted: bool = True
                     ) -> torch.Tensor:
    """``bits`` (..., n) 0/1, the last 16 the stored CRC -> bool (...,)."""
    n = bits.shape[-1]
    if n > 16 + (1 << 11):
        raise ValueError(f"{n}-bit message exceeds the exact matmul range")
    m, init_crc = _tables(n, bits.device)
    msg, stored = bits[..., : n - 16], bits[..., n - 16:]
    crc = (msg.to(torch.float32) @ m).to(torch.int32) & 1
    crc = crc ^ init_crc
    if inverted:
        crc = crc ^ 1
    return torch.all(crc == stored.to(torch.int32), dim=-1)
