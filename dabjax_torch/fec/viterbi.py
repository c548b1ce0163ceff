"""Batched Viterbi decoder for the DAB K=7, rate-1/4 code (torch).

:func:`viterbi_decode` is the one entry point of the FIC and MSC paths: a
CUDA tensor goes to the hand-written kernels of
:mod:`dabjax_torch.fec.viterbi_cuda`, a CPU tensor to
:func:`viterbi_decode_torch`, the plain radix-2 version (the port of
``dabjax.fec.viterbi.viterbi_decode_jax``).  Both are bit-exact with
:func:`dabjax.fec.viterbi.viterbi_decode_np` on integer soft bits with
|soft| <= 127, the demod's contract; the ACS tables are dabjax's own.
"""

from __future__ import annotations

import numpy as np
import torch

from dabjax.fec import conv
from dabjax.fec.viterbi import branch_signs
from dabjax_torch.fec.viterbi_cuda import viterbi_decode_cuda

__all__ = ["viterbi_decode", "viterbi_decode_torch", "viterbi_forward_torch",
           "viterbi_traceback_torch"]

#: trellis steps whose branch metrics are formed in one matmul
_CHUNK = 64


def _steps(soft: torch.Tensor, nbits: int):
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    lead = tuple(soft.shape[:-1])
    return T, lead, int(np.prod(lead)) if lead else 1


def viterbi_forward_torch(soft: torch.Tensor) -> torch.Tensor:
    """Plain forward ACS: ``soft`` [B, T, 4] integer-valued -> decisions
    bool [B, T, 64].  Int32 path metrics start at 0 for state 0 and -2^29
    elsewhere (exact, no renormalisation); ties keep branch 0."""
    B, T, _ = soft.shape
    dev = soft.device
    s = soft.to(torch.float32)
    # integer soft bits times +-1: the float32 products and sums are exact
    sg = torch.as_tensor(branch_signs().T.astype(np.float32), device=dev)
    pm = torch.full((B, 64), -(1 << 29), dtype=torch.int32, device=dev)
    pm[:, 0] = 0
    dec = torch.empty((B, T, 64), dtype=torch.bool, device=dev)
    for c0 in range(0, T, _CHUNK):
        bs = (s[:, c0: c0 + _CHUNK] @ sg).to(torch.int32)   # [B, c, 128]
        for j in range(bs.shape[1]):
            # new state n: predecessor n >> 1 via r = n (scores bs[:, :64]),
            # predecessor (n >> 1) | 32 via r = n | 64 (bs[:, 64:])
            m0 = pm[:, :32].repeat_interleave(2, dim=1) + bs[:, j, :64]
            m1 = pm[:, 32:].repeat_interleave(2, dim=1) + bs[:, j, 64:]
            d = m1 > m0
            dec[:, c0 + j] = d
            pm = torch.where(d, m1, m0)
    return dec


def viterbi_traceback_torch(dec: torch.Tensor, nbits: int) -> torch.Tensor:
    """Plain traceback from state 0: decisions bool [B, T, 64] ->
    bits int32 [B, nbits]."""
    B, T, _ = dec.shape
    state = torch.zeros((B, 1), dtype=torch.int64, device=dec.device)
    out = torch.empty((B, T), dtype=torch.int32, device=dec.device)
    for t in range(T - 1, -1, -1):
        out[:, t] = (state[:, 0] & 1).to(torch.int32)
        d = dec[:, t].gather(1, state).to(torch.int64)
        state = (state >> 1) | (d << 5)
    return out[:, :nbits]


def viterbi_decode_torch(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """Plain torch decode: ``soft`` (..., 4*(nbits+6)) -> (..., nbits)
    int32."""
    T, lead, B = _steps(soft, nbits)
    dec = viterbi_forward_torch(soft.reshape(B, T, 4))
    return viterbi_traceback_torch(dec, nbits).reshape(lead + (nbits,))


def viterbi_decode(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """Decode on the tensor's device: the CUDA kernels for a CUDA tensor,
    the plain version for a CPU tensor; any other device raises."""
    if soft.is_cuda:
        return viterbi_decode_cuda(soft, nbits)
    if soft.device.type == "cpu":
        return viterbi_decode_torch(soft, nbits)
    raise ValueError(f"no Viterbi decoder for device {soft.device}")
