"""Batched Viterbi decoder for the DAB K=7, rate-1/4 code (torch).

:func:`viterbi_decode` is the one entry point of the FIC and MSC paths: a
CUDA tensor goes to the hand-written kernels of
:mod:`dabjax_torch.fec.viterbi_cuda`, a CPU tensor to the plain versions
(radix-2 :func:`viterbi_forward_torch` and
:func:`viterbi_traceback_torch`, the port of
``dabjax.fec.viterbi.viterbi_decode_jax``, or the radix-4 word pair), in
the format ``viterbi_cuda.SOFT_FMT`` picks.  Both are bit-exact with
:func:`dabjax.fec.viterbi.viterbi_decode_np` on integer soft bits with
|soft| <= 127, the demod's contract; the ACS tables are dabjax's own.

:func:`viterbi_forward_words` and :func:`viterbi_traceback_words` split
the decode in two, as ``dabjax.fec.viterbi_pallas`` does for its stage
timing, in the layout of ``viterbi_cuda.SOFT_FMT``.  The radix-4 word
layout's plain versions are :func:`viterbi_forward_words_torch` and
:func:`viterbi_traceback_words_torch`.
"""

from __future__ import annotations

import numpy as np
import torch

from dabjax.fec import conv
from dabjax.fec.viterbi import branch_signs
from dabjax_torch.fec import viterbi_cuda

__all__ = ["viterbi_decode", "viterbi_decode_torch", "viterbi_forward_torch",
           "viterbi_traceback_torch", "viterbi_forward_words",
           "viterbi_traceback_words", "viterbi_forward_words_torch",
           "viterbi_traceback_words_torch"]

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


def viterbi_forward_words_torch(soft: torch.Tensor, nbits: int, fmt: str):
    """Plain radix-4 forward ACS of a word format ("i8mxu", "i8", "f32"):
    ``soft`` (..., 4*(nbits+6)) -> (words int32 [W, 64, B], last int32
    [B]).

    ``words`` equals dabjax's ``viterbi_forward_words`` under that
    ``SOFT_FMT`` with the lane padding dropped: pair step ``16w + j`` of
    state n holds its 2-bit branch e = (d0 << 1) | d1 at bits 2j..2j+1 of
    ``words[w, n]``, and pair steps >= T2 are 0.  The metrics are int32
    from 0 / -2^29 ("i8mxu") or float32 from 0 / -1e9 with one float add
    per candidate ("i8", "f32"), as there: the two groups' words differ
    where the -1e9 start rounds, in the first pair steps of states that
    state 0 cannot reach yet.  ``last`` is state 0's decision at trellis
    step 2(T2-1), which :func:`viterbi_traceback_words_torch` needs when
    the step count is odd."""
    x = viterbi_cuda.pair_soft(soft, nbits, fmt)        # [B, T2, 8]
    B, T2, _ = x.shape
    if fmt == "i8mxu":
        mtype, start = torch.int32, -(1 << 29)
    else:
        mtype, start = torch.float32, -1e9
    dev = x.device
    # integer soft times +-1: the float32 products and sums are exact
    S4 = torch.as_tensor(viterbi_cuda.radix4_signs().T.astype(np.float32),
                         device=dev)                     # [8, 256]
    pm = torch.full((B, 64), start, dtype=mtype, device=dev)
    pm[:, 0] = 0
    words = torch.zeros((B, -(-T2 // 16), 64), dtype=torch.int64, device=dev)
    for c0 in range(0, T2, _CHUNK):
        bms = (x[:, c0: c0 + _CHUNK].to(torch.float32) @ S4).to(mtype)
        for j in range(bms.shape[1]):
            tau = c0 + j
            # row e*64 + n has predecessor p with 4p + (n & 3) == e*64 + n
            m = pm.repeat_interleave(4, dim=1) + bms[:, j]  # [B, 256]
            m00, m01 = m[:, 0:64], m[:, 64:128]
            m10, m11 = m[:, 128:192], m[:, 192:256]
            da = m10 > m00
            a = torch.where(da, m10, m00)
            db = m11 > m01
            b = torch.where(db, m11, m01)
            d1 = b > a
            pm = torch.where(d1, b, a)
            e = ((torch.where(d1, db, da).to(torch.int64) << 1)
                 | d1.to(torch.int64))
            words[:, tau // 16] |= e << (2 * (tau % 16))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return (words.to(torch.int32).permute(1, 2, 0),
            da[:, 0].to(torch.int32))


def viterbi_traceback_words_torch(words: torch.Tensor, last: torch.Tensor,
                                  nbits: int) -> torch.Tensor:
    """Plain word traceback: (words [W, 64, B], last [B]) -> bits int32
    [B, nbits].

    The walk of ``_traceback_kernel`` from state 0 (state =
    (state >> 2) | (e << 4)), then bits[2t] = e[t+3] >> 1 and
    bits[2t+1] = e[t+3] & 1.  With an odd step count the last pair ends on
    a zero-soft padding step; the walk then starts at state 0 after the
    true last step, taking that pair's branch as ``last << 1``, so the
    bits equal ``viterbi_decode_np`` where dabjax's walk, starting after
    the padding step, does not on noise-like input."""
    T = nbits + conv.K - 1
    T2 = -(-T // 2)
    B = words.shape[2]
    d = words.permute(2, 0, 1)                           # [B, W, 64]
    state = torch.zeros((B, 1), dtype=torch.int64, device=words.device)
    e_seq = torch.empty((B, T2), dtype=torch.int64, device=words.device)
    for tau in range(T2 - 1, -1, -1):
        if T % 2 and tau == T2 - 1:
            e = last.to(torch.int64)[:, None] << 1
        else:
            e = (d[:, tau // 16].gather(1, state).to(torch.int64)
                 >> (2 * (tau % 16))) & 3
        e_seq[:, tau] = e[:, 0]
        state = (state >> 2) | (e << 4)
    n_pairs = -(-nbits // 2)
    e3 = e_seq[:, 3: 3 + n_pairs]
    bits = torch.stack([e3 >> 1, e3 & 1], dim=-1).reshape(B, 2 * n_pairs)
    return bits[:, :nbits].to(torch.int32)


def _device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernels), False for a CPU tensor (plain
    versions); any other device raises."""
    if t.is_cuda or t.device.type == "cpu":
        return t.is_cuda
    raise ValueError(f"no Viterbi decoder for device {t.device}")


def viterbi_forward_words(soft: torch.Tensor, nbits: int):
    """Forward ACS only, in the layout of ``viterbi_cuda.SOFT_FMT``:
    ``soft`` (..., 4*(nbits+6)) -> (dec, last).

    * "i8lane"/"i8lane2": ``dec`` is K1's int32 [B, T, 2] (bit s % 32 of
      word s // 32 is state s's radix-2 decision at step t); ``last`` is
      None.
    * "i8mxu"/"i8"/"f32": ``dec`` is the radix-4 words int32 [W, 64, B]
      of dabjax's ``viterbi_forward_words`` (16 pair steps per word, pair
      j at bits 2j..2j+1); ``last`` is int32 [B] (see
      :func:`viterbi_forward_words_torch`).

    This is the one place a format picks its kernels: a CUDA tensor goes
    to K1 or K3, a CPU tensor to the plain version, both fed by the same
    ``step_soft`` / ``pair_soft`` (so the same clip or cast)."""
    fmt = viterbi_cuda.soft_format()
    cuda = _device(soft)
    if fmt in viterbi_cuda.WORD_FORMATS:
        if cuda:
            return viterbi_cuda.viterbi_forward_words_cuda(
                viterbi_cuda.pair_soft(soft, nbits, fmt), fmt)
        return viterbi_forward_words_torch(soft, nbits, fmt)
    s = viterbi_cuda.step_soft(soft, nbits)
    if cuda:
        return viterbi_cuda.viterbi_forward_cuda(s), None
    return viterbi_cuda.pack_decisions(viterbi_forward_torch(s)), None


def viterbi_traceback_words(words: torch.Tensor, last: torch.Tensor,
                            nbits: int) -> torch.Tensor:
    """Traceback of the radix-4 words of :func:`viterbi_forward_words`:
    K4 for CUDA tensors, the plain version for CPU tensors."""
    if _device(words):
        return viterbi_cuda.viterbi_traceback_words_cuda(words, last, nbits)
    return viterbi_traceback_words_torch(words, last, nbits)


def viterbi_decode(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """Decode on the tensor's device in the format ``SOFT_FMT`` picks
    (:func:`viterbi_forward_words`), then the traceback of its layout:
    the CUDA kernels for a CUDA tensor, the plain versions for a CPU
    tensor; any other device raises."""
    _, lead, _ = _steps(soft, nbits)
    dec, last = viterbi_forward_words(soft, nbits)
    if last is not None:
        bits = viterbi_traceback_words(dec, last, nbits)
    elif dec.is_cuda:
        bits = viterbi_cuda.viterbi_traceback_cuda(dec, nbits)
    else:
        bits = viterbi_traceback_torch(viterbi_cuda.unpack_decisions(dec),
                                       nbits)
    return bits.reshape(lead + (nbits,))
