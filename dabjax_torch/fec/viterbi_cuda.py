"""ctypes wrappers over the CUDA Viterbi kernels (``csrc/viterbi.cu``).

* forward ACS (K1) replaces ``_forward_kernel_lane`` of
  ``dabjax/fec/viterbi_pallas.py``: soft int8 [B, T, 4] -> decision words
  int32 [B, T, 2] (bit s of word s // 32 is state s's decision);
* traceback (K2) replaces ``_traceback_kernel`` and the unpack epilogue
  of ``viterbi_decode_pallas``: decision words -> bits int32 [B, nbits];
* radix-4 forward ACS (K3) replaces ``_forward_kernel``: pair-step soft
  [B, T2, 8] -> the radix-4 decision words of dabjax's
  ``viterbi_forward_words`` [W, 64, B] int32, plus ``last`` [B] int32;
* word traceback (K4) replaces ``_traceback_kernel`` and the epilogue for
  that word layout: (words, last) -> bits int32 [B, nbits].

:data:`SOFT_FMT` picks the forward kernel of
:func:`dabjax_torch.fec.viterbi.viterbi_forward_words` (and so of every
decode), as the same global of ``dabjax/fec/viterbi_pallas.py`` does
there: "i8lane" and
"i8lane2" run K1 + K2 ("i8lane2" is a TPU scheduling variant of the same
kernel), "i8mxu", "i8" and "f32" run K3 + K4 with int32 / float / float
path metrics on an int8 / int8 / float soft stream.

The wrappers take CUDA tensors only and raise on anything else, on a
failed build and on a failed launch; there is no fallback.  Each adds one
to its launch count where it launches its kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dabjax.fec import conv
from dabjax.fec.viterbi import branch_signs
from dabjax_torch import _build

__all__ = ["SOFT_FMT", "FORMATS", "WORD_FORMATS", "viterbi_forward_cuda", "viterbi_traceback_cuda",
           "viterbi_forward_words_cuda", "viterbi_traceback_words_cuda",
           "step_soft", "pair_soft", "radix4_signs", "reset_launches",
           "soft_format", "pack_decisions", "unpack_decisions"]

#: the soft-input formats of dabjax's ``viterbi_pallas.SOFT_FMT``
FORMATS = ("i8lane", "i8lane2", "i8mxu", "i8", "f32")
#: formats decoded through the radix-4 decision words (K3 + K4), with
#: K3's variant code
WORD_FORMATS = {"i8mxu": 0, "i8": 1, "f32": 2}
#: the forward kernel of every decode on a CUDA tensor (see module doc)
SOFT_FMT = "i8lane"

#: launches of the forward ACS kernel (K1) since the last reset
FORWARD_LAUNCHES = 0
#: launches of the traceback kernel (K2) since the last reset
TRACEBACK_LAUNCHES = 0
#: launches of the radix-4 word forward kernel (K3) since the last reset
WORDS_FORWARD_LAUNCHES = 0
#: launches of the word traceback kernel (K4) since the last reset
WORDS_TRACEBACK_LAUNCHES = 0

_PAIRS_PER_WORD = 16


def reset_launches() -> None:
    global FORWARD_LAUNCHES, TRACEBACK_LAUNCHES
    global WORDS_FORWARD_LAUNCHES, WORDS_TRACEBACK_LAUNCHES
    FORWARD_LAUNCHES = 0
    TRACEBACK_LAUNCHES = 0
    WORDS_FORWARD_LAUNCHES = 0
    WORDS_TRACEBACK_LAUNCHES = 0


def soft_format() -> str:
    """:data:`SOFT_FMT`, checked against :data:`FORMATS`."""
    if SOFT_FMT not in FORMATS:
        raise ValueError(f"unknown SOFT_FMT {SOFT_FMT!r}; one of {FORMATS}")
    return SOFT_FMT


@functools.lru_cache(maxsize=None)
def radix4_signs() -> np.ndarray:
    """S4 [256, 8] int8: the +-1 signs of pair-step branch row e*64 + n
    (new state n, branch e = (d0 << 1) | d1), the first step's 4 then the
    second's; the S4 of ``viterbi_pallas._radix4_matrices``."""
    signs = branch_signs()
    S4 = np.zeros((256, 8), np.int8)
    n = np.arange(64)
    for e in range(4):
        p = (n >> 2) | (e << 4)                   # predecessor
        q = ((p << 1) | ((n >> 1) & 1)) & 63      # state between the steps
        rows = e * 64 + n
        S4[rows, :4] = signs[q | ((p >> 5) << 6)]
        S4[rows, 4:] = signs[n | ((q >> 5) << 6)]
    return S4


def step_soft(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) -> K1's input: int8 [B, T, 4], clipped
    to +-127 as ``viterbi_forward_words`` does (identity inside the
    decode contract)."""
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    s = soft.reshape(-1, T, 4).clamp(-127, 127).to(torch.int8)
    return s.contiguous()


def pair_soft(soft: torch.Tensor, nbits: int, fmt: str) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) -> pair-step soft [B, T2, 8] of a word
    format: clipped to +-127 and cast to int8 for "i8mxu"/"i8", cast to
    float32 (no clip) for "f32"; an odd step count gets one zero step,
    as ``viterbi_forward_words`` pads."""
    if fmt not in WORD_FORMATS:
        raise ValueError(f"{fmt!r} is not a word format {tuple(WORD_FORMATS)}")
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    s = soft.reshape(-1, T, 4)
    if fmt == "f32":
        s = s.to(torch.float32)
    else:
        s = s.clamp(-127, 127).to(torch.int8)
    if T % 2:
        s = torch.cat([s, s.new_zeros((s.shape[0], 1, 4))], dim=1)
    return s.reshape(s.shape[0], -1, 8).contiguous()


@functools.lru_cache(maxsize=None)
def _signs(device: torch.device) -> torch.Tensor:
    """[128] int32: register value r's four +-1 signs packed as int8x4."""
    packed = np.ascontiguousarray(branch_signs().astype(np.int8))
    return torch.from_numpy(packed.view(np.int32).reshape(128)).to(device)


def _require(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype} with {ndim} dims,"
                         f" got {t.dtype} {tuple(t.shape)}")


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def viterbi_forward_cuda(soft: torch.Tensor) -> torch.Tensor:
    """K1: ``soft`` int8 [B, T, 4] -> decision words int32 [B, T, 2]."""
    global FORWARD_LAUNCHES
    _require(soft, torch.int8, 3, "viterbi_forward_cuda")
    B, T, k = soft.shape
    if k != 4:
        raise ValueError(f"viterbi_forward_cuda: last dim {k} != 4")
    dec = torch.empty((B, T, 2), dtype=torch.int32, device=soft.device)
    if B == 0 or T == 0:
        return dec
    lib = _build.load_library()
    signs = _signs(soft.device)
    with torch.cuda.device(soft.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_viterbi_forward(soft.data_ptr(), signs.data_ptr(),
                                        dec.data_ptr(), B, T, stream)
        FORWARD_LAUNCHES += 1
    _check(rc, "viterbi_forward_cuda")
    return dec


def viterbi_traceback_cuda(dec: torch.Tensor, nbits: int) -> torch.Tensor:
    """K2: decision words int32 [B, T, 2] -> bits int32 [B, nbits]."""
    global TRACEBACK_LAUNCHES
    _require(dec, torch.int32, 3, "viterbi_traceback_cuda")
    B, T, k = dec.shape
    if k != 2 or not 0 <= nbits <= T:
        raise ValueError(f"viterbi_traceback_cuda: bad shape {tuple(dec.shape)}"
                         f" for nbits={nbits}")
    bits = torch.empty((B, nbits), dtype=torch.int32, device=dec.device)
    if B == 0 or nbits == 0:
        return bits
    lib = _build.load_library()
    with torch.cuda.device(dec.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_viterbi_traceback(dec.data_ptr(), bits.data_ptr(),
                                          B, T, nbits, stream)
        TRACEBACK_LAUNCHES += 1
    _check(rc, "viterbi_traceback_cuda")
    return bits


@functools.lru_cache(maxsize=None)
def _signs4(device: torch.device, fmt: str) -> torch.Tensor:
    """K3's branch rows: [256, 2] int32 (packed int8x8) for an int8
    stream, [256, 8] float32 for the float stream."""
    S4 = radix4_signs()
    if fmt == "f32":
        return torch.from_numpy(S4.astype(np.float32)).to(device)
    return torch.from_numpy(S4.view(np.int32).copy()).to(device)


def viterbi_forward_words_cuda(x: torch.Tensor, fmt: str):
    """K3: pair-step soft [B, T2, 8] from :func:`pair_soft` (int8, or
    float32 for "f32") -> (words int32 [W, 64, B], last int32 [B]).

    ``words`` is a view of the kernel's [B, W, 64] output.  ``last`` is
    state 0's decision at trellis step 2(T2-1), which the traceback needs
    when the step count is odd."""
    global WORDS_FORWARD_LAUNCHES
    variant = WORD_FORMATS.get(fmt)
    if variant is None:
        raise ValueError(f"{fmt!r} is not a word format {tuple(WORD_FORMATS)}")
    _require(x, torch.float32 if fmt == "f32" else torch.int8, 3,
             "viterbi_forward_words_cuda")
    B, T2, k = x.shape
    if k != 8 or T2 == 0:
        raise ValueError(f"viterbi_forward_words_cuda: bad shape "
                         f"{tuple(x.shape)}")
    W = -(-T2 // _PAIRS_PER_WORD)
    dec = torch.empty((B, W, 64), dtype=torch.int32, device=x.device)
    last = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B:
        lib = _build.load_library()
        signs = _signs4(x.device, fmt)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.dabjax_viterbi_forward_words(
                x.data_ptr(), signs.data_ptr(), dec.data_ptr(),
                last.data_ptr(), B, T2, variant, stream)
            WORDS_FORWARD_LAUNCHES += 1
        _check(rc, "viterbi_forward_words_cuda")
    return dec.permute(1, 2, 0), last


def viterbi_traceback_words_cuda(words: torch.Tensor, last: torch.Tensor,
                                 nbits: int) -> torch.Tensor:
    """K4: (words int32 [W, 64, B], last int32 [B]) -> bits int32
    [B, nbits]."""
    global WORDS_TRACEBACK_LAUNCHES
    if not (words.is_cuda and last.is_cuda):
        raise ValueError(f"viterbi_traceback_words_cuda: CUDA tensors "
                         f"required, got {words.device}, {last.device}")
    T2 = -(-(nbits + conv.K - 1) // 2)
    W = -(-T2 // _PAIRS_PER_WORD)
    if (words.dtype != torch.int32 or last.dtype != torch.int32
            or words.dim() != 3 or words.shape[:2] != (W, 64)
            or tuple(last.shape) != (words.shape[2],) or nbits < 0):
        raise ValueError(f"viterbi_traceback_words_cuda: bad words "
                         f"{words.dtype} {tuple(words.shape)} / last "
                         f"{last.dtype} {tuple(last.shape)} for nbits={nbits}")
    B = words.shape[2]
    dec = words.permute(2, 0, 1).contiguous()    # a view of K3's output
    last = last.contiguous()
    bits = torch.empty((B, nbits), dtype=torch.int32, device=words.device)
    if B == 0 or nbits == 0:
        return bits
    lib = _build.load_library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_viterbi_traceback_words(
            dec.data_ptr(), last.data_ptr(), bits.data_ptr(), B, T2, nbits,
            stream)
        WORDS_TRACEBACK_LAUNCHES += 1
    _check(rc, "viterbi_traceback_words_cuda")
    return bits


def pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """bool [B, T, 64] decisions -> K1's decision words int32 [B, T, 2]
    (the inverse of :func:`unpack_decisions`)."""
    shifts = torch.arange(32, device=dec.device, dtype=torch.int64)
    w = (dec.reshape(dec.shape[:-1] + (2, 32)).to(torch.int64)
         << shifts).sum(dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """Decision words int32 [B, T, 2] -> bool [B, T, 64] (the layout of
    :func:`dabjax_torch.fec.viterbi.viterbi_forward_torch`)."""
    shifts = torch.arange(32, device=dec.device, dtype=torch.int32)
    bits = (dec[..., None] >> shifts) & 1                  # [B, T, 2, 32]
    return bits.reshape(dec.shape[:-1] + (64,)).to(torch.bool)

