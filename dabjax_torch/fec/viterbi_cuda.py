"""ctypes wrappers over the CUDA Viterbi kernels (``csrc/viterbi.cu``).

* forward ACS (K1) replaces ``_forward_kernel_lane`` of
  ``dabjax/fec/viterbi_pallas.py``: soft int8 [B, T, 4] -> decision words
  int32 [B, T, 2] (bit s of word s // 32 is state s's decision);
* traceback (K2) replaces ``_traceback_kernel`` and the unpack epilogue
  of ``viterbi_decode_pallas``: decision words -> bits int32 [B, nbits].

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

__all__ = ["viterbi_decode_cuda", "viterbi_forward_cuda",
           "viterbi_traceback_cuda", "reset_launches", "unpack_decisions"]

#: launches of the forward ACS kernel (K1) since the last reset
FORWARD_LAUNCHES = 0
#: launches of the traceback kernel (K2) since the last reset
TRACEBACK_LAUNCHES = 0


def reset_launches() -> None:
    global FORWARD_LAUNCHES, TRACEBACK_LAUNCHES
    FORWARD_LAUNCHES = 0
    TRACEBACK_LAUNCHES = 0


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


def unpack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """Decision words int32 [B, T, 2] -> bool [B, T, 64] (the layout of
    :func:`dabjax_torch.fec.viterbi.viterbi_forward_torch`)."""
    shifts = torch.arange(32, device=dec.device, dtype=torch.int32)
    bits = (dec[..., None] >> shifts) & 1                  # [B, T, 2, 32]
    return bits.reshape(dec.shape[:-1] + (64,)).to(torch.bool)


def viterbi_decode_cuda(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) integer-valued, on a CUDA device ->
    (..., nbits) int32.  Values are clipped to +-127 and cast to int8, as
    ``viterbi_forward_words`` does (identity inside the contract)."""
    if not soft.is_cuda:
        raise ValueError(f"viterbi_decode_cuda: CUDA tensor required, "
                         f"got {soft.device}")
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    lead = tuple(soft.shape[:-1])
    s8 = soft.reshape(-1, T, 4).clamp(-127, 127).to(torch.int8).contiguous()
    bits = viterbi_traceback_cuda(viterbi_forward_cuda(s8), nbits)
    return bits.reshape(lead + (nbits,))
