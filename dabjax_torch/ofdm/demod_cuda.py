"""ctypes wrappers over the CUDA demod kernels (``csrc/demod.cu``).

The demod of frame rows on a CUDA card is three kernels around one
``torch.fft.fft`` call:

* ``guard_corr``: the fine CFO of each frame from the guard-interval
  correlation, read straight from the rows, and with a coarse CFO the
  total CFO (``fine + coarse``);
* ``mix_windows``: each symbol's FFT window mixed down by its frame's
  CFO ramp, written as complex64 ``[F, L, T_u]`` for cuFFT;
* ``dqpsk_soft``: the DQPSK soft bits of the active carriers, written
  straight into the FIC tensor and the CIF block (or one
  ``[F, L-1, 2K]`` tensor).

Rows are frame rows of a kind of :data:`dabjax_torch.ofdm.demod.KINDS`
(held to :func:`dabjax_torch.ofdm.demod.check_rows`).  Given the same CFO
the soft bits and the spectra are bit-identical to the plain versions in
:mod:`dabjax_torch.ofdm.demod` (``*_torch``); the fine CFO is summed in
double, in a fixed order.  :mod:`dabjax_torch.ofdm.demod` chains the
three around the FFT.

The wrappers take CUDA tensors only and raise on anything else, on a
failed build and on a failed launch; there is no fallback.  Each adds
one to its launch count where it launches its kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from dabjax_torch import _build
from dabjax_torch.constants import DabParams
# demod imports this module too; only its functions are read, at call time
from dabjax_torch.ofdm import demod, tables

__all__ = ["guard_corr", "mix_windows", "dqpsk_soft", "reset_launches"]

#: launches of guard_corr since the last reset
GUARD_LAUNCHES = 0
#: launches of mix_windows since the last reset
MIX_LAUNCHES = 0
#: launches of dqpsk_soft since the last reset
SOFT_LAUNCHES = 0


def reset_launches() -> None:
    global GUARD_LAUNCHES, MIX_LAUNCHES, SOFT_LAUNCHES
    GUARD_LAUNCHES = 0
    MIX_LAUNCHES = 0
    SOFT_LAUNCHES = 0


def _cuda_rows(rows: torch.Tensor, p: DabParams, kind: str) -> int:
    """Check CUDA rows; their row stride in samples."""
    if not rows.is_cuda:
        raise ValueError(f"demod_cuda: CUDA tensor required, got "
                         f"{rows.device}")
    demod.check_rows(rows, p, kind)
    return rows.stride(0) // (1 if kind == "c64" else 2)


def _cfo_like(cfo: torch.Tensor, rows: torch.Tensor, name: str) -> None:
    if (cfo.device != rows.device or cfo.dtype != torch.float32
            or tuple(cfo.shape) != (rows.shape[0],)
            or not cfo.is_contiguous()):
        raise ValueError(f"{name}: need contiguous float32 [{rows.shape[0]}]"
                         f" on {rows.device}, got {cfo.dtype} "
                         f"{tuple(cfo.shape)} on {cfo.device}")


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _bins(mode: int, T_u: int, K: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tables.carrier_bins(mode, T_u, K)).to(device)


def _w(fs: float) -> float:
    """The ramp's radians a sample a Hz, -2 pi / fs (rounded to float32
    by ctypes, as ATen rounds the Python scalar of the plain path)."""
    return -2.0 * math.pi / fs


def guard_corr(rows: torch.Tensor, p: DabParams, kind: str,
               coarse_hz: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(fine [F], cfo [F])`` float32 Hz: the fine CFO of each frame, and
    ``fine + coarse_hz`` (None without ``coarse_hz``)."""
    global GUARD_LAUNCHES
    stride = _cuda_rows(rows, p, kind)
    F = rows.shape[0]
    if coarse_hz is not None:
        _cfo_like(coarse_hz, rows, "guard_corr coarse_hz")
    fine = torch.empty(F, dtype=torch.float32, device=rows.device)
    cfo = None if coarse_hz is None else torch.empty_like(fine)
    lib = _build.load_library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_demod_guard_corr(
            rows.data_ptr(), kind == "u8", stride, F, p.T_s, p.T_u, p.T_g,
            p.L, p.carrier_diff / 2.0,
            None if coarse_hz is None else coarse_hz.data_ptr(),
            fine.data_ptr(), None if cfo is None else cfo.data_ptr(), stream)
        GUARD_LAUNCHES += 1
    _check(rc, "guard_corr")
    return fine, cfo


def mix_windows(rows: torch.Tensor, cfo: torch.Tensor, p: DabParams,
                kind: str, fs: float) -> torch.Tensor:
    """complex64 [F, L, T_u]: symbol l's window ``x[l T_s : l T_s + T_u]``
    times the frame's ramp ``e^{-j 2 pi cfo t / fs}``."""
    global MIX_LAUNCHES
    stride = _cuda_rows(rows, p, kind)
    _cfo_like(cfo, rows, "mix_windows cfo")
    F = rows.shape[0]
    out = torch.empty((F, p.L, p.T_u), dtype=torch.complex64,
                      device=rows.device)
    lib = _build.load_library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_demod_mix_windows(
            rows.data_ptr(), kind == "u8", stride, F, p.T_s, p.T_u, p.L,
            _w(fs), cfo.data_ptr(), out.data_ptr(), stream)
        MIX_LAUNCHES += 1
    _check(rc, "mix_windows")
    return out


def dqpsk_soft(spec: torch.Tensor, cfo: torch.Tensor, p: DabParams,
               fs: float, fic_out: torch.Tensor, msc_out: torch.Tensor
               ) -> None:
    """The soft bits of spectra ``spec`` (complex64 [F, L, T_u]) written
    into float32 views: data symbols s < fic_symbols into ``fic_out``
    [F, fic_symbols, 2K], the others into ``msc_out``
    [F, L-1-fic_symbols, 2K]; each view's symbols contiguous, its frames
    at any stride."""
    global SOFT_LAUNCHES
    F, n_sym = spec.shape[0], 2 * p.K
    if (not spec.is_cuda or spec.dtype != torch.complex64
            or tuple(spec.shape) != (F, p.L, p.T_u)
            or not spec.is_contiguous()):
        raise ValueError(f"dqpsk_soft: need a contiguous CUDA complex64 "
                         f"[F, {p.L}, {p.T_u}], got {spec.dtype} "
                         f"{tuple(spec.shape)} on {spec.device}")
    _cfo_like(cfo, spec, "dqpsk_soft cfo")
    for t, S in ((fic_out, p.fic_symbols), (msc_out, p.L - 1 - p.fic_symbols)):
        if (t.device != spec.device or t.dtype != torch.float32
                or tuple(t.shape) != (F, S, n_sym)
                or t.stride()[1:] != (n_sym, 1)):
            raise ValueError(f"dqpsk_soft: need float32 [{F}, {S}, {n_sym}] "
                             f"with contiguous symbols on {spec.device}, got "
                             f"{t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}")
    lib = _build.load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_demod_dqpsk_soft(
            spec.data_ptr(), _bins(p.mode, p.T_u, p.K, spec.device).data_ptr(),
            F, p.T_s, p.T_u, p.L, p.K, p.fic_symbols, _w(fs), cfo.data_ptr(),
            fic_out.data_ptr(), fic_out.stride(0), msc_out.data_ptr(),
            msc_out.stride(0), stream)
        SOFT_LAUNCHES += 1
    _check(rc, "dqpsk_soft")
