"""Batched OFDM demodulation: frame-aligned IQ -> DQPSK soft bits (torch).

Port of :mod:`dabjax.ofdm.demod`.  Spectra come from ``torch.fft.fft``
plus the frequency de-interleave gather over
:func:`dabjax_torch.ofdm.tables.carrier_bins`, on every device (the form of
dabjax's ``_demod_spectra_fft``).  Inputs are complex64 tensors
``[F, >= min_frame_samples(p)]`` whose rows start at the PRS useful part;
:func:`demodulate_rows` also takes the block graph's uint8 or float32
(re, im) pairs.

On a CUDA tensor the fine CFO, the demod around the FFT and the coarse
CFO run as the kernels of :mod:`dabjax_torch.ofdm.demod_cuda`; on any
other device as the plain versions here (``*_torch``), which are
dabjax's chain.  Given the same CFO both give the same soft bits and
spectra, bit for bit; the coarse CFO the same offsets but where the
filter's best two scores lie within float32 rounding of each other.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dabjax_torch.constants import CIF_BITS, DabParams
from dabjax_torch.msc.cif import cifs_from_soft
from dabjax_torch.ofdm import demod_cuda, tables

__all__ = ["min_frame_samples", "frame_window_index", "demodulate_frames",
           "demodulate_frames_cfo", "demodulate_frames_cfo_torch",
           "mix_windows_torch", "dqpsk_soft_torch",
           "snr_estimate", "fine_cfo_estimate", "fine_cfo_estimate_torch",
           "coarse_cfo_estimate", "coarse_cfo_estimate_torch", "apply_cfo",
           "KINDS", "Demodulated", "check_rows", "complex_rows",
           "demodulate_rows", "demodulate_rows_torch"]

FS = 2_048_000.0

#: row kinds: uint8 (re, im) pairs ``[F, n, 2]``, float32 pairs
#: ``[F, n, 2]``, complex64 ``[F, n]``
KINDS = ("u8", "f32", "c64")
_LAYOUT = {"u8": (torch.uint8, 3), "f32": (torch.float32, 3),
           "c64": (torch.complex64, 2)}


@functools.lru_cache(maxsize=None)
def frame_window_index(T_s: int, T_u: int, L: int) -> np.ndarray:
    """(L, T_u) sample indices of each symbol's FFT window, relative to
    the PRS useful start (symbol l's useful part begins at l*T_s)."""
    return np.arange(L)[:, None] * T_s + np.arange(T_u)[None, :]


def min_frame_samples(p: DabParams) -> int:
    """Samples needed per frame row for demodulation."""
    return (p.L - 1) * p.T_s + p.T_u


@functools.lru_cache(maxsize=None)
def _carrier_index(mode: int, T_u: int, K: int, device: torch.device
                   ) -> torch.Tensor:
    cb = tables.carrier_bins(mode, T_u, K).astype(np.int64)
    return torch.as_tensor(cb, device=device)


def demodulate_frames(samples: torch.Tensor, p: DabParams
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Demodulate frame-aligned IQ with no CFO mix.  Returns ``(soft
    [F, L-1, 2K] float32 in -127..127, spectra0 [F, T_u] complex64)``."""
    zero = torch.zeros(samples.shape[0], device=samples.device)
    return demodulate_frames_cfo(samples, zero, p)


def demodulate_frames_cfo(samples: torch.Tensor, cfo_hz: torch.Tensor,
                          p: DabParams, fs: float = FS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Demodulate unrotated frame rows with the CFO mix folded in: a
    per-frame ramp e^{-jwt} over each FFT window, and the per-symbol
    constant e^{-jwT_s} applied once to the DQPSK product (see dabjax's
    docstring for the algebra).  ``cfo_hz``: [F] total CFO in Hz.
    Returns ``(soft [F, L-1, 2K] float32 in -127..127, spectra0 [F, T_u]
    complex64)``."""
    if samples.is_cuda:
        cfo = cfo_hz.to(torch.float32)            # as the plain version
        soft = torch.empty((samples.shape[0], p.L - 1, 2 * p.K),
                           dtype=torch.float32, device=samples.device)
        spec = _demod_into(samples, cfo, p, "c64", fs,
                           soft[:, : p.fic_symbols], soft[:, p.fic_symbols:])
        return soft, spec[:, 0, :]
    return demodulate_frames_cfo_torch(samples, cfo_hz, p, fs)


def demodulate_frames_cfo_torch(samples: torch.Tensor, cfo_hz: torch.Tensor,
                                p: DabParams, fs: float = FS
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`demodulate_frames_cfo`, on any device."""
    cfo = cfo_hz.to(torch.float32)
    spec = torch.fft.fft(mix_windows_torch(samples, cfo, p, fs), dim=-1)
    return dqpsk_soft_torch(spec, cfo, p, fs), spec[:, 0, :]


def mix_windows_torch(samples: torch.Tensor, cfo: torch.Tensor,
                      p: DabParams, fs: float = FS) -> torch.Tensor:
    """complex64 [F, L, T_u]: symbol l's window of complex64 rows times
    the frame's ramp e^{-jwt} (``cfo``: [F] float32 Hz); the plain
    version of ``demod_cuda.mix_windows``."""
    T_s, T_u, L = p.T_s, p.T_u, p.L
    n = (L - 1) * T_s + T_u
    win = samples[:, :n].unfold(-1, T_u, T_s)            # [F, L, T_u]
    wr, wi = win.real, win.imag
    t = torch.arange(T_u, dtype=torch.float32, device=samples.device)
    ang = (-2.0 * math.pi / fs) * cfo[:, None] * t
    cr, ci = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    return torch.complex(wr * cr - wi * ci, wr * ci + wi * cr)


def dqpsk_soft_torch(spec: torch.Tensor, cfo: torch.Tensor, p: DabParams,
                     fs: float = FS) -> torch.Tensor:
    """float32 [F, L-1, 2K] in -127..127: the soft bits of spectra ``spec``
    [F, L, T_u] mixed with ``cfo`` ([F] float32 Hz); the plain version of
    ``demod_cuda.dqpsk_soft``."""
    cb = _carrier_index(p.mode, p.T_u, p.K, spec.device)
    sre = spec.real.index_select(-1, cb)                  # [F, L, K]
    sim = spec.imag.index_select(-1, cb)
    # r1 = F_l * conj(F_{l-1}) per active carrier
    r1re = sre[:, 1:] * sre[:, :-1] + sim[:, 1:] * sim[:, :-1]
    r1im = sim[:, 1:] * sre[:, :-1] - sre[:, 1:] * sim[:, :-1]
    pang = ((-2.0 * math.pi / fs) * cfo * p.T_s)[:, None, None]
    pr, pi_ = torch.cos(pang), torch.sin(pang)
    r1re, r1im = r1re * pr - r1im * pi_, r1re * pi_ + r1im * pr
    # 1e-38 is subnormal in float32: this op must not run flushed to zero,
    # or an all-zero input gives rsqrt(0) = inf and NaN soft bits
    inv = torch.rsqrt(r1re * r1re + r1im * r1im + 1e-38)
    soft = torch.cat([-r1re * inv * 127.0, -r1im * inv * 127.0], dim=-1)
    # torch.round is half-to-even, like jnp.round
    return torch.round(soft)


def snr_estimate(spectrum0: torch.Tensor, p: DabParams) -> torch.Tensor:
    """Per-frame SNR (dB) from the PRS spectrum (ofdm-decoder.cpp:212-230)."""
    T_u, K = p.T_u, p.K
    v = torch.abs(torch.roll(spectrum0, T_u // 2, dims=-1))
    low = T_u // 2 - K // 2
    high = low + K
    sig = torch.mean(v[..., T_u // 2 - K // 4: T_u // 2 + K // 4], dim=-1)
    noise = (torch.sum(v[..., 10: low - 20], dim=-1)
             + torch.sum(v[..., high + 20: T_u - 10], dim=-1))
    noise = noise / (low - 30 + T_u - high - 30)

    def db(x):
        return 20.0 * torch.log10((x + 1.0) / 256.0)

    return db(sig) - db(noise)


def fine_cfo_estimate(samples: torch.Tensor, p: DabParams) -> torch.Tensor:
    """Per-frame fine CFO (Hz) from the guard-interval correlation summed
    over every data symbol (ofdm-processor.cpp:424-425,445-446)."""
    if samples.is_cuda:
        return demod_cuda.guard_corr(samples, p, "c64")[0]
    return fine_cfo_estimate_torch(samples, p)


def fine_cfo_estimate_torch(samples: torch.Tensor, p: DabParams
                            ) -> torch.Tensor:
    """The plain version of :func:`fine_cfo_estimate`, on any device."""
    T_s, T_u, T_g, L = p.T_s, p.T_u, p.T_g, p.L
    # guard of symbol l (l >= 1) is [l*T_s - T_g, l*T_s); it repeats the
    # end of the useful part, T_u samples later
    g = samples[:, T_s - T_g: L * T_s - T_g].unfold(-1, T_g, T_s)
    ref = samples[:, T_s - T_g + T_u: L * T_s - T_g + T_u].unfold(
        -1, T_g, T_s)                                       # [F, L-1, T_g]
    corr = torch.sum(g * torch.conj(ref), dim=(-2, -1))
    return -torch.angle(corr) / math.pi * (p.carrier_diff / 2.0)


@functools.lru_cache(maxsize=None)
def _coarse_ref(mode: int, T_u: int, K: int, device: torch.device
                ) -> torch.Tensor:
    """complex64 [K]: the PRS reference's differential products over the
    band of the K carriers from ``T_u / 2 - K / 2`` of the rolled
    spectrum."""
    ref_c = np.roll(tables.phase_ref_bins(mode, T_u, K), T_u // 2)
    d_ref = ref_c[:-1] * np.conj(ref_c[1:])
    lo = T_u // 2 - K // 2
    return torch.as_tensor(d_ref[lo: lo + K].astype(np.complex64),
                           device=device)


@functools.lru_cache(maxsize=None)
def _coarse_index(T_u: int, K: int, search: int, device: torch.device
                  ) -> torch.Tensor:
    """int64 [2 search + 1, K]: the product each shift's candidate reads
    at each carrier."""
    lo = T_u // 2 - K // 2
    shift_idx = (np.arange(-search, search + 1)[:, None]
                 + lo + np.arange(K)[None, :])
    # where the search passes the band edge (Mode III: T_u = 256 leaves
    # fewer than 35 spare bins), read the edge product, as dabjax's
    # clamped gather does
    shift_idx = np.clip(shift_idx, 0, T_u - 2)
    return torch.as_tensor(shift_idx.astype(np.int64), device=device)


def coarse_cfo_estimate(spectrum0: torch.Tensor, p: DabParams,
                        search: int = 35) -> torch.Tensor:
    """Integer-carrier CFO from the PRS spectrum, +-``search`` carriers:
    the differential-coherent matched filter of dabjax.  Returns int32 [F]
    carrier offsets (the spectrum sits ``offset`` carriers too high).  On
    a CUDA tensor one kernel (``demod_cuda.coarse_cfo``)."""
    if spectrum0.is_cuda:
        return demod_cuda.coarse_cfo(spectrum0, p, search)
    return coarse_cfo_estimate_torch(spectrum0, p, search)


def coarse_cfo_estimate_torch(spectrum0: torch.Tensor, p: DabParams,
                              search: int = 35) -> torch.Tensor:
    """The plain version of :func:`coarse_cfo_estimate`, on any device."""
    T_u = p.T_u
    d_ref_band = _coarse_ref(p.mode, T_u, p.K, spectrum0.device)
    shift_idx = _coarse_index(T_u, p.K, search, spectrum0.device)
    spec_c = torch.roll(spectrum0, T_u // 2, dims=-1)
    d_rx = spec_c[..., :-1] * torch.conj(spec_c[..., 1:])
    cand = d_rx[..., shift_idx]                      # [..., 2*search+1, K]
    score = torch.abs(torch.sum(cand * torch.conj(d_ref_band), dim=-1))
    best = torch.argmax(score, dim=-1)                # first maximum
    return (best - search).to(torch.int32)


def apply_cfo(samples: torch.Tensor, cfo_hz: torch.Tensor,
              fs: float = FS, t0: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Mix frames down by a per-frame CFO (the batched NCO)."""
    n = torch.arange(samples.shape[-1], device=samples.device)
    if t0 is not None:
        n = n + t0[..., None]
    ph = -2j * math.pi * cfo_hz[..., None] * n / fs
    return samples * torch.exp(ph)


class Demodulated(NamedTuple):
    """The demod of a shard of frame rows."""
    fine: torch.Tensor     # [F] float32 fine CFO, Hz
    cfo: torch.Tensor      # [F] float32 fine + coarse CFO, Hz
    fic: torch.Tensor      # [F, fic_symbols, 2K] float32 soft bits
    cifs: torch.Tensor     # [F * cifs_per_frame, CIF_BITS] float32 soft bits
    spec0: torch.Tensor    # [F, T_u] complex64 PRS spectrum


def check_rows(rows: torch.Tensor, p: DabParams, kind: str) -> None:
    """Raise unless ``rows`` are frame rows of ``kind`` for mode ``p``
    (any device); on a CUDA card also unless each row's samples are
    contiguous and there are at most 65535 frames (a grid axis)."""
    if kind not in _LAYOUT:
        raise ValueError(f"unknown row kind {kind!r}; one of {KINDS}")
    dtype, ndim = _LAYOUT[kind]
    need = min_frame_samples(p)
    if (rows.dtype != dtype or rows.dim() != ndim
            or (ndim == 3 and rows.shape[2] != 2)
            or rows.shape[0] < 1 or rows.shape[1] < need):
        raise ValueError(
            f"{kind} rows: need {dtype} [F >= 1, >= {need}"
            f"{', 2' if ndim == 3 else ''}], got {rows.dtype} "
            f"{tuple(rows.shape)}")
    if rows.is_cuda:
        inner = (1,) if ndim == 2 else (2, 1)
        if (rows.stride()[1:] != inner or rows.stride(0) % inner[0]
                or rows.shape[0] > 65535):
            raise ValueError(f"{kind} rows on {rows.device}: a row's samples "
                             f"must be contiguous and F <= 65535, got strides"
                             f" {rows.stride()} for {tuple(rows.shape)}")


def complex_rows(rows: torch.Tensor, kind: str) -> torch.Tensor:
    """Rows of a kind of :data:`KINDS` as complex64: uint8 pairs by the
    classic (x-128)/128 conversion (exact, so bit-identical to the
    host's), float32 pairs as they are."""
    if kind == "c64":
        return rows
    x = rows.to(torch.float32)
    if kind == "u8":
        x = (x - 128.0) * (1.0 / 128.0)
    return torch.view_as_complex(x.contiguous())


def _demod_into(rows: torch.Tensor, cfo: torch.Tensor, p: DabParams,
                kind: str, fs: float, fic_out: torch.Tensor,
                msc_out: torch.Tensor) -> torch.Tensor:
    """The kernels' demod of CUDA rows with the total CFO ``cfo``: the
    soft bits written into ``fic_out`` and ``msc_out`` (see
    ``demod_cuda.dqpsk_soft``); returns the spectra [F, L, T_u]."""
    spec = torch.fft.fft(demod_cuda.mix_windows(rows, cfo, p, kind, fs),
                         dim=-1)
    demod_cuda.dqpsk_soft(spec, cfo, p, fs, fic_out, msc_out)
    return spec


def demodulate_rows(rows: torch.Tensor, coarse_hz: torch.Tensor,
                    p: DabParams, kind: str, fs: float = FS) -> Demodulated:
    """The block graph's demod of frame rows of ``kind`` (see
    :func:`check_rows`) with a coarse CFO ``coarse_hz`` [F] float32 Hz:
    the fine CFO, the total CFO, the FIC soft bits [F, fic_symbols, 2K],
    the CIF block [F * cifs_per_frame, CIF_BITS] (every MSC symbol's soft
    bits, contiguous) and the PRS spectrum [F, T_u] (on a CUDA card a
    view of the FFT's output)."""
    if rows.is_cuda:
        fine, cfo = demod_cuda.guard_corr(rows, p, kind, coarse_hz)
        F, n_sym = rows.shape[0], 2 * p.K
        fic = torch.empty((F, p.fic_symbols, n_sym), dtype=torch.float32,
                          device=rows.device)
        cifs = torch.empty((F * p.cifs_per_frame, CIF_BITS),
                           dtype=torch.float32, device=rows.device)
        spec = _demod_into(rows, cfo, p, kind, fs, fic,
                           cifs.view(F, -1, n_sym))
        return Demodulated(fine, cfo, fic, cifs, spec[:, 0, :])
    check_rows(rows, p, kind)
    return demodulate_rows_torch(rows, coarse_hz, p, kind, fs)


def demodulate_rows_torch(rows: torch.Tensor, coarse_hz: torch.Tensor,
                          p: DabParams, kind: str, fs: float = FS
                          ) -> Demodulated:
    """The plain version of :func:`demodulate_rows`, on any device."""
    x = complex_rows(rows, kind)
    # the coarse CFO is a whole number of carrier spacings, a multiple
    # of 2*pi in the guard-correlation angle, so the fine estimate on
    # the unrotated rows is unaffected and one rotation serves both
    fine = fine_cfo_estimate_torch(x, p)
    cfo = fine + coarse_hz
    soft, spec0 = demodulate_frames_cfo_torch(x, cfo, p, fs)
    return Demodulated(fine, cfo, soft[:, : p.fic_symbols, :],
                       cifs_from_soft(soft, p), spec0)
