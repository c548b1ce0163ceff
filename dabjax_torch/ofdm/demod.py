"""Batched OFDM demodulation: frame-aligned IQ -> DQPSK soft bits (torch).

Port of :mod:`dabjax.ofdm.demod`.  Spectra come from ``torch.fft.fft``
plus the frequency de-interleave gather over dabjax's
:func:`dabjax.ofdm.tables.carrier_bins`, on every device (the form of
dabjax's ``_demod_spectra_fft``).  Inputs are complex64 tensors
``[F, >= min_frame_samples(p)]`` whose rows start at the PRS useful part.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from dabjax.constants import DabParams
from dabjax.ofdm import tables

__all__ = ["min_frame_samples", "frame_window_index", "demodulate_frames",
           "demodulate_frames_cfo", "snr_estimate", "fine_cfo_estimate",
           "coarse_cfo_estimate", "apply_cfo"]

FS = 2_048_000.0


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
    docstring for the algebra).  ``cfo_hz``: [F] total CFO in Hz."""
    T_s, T_u, L, K = p.T_s, p.T_u, p.L, p.K
    n = (L - 1) * T_s + T_u
    win = samples[:, :n].unfold(-1, T_u, T_s)            # [F, L, T_u]
    wr, wi = win.real, win.imag
    t = torch.arange(T_u, dtype=torch.float32, device=samples.device)
    cfo = cfo_hz.to(torch.float32)
    ang = (-2.0 * math.pi / fs) * cfo[:, None] * t
    cr, ci = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    wr, wi = wr * cr - wi * ci, wr * ci + wi * cr
    spec = torch.fft.fft(torch.complex(wr, wi), dim=-1)
    cb = _carrier_index(p.mode, T_u, K, samples.device)
    sre = spec.real.index_select(-1, cb)                  # [F, L, K]
    sim = spec.imag.index_select(-1, cb)
    # r1 = F_l * conj(F_{l-1}) per active carrier
    r1re = sre[:, 1:] * sre[:, :-1] + sim[:, 1:] * sim[:, :-1]
    r1im = sim[:, 1:] * sre[:, :-1] - sre[:, 1:] * sim[:, :-1]
    pang = ((-2.0 * math.pi / fs) * cfo * T_s)[:, None, None]
    pr, pi_ = torch.cos(pang), torch.sin(pang)
    r1re, r1im = r1re * pr - r1im * pi_, r1re * pi_ + r1im * pr
    # 1e-38 is subnormal in float32: this op must not run flushed to zero,
    # or an all-zero input gives rsqrt(0) = inf and NaN soft bits
    inv = torch.rsqrt(r1re * r1re + r1im * r1im + 1e-38)
    soft = torch.cat([-r1re * inv * 127.0, -r1im * inv * 127.0], dim=-1)
    # torch.round is half-to-even, like jnp.round
    return torch.round(soft), spec[:, 0, :]


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
    T_s, T_u, T_g, L = p.T_s, p.T_u, p.T_g, p.L
    # guard of symbol l (l >= 1) is [l*T_s - T_g, l*T_s); it repeats the
    # end of the useful part, T_u samples later
    g = samples[:, T_s - T_g: L * T_s - T_g].unfold(-1, T_g, T_s)
    ref = samples[:, T_s - T_g + T_u: L * T_s - T_g + T_u].unfold(
        -1, T_g, T_s)                                       # [F, L-1, T_g]
    corr = torch.sum(g * torch.conj(ref), dim=(-2, -1))
    return -torch.angle(corr) / math.pi * (p.carrier_diff / 2.0)


@functools.lru_cache(maxsize=None)
def _coarse_tables(mode: int, T_u: int, K: int, search: int,
                   device: torch.device):
    ref = tables.phase_ref_bins(mode, T_u, K)
    ref_c = np.roll(ref, T_u // 2)
    d_ref = ref_c[:-1] * np.conj(ref_c[1:])
    lo = T_u // 2 - K // 2
    d_ref_band = d_ref[lo: lo + K].astype(np.complex64)
    shift_idx = (np.arange(-search, search + 1)[:, None]
                 + lo + np.arange(K)[None, :])
    # where the search passes the band edge (Mode III: T_u = 256 leaves
    # fewer than 35 spare bins), read the edge product, as dabjax's
    # clamped gather does
    shift_idx = np.clip(shift_idx, 0, T_u - 2)
    return (torch.as_tensor(d_ref_band, device=device),
            torch.as_tensor(shift_idx.astype(np.int64), device=device))


def coarse_cfo_estimate(spectrum0: torch.Tensor, p: DabParams,
                        search: int = 35) -> torch.Tensor:
    """Integer-carrier CFO from the PRS spectrum, +-``search`` carriers:
    the differential-coherent matched filter of dabjax.  Returns int32 [F]
    carrier offsets (the spectrum sits ``offset`` carriers too high)."""
    T_u, K = p.T_u, p.K
    d_ref_band, shift_idx = _coarse_tables(p.mode, T_u, K, search,
                                           spectrum0.device)
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
