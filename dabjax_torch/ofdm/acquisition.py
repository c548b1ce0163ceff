"""Frame acquisition: null-symbol detection and PRS time sync (torch).

Port of :mod:`dabjax.ofdm.acquisition`: a 50-sample moving-average
envelope finds the null symbol, an FFT circular correlation with the PRS
finds the start of its useful part, and an energy check corrects the
whole-T_u alias of that correlation.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dabjax.constants import DabParams
from dabjax.ofdm import tables

__all__ = ["moving_average_envelope", "find_null", "prs_correlate",
           "prs_sync", "acquire"]

_ENV_WIN = 50


def moving_average_envelope(x: torch.Tensor, win: int = _ENV_WIN
                            ) -> torch.Tensor:
    """Trailing moving average of |x| over ``win`` samples (same length)."""
    cs = torch.cumsum(torch.abs(x), dim=-1)
    div = torch.arange(win, device=x.device) + 1
    head = cs[..., :win] / div
    tail = (cs[..., win:] - cs[..., :-win]) / win
    return torch.cat([head, tail], dim=-1)


def find_null(x: torch.Tensor, p: DabParams, dip_ratio: float = 0.40,
              rise_ratio: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """First null symbol of a 1-D IQ block: ``(null_end_index, found)``,
    the index where the envelope rises again after its first dip."""
    env = moving_average_envelope(x)
    level = torch.mean(torch.abs(x))
    below = env < dip_ratio * level
    above = env > rise_ratio * level
    dip_idx = torch.argmax(below.to(torch.uint8))         # first dip
    after = torch.arange(env.shape[-1], device=x.device) > dip_idx
    rise = above & after
    rise_idx = torch.argmax(rise.to(torch.uint8))         # first rise after
    return rise_idx, below[dip_idx] & rise[rise_idx]


@functools.lru_cache(maxsize=None)
def _prs_ref(mode: int, T_u: int, K: int, device: torch.device
             ) -> torch.Tensor:
    ref = np.conj(np.fft.fft(np.fft.ifft(tables.phase_ref_bins(mode, T_u, K))))
    return torch.as_tensor(ref.astype(np.complex64), device=device)


def prs_correlate(windows: torch.Tensor, p: DabParams) -> torch.Tensor:
    """|circular correlation| of T_u windows [..., T_u] with the PRS; the
    argmax is the PRS useful start within the window."""
    spec = torch.fft.fft(windows, dim=-1)
    ref = _prs_ref(p.mode, p.T_u, p.K, windows.device)
    return torch.abs(torch.fft.ifft(spec * ref, dim=-1))


def prs_sync(windows: torch.Tensor, p: DabParams, threshold: float = 3.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PRS start per window and whether the peak clears ``threshold``
    times the mean (phasereference.cpp:84-87): ``(int32, bool)``."""
    imp = prs_correlate(windows, p)
    idx = torch.argmax(imp, dim=-1)                       # first maximum
    mx = torch.amax(imp, dim=-1)
    mean = torch.mean(imp, dim=-1)
    return idx.to(torch.int32), mx >= threshold * mean


def acquire(x: np.ndarray, p: DabParams, threshold: float = 3.0, *,
            device) -> Optional[int]:
    """Index in the host buffer ``x`` of the first PRS useful-part start,
    or None.  Null detection and the PRS correlation run on ``device``."""
    need = p.T_F + p.T_null + p.T_u
    if x.shape[-1] < need:
        return None
    xb = torch.as_tensor(np.ascontiguousarray(x[:need], np.complex64),
                         device=device)
    null_end, found = find_null(xb, p)
    if not bool(found):
        return None
    base = max(int(null_end) - _ENV_WIN, 0)
    win = torch.as_tensor(
        np.ascontiguousarray(x[base: base + p.T_u], np.complex64),
        device=device)
    start, ok = prs_sync(win[None, :], p, threshold)
    if not bool(ok[0]):
        return None
    u0 = base + int(start[0])
    # the correlation is blind to whole-T_u shifts: an aliased window lies
    # mostly inside the null, the true one carries full PRS power
    while x.shape[-1] >= u0 + 2 * p.T_u:
        e_here = float(np.mean(np.abs(x[u0: u0 + p.T_u]) ** 2))
        e_next = float(np.mean(np.abs(x[u0 + p.T_u: u0 + 2 * p.T_u]) ** 2))
        if e_here >= 0.5 * e_next:
            break
        u0 += p.T_u
    return u0
