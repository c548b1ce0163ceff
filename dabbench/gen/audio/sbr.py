"""SBR (Spectral Band Replication) decoder — the HE-AAC half of DAB+.

The reference decodes HE-AAC through libfaad (``reference/includes/
backend/audio/faad-decoder.h:78-165`` builds the ASC with sbrFlag and lets
NeAACDec reconstruct the upper band); dabjax implements the SBR tool itself
(ISO/IEC 14496-3 §4.6.18) on the host control plane, mirroring the AAC-LC
core (dabjax_torch/audio/aac_lc.py):

* sbr_extension_data bitstream parse (header, grid, dtdf, invf, envelope,
  noise, sinusoidal coding) from FIL elements;
* derived frequency band tables (f_master, high/low/noise/limiter, patches);
* 32-band analysis / 64-band synthesis QMF banks as dense matmuls;
* HF generation by LPC inverse filtering with chirp, HF adjustment
  (envelope/noise gains, limiter, boost, sinusoid + noise injection).

Both core frame lengths are supported: 1024 (lets the whole HE-AAC chain be
cross-checked against libavcodec, tests/test_sbr.py) and 960 (the DAB+
transform, 15 SBR time slots).  Normative constant tables come byte-exact
from ISO/IEC 14496-3 via ``tools/extract_sbr_tables.py``.

Scale convention: operates in the core decoder's internal 16-bit domain
(aac_lc spectra before the final /32768), where the envelope dequantization
reference level 2^(sf/2 + 6) of §4.6.18.7.1 is calibrated.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from dabbench.gen.audio import _sbr_tables as ST
from dabbench.gen.audio.aac_lc import BitReader, Huffman

__all__ = ["SbrDecoder", "FreqTables", "SbrHeader"]

FIXFIX, FIXVAR, VARFIX, VARVAR = 0, 1, 2, 3
T_HFGEN = 8        # QMF slot lookback kept for covariance + generation
T_HFADJ = 2        # envelope-adjustment offset (synthesis delay, slots)
NOISE_FLOOR_OFFSET = 6
EXT_SBR_DATA, EXT_SBR_DATA_CRC = 13, 14


def _huff(codes, bits):
    h = Huffman(codes, bits)
    h.lav = (len(bits) - 1) // 2       # symbol i decodes to i - lav
    return h


# (time, freq) Huffman pairs; noise freq deltas reuse the 3.0 dB envelope
# f-table, noise time deltas have their own books (§4.6.18.3.4).
_ENV_15 = (_huff(ST.T_HUFFMAN_ENV_15_CODES, ST.T_HUFFMAN_ENV_15_BITS),
           _huff(ST.F_HUFFMAN_ENV_15_CODES, ST.F_HUFFMAN_ENV_15_BITS))
_ENV_30 = (_huff(ST.T_HUFFMAN_ENV_30_CODES, ST.T_HUFFMAN_ENV_30_BITS),
           _huff(ST.F_HUFFMAN_ENV_30_CODES, ST.F_HUFFMAN_ENV_30_BITS))
_ENV_BAL_15 = (_huff(ST.T_HUFFMAN_ENV_BAL_15_CODES,
                     ST.T_HUFFMAN_ENV_BAL_15_BITS),
               _huff(ST.F_HUFFMAN_ENV_BAL_15_CODES,
                     ST.F_HUFFMAN_ENV_BAL_15_BITS))
_ENV_BAL_30 = (_huff(ST.T_HUFFMAN_ENV_BAL_30_CODES,
                     ST.T_HUFFMAN_ENV_BAL_30_BITS),
               _huff(ST.F_HUFFMAN_ENV_BAL_30_CODES,
                     ST.F_HUFFMAN_ENV_BAL_30_BITS))
_NOISE_30 = (_huff(ST.T_HUFFMAN_NOISE_30_CODES, ST.T_HUFFMAN_NOISE_30_BITS),
             _ENV_30[1])
_NOISE_BAL_30 = (_huff(ST.T_HUFFMAN_NOISE_BAL_30_CODES,
                       ST.T_HUFFMAN_NOISE_BAL_30_BITS),
                 _ENV_BAL_30[1])


# ------------------------------------------------------------ header


@dataclass
class SbrHeader:
    """sbr_header() fields with §4.4.2.8 defaults for the extras."""

    amp_res: int = 1
    start_freq: int = 5
    stop_freq: int = 0
    xover_band: int = 0
    freq_scale: int = 2
    alter_scale: int = 1
    noise_bands: int = 2
    limiter_bands: int = 2
    limiter_gains: int = 2
    interpol_freq: int = 1
    smoothing_mode: int = 1

    def table_key(self) -> tuple:
        """Fields whose change forces a frequency-table rebuild."""
        return (self.start_freq, self.stop_freq, self.xover_band,
                self.freq_scale, self.alter_scale, self.noise_bands)


def parse_sbr_header(br: BitReader) -> SbrHeader:
    h = SbrHeader()
    h.amp_res = br.read1()
    h.start_freq = br.read(4)
    h.stop_freq = br.read(4)
    h.xover_band = br.read(3)
    br.read(2)                                     # bs_reserved
    extra1 = br.read1()
    extra2 = br.read1()
    if extra1:
        h.freq_scale = br.read(2)
        h.alter_scale = br.read1()
        h.noise_bands = br.read(2)
    if extra2:
        h.limiter_bands = br.read(2)
        h.limiter_gains = br.read(2)
        h.interpol_freq = br.read1()
        h.smoothing_mode = br.read1()
    return h


# ------------------------------------------------- frequency band tables


def _k0_k2(h: SbrHeader, fs_sbr: int) -> Tuple[int, int]:
    """Start/stop QMF subbands k0, k2 (§4.6.18.3.2.1, Tables 4.164/4.165)."""
    base = 3000 if fs_sbr < 32000 else (4000 if fs_sbr < 64000 else 5000)
    start_min = ((base << 7) + (fs_sbr >> 1)) // fs_sbr
    stop_min = ((base << 8) + (fs_sbr >> 1)) // fs_sbr
    if fs_sbr < 22050:
        row = 0
    elif fs_sbr < 24000:
        row = 1
    elif fs_sbr < 32000:
        row = 2
    elif fs_sbr < 44100:
        row = 3
    elif fs_sbr < 64000:
        row = 4
    else:
        row = 5
    k0 = start_min + ST.SBR_OFFSET[row][h.start_freq]
    if h.stop_freq == 14:
        k2 = 2 * k0
    elif h.stop_freq == 15:
        k2 = 3 * k0
    else:
        dk = np.rint(stop_min * (64.0 / stop_min)
                     ** ((np.arange(13) + 1) / 13.0)).astype(int) \
            - np.rint(stop_min * (64.0 / stop_min)
                      ** (np.arange(13) / 13.0)).astype(int)
        dk.sort()
        k2 = stop_min + int(dk[: h.stop_freq].sum())
    k2 = min(64, k2)
    if k0 >= k2:
        raise ValueError(f"SBR k0 {k0} >= k2 {k2}")
    # §4.6.18.3.6 range constraint on (k2 - k0)
    max_bands = 48 if fs_sbr < 32000 else (35 if fs_sbr < 48000 else 32)
    if k2 - k0 > max_bands:
        raise ValueError(f"SBR range k2-k0 = {k2 - k0} > {max_bands}")
    return k0, k2


def _f_master(h: SbrHeader, k0: int, k2: int) -> np.ndarray:
    """Master frequency grid (§4.6.18.3.2.1)."""
    if h.freq_scale == 0:
        dk = 2 if h.alter_scale else 1
        n = (((k2 - k0 + (2 if dk == 2 else 0)) >> dk) << 1)
        if n <= 0:
            raise ValueError("empty master table")
        vdk = np.full(n, dk, int)
        k2_diff = k2 - k0 - n * dk
        if k2_diff < 0:
            incr, k = 1, 0
        elif k2_diff > 0:
            incr, k = -1, n - 1
        while k2_diff:
            vdk[k] -= incr
            k += incr
            k2_diff += incr
        return np.concatenate([[k0], k0 + np.cumsum(vdk)])

    bands = (12, 10, 8)[h.freq_scale - 1]
    warp = 1.3 if h.alter_scale else 1.0
    two_regions = k2 / k0 > 2.2449
    k1 = 2 * k0 if two_regions else k2
    n0 = 2 * int(np.rint(bands * np.log2(k1 / k0) / 2.0))
    if n0 <= 0:
        raise ValueError("empty master table")
    grid = np.rint(k0 * (k1 / k0) ** (np.arange(n0 + 1) / n0)).astype(int)
    vdk0 = np.sort(np.diff(grid))
    vk0 = np.concatenate([[k0], k0 + np.cumsum(vdk0)])
    if not two_regions:
        return vk0
    n1 = 2 * int(np.rint(bands * np.log2(k2 / k1) / (2.0 * warp)))
    grid = np.rint(k1 * (k2 / k1) ** (np.arange(n1 + 1) / n1)).astype(int)
    vdk1 = np.sort(np.diff(grid))
    if vdk1.size and vdk1[0] < vdk0[-1]:        # keep widths monotonic
        change = int(vdk0[-1] - vdk1[0])
        change = min(change, int(vdk1[-1] - vdk1[0]) // 2)
        vdk1[0] += change
        vdk1[-1] -= change                       # no re-sort (spec order)
    vk1 = np.concatenate([[k1], k1 + np.cumsum(vdk1)])
    return np.concatenate([vk0, vk1[1:]])


@dataclass
class FreqTables:
    """All derived SBR frequency tables for one header (§4.6.18.3.2)."""

    k0: int
    k2: int
    f_master: np.ndarray
    f_high: np.ndarray
    f_low: np.ndarray
    f_noise: np.ndarray
    f_lim: np.ndarray          # absolute subband borders
    kx: int
    m: int                     # number of HF bands
    n_high: int
    n_low: int
    n_q: int
    n_lim: int
    patch_start: List[int] = field(default_factory=list)
    patch_num: List[int] = field(default_factory=list)

    @property
    def num_patches(self) -> int:
        return len(self.patch_num)

    def n(self, freq_res: int) -> int:
        return self.n_high if freq_res else self.n_low

    def f_table(self, freq_res: int) -> np.ndarray:
        return self.f_high if freq_res else self.f_low


def _patches(f_master: np.ndarray, k0: int, kx: int, m: int,
             fs_sbr: int) -> Tuple[List[int], List[int]]:
    """Patch construction (§4.6.18.6.3 flowchart)."""
    n_master = f_master.shape[0] - 1
    msb, usb = k0, kx
    goal_sb = (2048000 + (fs_sbr >> 1)) // fs_sbr
    patch_start: List[int] = []
    patch_num: List[int] = []
    if goal_sb < kx + m:
        k = 0
        while f_master[k] < goal_sb:
            k += 1
    else:
        k = n_master
    guard = 0
    while True:
        guard += 1
        if guard > 64:
            raise ValueError("patch construction does not converge")
        # largest master border (scanning down from k) fitting below the
        # source range top k0-1+msb, adjusted for odd/even alignment
        i = k
        sb = int(f_master[i])
        odd = (sb + k0) & 1
        while sb > k0 - 1 + msb - odd:
            i -= 1
            if i < 0:
                raise ValueError("patch construction underflow")
            sb = int(f_master[i])
            odd = (sb + k0) & 1
        num = max(sb - usb, 0)
        start = k0 - odd - num
        if num > 0:
            patch_start.append(start)
            patch_num.append(num)
            usb = sb
            msb = sb
        else:
            msb = kx
        if f_master[k] - sb < 3:
            k = n_master
        if sb == kx + m:
            break
    if len(patch_num) > 1 and patch_num[-1] < 3:
        patch_start.pop()
        patch_num.pop()
    if not patch_num:
        raise ValueError("no SBR patches")
    return patch_start, patch_num


def derive_tables(h: SbrHeader, fs_sbr: int) -> FreqTables:
    k0, k2 = _k0_k2(h, fs_sbr)
    f_master = _f_master(h, k0, k2)
    if np.diff(f_master).min() <= 0:
        # zero-width master bands: the reference rejects such headers and
        # switches to pure upsampling; raising gets the same fallback
        raise ValueError("invalid master table (zero-width bands)")
    n_master = f_master.shape[0] - 1
    if h.xover_band >= n_master:
        raise ValueError(f"xover_band {h.xover_band} >= n_master {n_master}")
    f_high = f_master[h.xover_band:].copy()
    n_high = f_high.shape[0] - 1
    n_low = n_high - n_high // 2
    odd = n_high & 1
    f_low = np.array([f_high[0]] + [f_high[2 * k - odd]
                                    for k in range(1, n_low + 1)])
    kx = int(f_high[0])
    m = int(f_high[-1]) - kx
    if kx > 32 or kx + m > 64:
        raise ValueError(f"SBR range kx={kx} M={m} out of bounds")
    n_q = max(1, int(np.rint(h.noise_bands * np.log2(k2 / kx))))
    n_q = min(n_q, 5)
    idx = [0]
    for k in range(1, n_q + 1):
        idx.append(idx[-1] + (n_low - idx[-1]) // (n_q + 1 - k))
    f_noise = f_low[np.array(idx)]
    patch_start, patch_num = _patches(f_master, k0, kx, m, fs_sbr)
    # limiter table (§4.6.18.3.2.3)
    if h.limiter_bands == 0:
        f_lim = np.array([f_low[0], f_low[-1]])
    else:
        warped = ST.BANDS_WARPED[h.limiter_bands - 1]
        borders = [kx]
        for num in patch_num:
            borders.append(borders[-1] + num)
        table = sorted(set(f_low.tolist()) | set(borders[1:-1]))
        patch_set = set(borders)
        out = [table[0]]
        for v in table[1:]:
            if v >= out[-1] * warped:
                out.append(v)
            elif v in patch_set and out[-1] not in patch_set:
                out[-1] = v
            # else drop the closer, non-patch border
        if out[-1] != f_low[-1]:
            out.append(int(f_low[-1]))
        f_lim = np.array(out)
    return FreqTables(k0, k2, f_master, f_high, f_low, f_noise, f_lim,
                      kx, m, n_high, n_low, n_q, f_lim.shape[0] - 1,
                      patch_start, patch_num)


# --------------------------------------------------------- channel data


@dataclass
class SbrChannel:
    """One channel's sbr_data fields (decoded, dequantized lazily)."""

    frame_class: int = FIXFIX
    num_env: int = 0
    t_env: List[int] = field(default_factory=list)
    freq_res: List[int] = field(default_factory=list)
    pointer: int = 0
    num_noise: int = 0
    t_q: List[int] = field(default_factory=list)
    l_a: int = -1
    df_env: List[int] = field(default_factory=list)
    df_noise: List[int] = field(default_factory=list)
    invf: np.ndarray = field(default_factory=lambda: np.zeros(5, int))
    env_q: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    noise_q: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    add_harmonic: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    amp_res: int = 1


def _ceil_log2(n: int) -> int:
    return int(np.ceil(np.log2(n))) if n > 1 else 0


def parse_sbr_grid(br: BitReader, nts: int, ch: SbrChannel) -> None:
    """sbr_grid(): frame class, envelope/noise borders (§4.6.18.3.3)."""
    ch.frame_class = br.read(2)
    if ch.frame_class == FIXFIX:
        ch.num_env = 1 << br.read(2)
        if ch.num_env > 4:
            raise ValueError("FIXFIX bs_num_env 8 is invalid")
        f = br.read1()
        ch.freq_res = [f] * ch.num_env
        ch.pointer = 0
        ch.t_env = [int(np.floor(i * nts / ch.num_env + 0.5))
                    for i in range(ch.num_env + 1)]
    elif ch.frame_class == FIXVAR:
        var_bord_1 = br.read(2)
        ch.num_env = br.read(2) + 1
        rel = [2 * br.read(2) + 2 for _ in range(ch.num_env - 1)]
        ch.pointer = br.read(_ceil_log2(ch.num_env + 1))
        ch.freq_res = [br.read1() for _ in range(ch.num_env)][::-1]
        t = [0] * (ch.num_env + 1)
        t[ch.num_env] = nts + var_bord_1
        for i, r in enumerate(rel):
            t[ch.num_env - 1 - i] = t[ch.num_env - i] - r
        ch.t_env = t
    elif ch.frame_class == VARFIX:
        var_bord_0 = br.read(2)
        ch.num_env = br.read(2) + 1
        rel = [2 * br.read(2) + 2 for _ in range(ch.num_env - 1)]
        ch.pointer = br.read(_ceil_log2(ch.num_env + 1))
        ch.freq_res = [br.read1() for _ in range(ch.num_env)]
        t = [var_bord_0]
        for r in rel:
            t.append(t[-1] + r)
        t.append(nts)
        ch.t_env = t
    else:                                         # VARVAR
        var_bord_0 = br.read(2)
        var_bord_1 = br.read(2)
        num_rel_0 = br.read(2)
        num_rel_1 = br.read(2)
        ch.num_env = num_rel_0 + num_rel_1 + 1
        if ch.num_env > 5:
            raise ValueError("too many envelopes")
        rel0 = [2 * br.read(2) + 2 for _ in range(num_rel_0)]
        rel1 = [2 * br.read(2) + 2 for _ in range(num_rel_1)]
        ch.pointer = br.read(_ceil_log2(ch.num_env + 1))
        ch.freq_res = [br.read1() for _ in range(ch.num_env)]
        t = [0] * (ch.num_env + 1)
        t[0] = var_bord_0
        t[ch.num_env] = nts + var_bord_1
        for i, r in enumerate(rel0):
            t[i + 1] = t[i] + r
        for i, r in enumerate(rel1):
            t[ch.num_env - 1 - i] = t[ch.num_env - i] - r
        ch.t_env = t
    if ch.pointer > ch.num_env + 1:
        raise ValueError("bs_pointer out of range")
    for a, b in zip(ch.t_env, ch.t_env[1:]):
        if b <= a:
            raise ValueError(f"non-monotonic envelope borders {ch.t_env}")
    if ch.t_env[-1] > nts + 3 or ch.t_env[0] < 0 or ch.t_env[0] > 3:
        raise ValueError(f"envelope borders out of range {ch.t_env}")
    # noise floor borders (§4.6.18.3.3)
    ch.num_noise = 1 if ch.num_env == 1 else 2
    ch.t_q = [ch.t_env[0], ch.t_env[-1]]
    if ch.num_noise == 2:
        if ch.frame_class == FIXFIX:
            mid = ch.t_env[ch.num_env // 2]
        elif ch.frame_class in (FIXVAR, VARVAR):   # pointer counts from end
            mid = ch.t_env[ch.num_env - max(ch.pointer - 1, 1)]
        else:                                      # VARFIX
            if ch.pointer == 0:
                mid = ch.t_env[1]
            elif ch.pointer == 1:
                mid = ch.t_env[ch.num_env - 1]
            else:
                mid = ch.t_env[ch.pointer - 1]
        ch.t_q = [ch.t_env[0], mid, ch.t_env[-1]]
    # sinusoid start envelope l_A (§4.6.18.3.3); -1 = active from env 0
    if ch.frame_class in (FIXVAR, VARVAR):
        ch.l_a = ch.num_env + 1 - ch.pointer if ch.pointer >= 1 else -1
    elif ch.frame_class == VARFIX:
        ch.l_a = ch.pointer - 1 if ch.pointer > 1 else -1
    else:
        ch.l_a = -1


def parse_sbr_dtdf(br: BitReader, ch: SbrChannel) -> None:
    ch.df_env = [br.read1() for _ in range(ch.num_env)]
    ch.df_noise = [br.read1() for _ in range(ch.num_noise)]


def parse_sbr_invf(br: BitReader, ft: FreqTables, ch: SbrChannel) -> None:
    ch.invf = np.array([br.read(2) for _ in range(ft.n_q)], int)


def _env_books(amp_res: int, balance: bool):
    if balance:
        return (_ENV_BAL_30, 5) if amp_res else (_ENV_BAL_15, 6)
    return (_ENV_30, 6) if amp_res else (_ENV_15, 7)


def parse_sbr_envelope(br: BitReader, ft: FreqTables, ch: SbrChannel,
                       prev_env: Optional[np.ndarray],
                       prev_res: int, balance: bool) -> None:
    """Delta-decode envelope scalefactors (§4.6.18.3.4).

    ``prev_env`` is the last envelope of the previous frame at resolution
    ``prev_res`` (stored at that frame's band count).
    """
    (t_huff, f_huff), start_bits = _env_books(ch.amp_res, balance)
    delta = 2 if balance else 1
    odd = ft.n_high & 1
    rows = []
    last = prev_env
    last_res = prev_res
    for e in range(ch.num_env):
        res = ch.freq_res[e]
        nb = ft.n(res)
        row = np.zeros(nb, int)
        if ch.df_env[e]:
            if last is None:
                raise ValueError("delta-time envelope without history")
            for j in range(nb):
                if res == last_res:
                    k = min(j, last.shape[0] - 1)
                elif res:                          # cur high, prev low
                    k = (j + odd) >> 1
                else:                              # cur low, prev high
                    k = 2 * j - odd if j else 0
                k = min(max(k, 0), last.shape[0] - 1)
                row[j] = last[k] + delta * (t_huff.decode(br) - t_huff.lav)
        else:
            row[0] = delta * br.read(start_bits)
            for j in range(1, nb):
                row[j] = row[j - 1] + delta * (f_huff.decode(br)
                                               - f_huff.lav)
        maxq = 127 if delta == 1 else 255
        if row.min() < 0 or row.max() > maxq:
            raise ValueError(f"envelope scalefactor out of range {row}")
        rows.append(row)
        last, last_res = row, res
    ch.env_q = rows                                 # ragged list per env


def parse_sbr_noise(br: BitReader, ft: FreqTables, ch: SbrChannel,
                    prev_noise: Optional[np.ndarray],
                    balance: bool) -> None:
    t_huff, f_huff = _NOISE_BAL_30 if balance else _NOISE_30
    delta = 2 if balance else 1
    rows = []
    last = prev_noise
    for e in range(ch.num_noise):
        row = np.zeros(ft.n_q, int)
        if ch.df_noise[e]:
            if last is None:
                raise ValueError("delta-time noise without history")
            for j in range(ft.n_q):
                row[j] = last[j] + delta * (t_huff.decode(br) - t_huff.lav)
        else:
            row[0] = delta * br.read(5)
            for j in range(1, ft.n_q):
                row[j] = row[j - 1] + delta * (f_huff.decode(br)
                                               - f_huff.lav)
        maxq = 30 if delta == 1 else 62
        if row.min() < 0 or row.max() > maxq:
            raise ValueError(f"noise floor out of range {row}")
        rows.append(row)
        last = row
    ch.noise_q = np.stack(rows)


# ---------------------------------------------------------------- QMF


class _QmfAnalysis:
    """32-band complex analysis bank (§4.6.18.4.1) as a dense matmul.

    320-tap prototype = the 640-tap Table 4.A.90 window decimated by 2.
    """

    def __init__(self):
        self.win = ST.QMF_WINDOW[::2].copy()
        n = np.arange(64, dtype=np.float64)
        k = np.arange(32, dtype=np.float64)[:, None]
        # modulation identified to float32 exactness against libavcodec's
        # HE-AAC output by least-squares over per-band phasors (the spec's
        # flowchart constants expressed for this buffer orientation); the
        # -2 analysis / 1/64 synthesis scale split matches the reference
        # QMF-domain level so envelope energies land on the same scale
        # the e^{-j pi (k+1/2)/128} factor is the reference's half-sample
        # alignment: invisible in passthrough (synthesis compensates) but
        # load-bearing for patched HF and injected noise/sine phases
        self.mod = (2.0 * np.exp(2j * np.pi / 64.0 * (k + 0.5) * n)
                    * np.exp(-1j * np.pi * (k + 0.5) / 128.0))
        self.x = np.zeros(320)

    def run(self, samples: np.ndarray) -> np.ndarray:
        """[S*32] time samples -> [S, 32] complex subband slots.

        Vectorized over slots (one [S, 64] @ mod.T matmul instead of a
        per-slot Python loop): the per-slot window buffer holds blocks
        s, s-1, .., s-9, each internally reversed — built here as
        sliding views over the block-reversed stream + 9 blocks of
        history, with the same per-tap products and summation order."""
        s_cnt = samples.shape[0] // 32
        rev = samples.reshape(s_cnt, 32)[:, ::-1]       # [S, 32] reversed
        hist = self.x.reshape(10, 32)[:9]               # blocks s-1..s-9
        blocks = np.concatenate([hist[::-1], rev])      # time order
        idx = (len(hist) + np.arange(s_cnt)[:, None]
               - np.arange(10)[None, :])                # newest first
        xs = blocks[idx].reshape(s_cnt, 320)            # [S, 320]
        u = (xs * self.win).reshape(s_cnt, 5, 64).sum(axis=1)
        # real input x complex basis as two real GEMMs (half the flops of
        # the promoted complex GEMM)
        out = (u @ self.mod.real.T) + 1j * (u @ self.mod.imag.T)  # [S, 32]
        self.x = xs[-1] if s_cnt else self.x
        return out


class _QmfSynthesis:
    """64-band real synthesis bank (§4.6.18.4.2), 640-tap prototype."""

    def __init__(self):
        self.win = ST.QMF_WINDOW.copy()
        n = np.arange(128, dtype=np.float64)
        k = np.arange(64, dtype=np.float64)[:, None]
        # counterpart modulation to _QmfAnalysis (same identification);
        # scale and half-sample factor keep passthrough at exact unit gain
        self.mod = (np.exp(2j * np.pi / 128.0 * (k + 0.5) * n)
                    * np.exp(1j * np.pi * (k + 0.5) / 128.0))
        self.v = np.zeros(1280)

    def run(self, x_slots: np.ndarray) -> np.ndarray:
        """[S, 64] complex subband slots -> [S*64] time samples.

        Vectorized over slots: one [S, 64] @ mod matmul for the
        modulation, then the 10 window taps accumulated over sliding
        views of the modulated history (v[256j .. ] of the old per-slot
        ring buffer is row s-2j / s-2j-1 here), same product and
        accumulation order as the per-slot loop."""
        s_cnt = x_slots.shape[0]
        if not s_cnt:
            return np.empty(0)
        # Re(z @ mod) = zr @ mod.re - zi @ mod.im: two real GEMMs instead
        # of a full complex GEMM whose imaginary half is discarded
        g = (x_slots.real @ self.mod.real
             - x_slots.imag @ self.mod.imag) / -64.0    # [S, 128]
        ghist = self.v.reshape(10, 128)                 # rows s-1..s-10
        gall = np.concatenate([ghist[::-1], g])         # time order
        base = ghist.shape[0] + np.arange(s_cnt)
        acc = np.zeros((s_cnt, 64))
        for j in range(5):
            acc += gall[base - 2 * j, :64] * self.win[128 * j:
                                                      128 * j + 64]
            acc += (gall[base - 2 * j - 1, 64:]
                    * self.win[128 * j + 64: 128 * j + 128])
        # ring-buffer state: v[128k : 128k+128] = g of slot s-k
        self.v = gall[base[-1] - np.arange(10)].reshape(1280)
        return acc.reshape(s_cnt * 64)


# --------------------------------------------------------- HF generation


def _covariance(x: np.ndarray) -> tuple:
    """phi(i,j) = sum_n x[n-i]*conj(x[n-j]) over the §4.6.18.6.2 window.

    ``x``: one band's buffer [T_HFGEN + 2*nts slots]; the window runs from
    buffer slot 2 (6 slots before the current frame) to the frame end, so
    lag-2 terms reach exactly slot 0.
    """
    w = x[2:]
    w1 = x[1:-1]
    w2 = x[:-2]
    phi01 = np.vdot(w1, w)            # sum w * conj(w1)
    phi02 = np.vdot(w2, w)
    phi11 = np.vdot(w1, w1).real
    phi12 = np.vdot(w2, w1)
    phi22 = np.vdot(w2, w2).real
    return phi01, phi02, phi11, phi12, phi22


def _lpc_alphas(x: np.ndarray) -> Tuple[complex, complex]:
    """Second-order covariance LPC for one band (§4.6.18.6.2)."""
    phi01, phi02, phi11, phi12, phi22 = _covariance(x)
    d = phi22 * phi11 - (phi12 * np.conj(phi12)).real / 1.000001
    a1 = (phi01 * phi12 - phi02 * phi11) / d if d != 0.0 else 0.0
    a0 = -(phi01 + a1 * np.conj(phi12)) / phi11 if phi11 != 0.0 else 0.0
    if abs(a0) >= 4.0 or abs(a1) >= 4.0:
        return 0.0, 0.0
    return complex(a0), complex(a1)


def _lpc_alphas_batch(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batched :func:`_lpc_alphas` over band rows: [P, S] -> (a0, a1)
    complex [P], same covariance window and stability guards."""
    w = X[:, 2:]
    w1 = X[:, 1:-1]
    w2 = X[:, :-2]
    phi01 = np.einsum("ps,ps->p", np.conj(w1), w)
    phi02 = np.einsum("ps,ps->p", np.conj(w2), w)
    phi11 = np.einsum("ps,ps->p", np.conj(w1), w1).real
    phi12 = np.einsum("ps,ps->p", np.conj(w2), w1)
    phi22 = np.einsum("ps,ps->p", np.conj(w2), w2).real
    d = phi22 * phi11 - (phi12 * np.conj(phi12)).real / 1.000001
    a1 = np.where(d != 0.0,
                  (phi01 * phi12 - phi02 * phi11) / np.where(d != 0.0, d, 1.0),
                  0.0)
    a0 = np.where(phi11 != 0.0,
                  -(phi01 + a1 * np.conj(phi12))
                  / np.where(phi11 != 0.0, phi11, 1.0), 0.0)
    bad = (np.abs(a0) >= 4.0) | (np.abs(a1) >= 4.0)
    return np.where(bad, 0.0, a0), np.where(bad, 0.0, a1)


def _chirp(invf: np.ndarray, invf_prev: np.ndarray,
           bw_prev: np.ndarray) -> np.ndarray:
    """Chirp-factor smoothing per noise band (§4.6.18.6.1, Table 4.158:
    a 0<->1 inverse-filtering transition takes the 0.6 entry)."""
    new = np.asarray(ST.BW_TAB, np.float64)[invf]
    new = np.where(invf + invf_prev[: new.shape[0]] == 1, 0.6, new)
    up = new >= bw_prev[: new.shape[0]]
    bw = np.where(up, 0.90625 * new + 0.09375 * bw_prev[: new.shape[0]],
                  0.75 * new + 0.25 * bw_prev[: new.shape[0]])
    bw[bw < 0.015625] = 0.0
    return bw


# ---------------------------------------------------------- dequantization


def dequant_env(env_q: List[np.ndarray], amp_res: int) -> List[np.ndarray]:
    """E_orig = 2^(sf*a + 6), reference level of §4.6.18.7.1."""
    a = 1.0 if amp_res else 0.5
    return [np.exp2(row * a + 6.0) for row in env_q]


def dequant_noise(noise_q: np.ndarray) -> np.ndarray:
    return np.exp2(NOISE_FLOOR_OFFSET - noise_q.astype(np.float64))


def dequant_coupled(env0: List[np.ndarray], env1: List[np.ndarray],
                    noise0: np.ndarray, noise1: np.ndarray, amp_res: int):
    """Channel-coupling dequantization (§4.6.18.7.1): ch0 carries the
    level, ch1 the balance; total energy is split between channels."""
    a = 1.0 if amp_res else 0.5
    pan = 12.0 if amp_res else 24.0      # oracle-calibrated (Table 4.160)
    e0_out, e1_out = [], []
    for q0, q1 in zip(env0, env1):
        t1 = np.exp2(q0 * a + 7.0)
        t2 = np.exp2((pan - q1) * a)
        e0 = t1 / (1.0 + t2)
        e0_out.append(e0)
        e1_out.append(e0 * t2)
    t1 = np.exp2(NOISE_FLOOR_OFFSET + 1.0 - noise0.astype(np.float64))
    t2 = np.exp2(12.0 - noise1.astype(np.float64))
    q0 = t1 / (1.0 + t2)
    return e0_out, e1_out, q0, q0 * t2


# ---------------------------------------------------- per-channel state


class _ChannelState:
    def __init__(self, nts: int):
        self.analysis = _QmfAnalysis()
        self.synthesis = _QmfSynthesis()
        self.w_prev = np.zeros((T_HFGEN, 32), np.complex128)
        self.y_prev = np.zeros((2 * nts + 6, 64), np.complex128)
        self.t_end_old = 2 * nts
        self.kx_old = 32
        self.m_old = 0
        self.env_prev: Optional[np.ndarray] = None
        self.res_prev = 1
        self.noise_prev: Optional[np.ndarray] = None
        self.bw_prev = np.zeros(5)
        self.invf_prev = np.zeros(5, int)
        self.index_noise = 0
        self.index_sine = 0
        self.g_temp = np.zeros((2 * nts + 11, 64))
        self.q_temp = np.zeros((2 * nts + 11, 64))
        self.s_index_prev = np.zeros(64, int)
        self.e_a0 = -1                 # sinusoid carry from previous frame

    def clear_history(self):
        self.env_prev = None
        self.noise_prev = None
        self.bw_prev[:] = 0.0
        self.invf_prev[:] = 0
        self.s_index_prev[:] = 0
        self.e_a0 = -1
        self.m_old = 0
        self.kx_old = 32


# -------------------------------------------------------------- decoder


class SbrDecoder:
    """Stateful SBR decoder for one SCE or CPE element.

    ``parse_extension`` consumes one sbr_extension_data payload (FIL
    element contents after the extension_type nibble); ``apply`` upsamples
    the core channel PCM 2x, reconstructing the high band when SBR data
    was parsed for the frame (plain QMF upsampling otherwise).
    """

    def __init__(self, core_rate: int, frame_len: int, channels: int):
        if frame_len % 64:
            raise ValueError("frame length must be a QMF multiple")
        self.fs_sbr = 2 * core_rate
        self.nts = frame_len // 64              # SBR time slots (15 or 16)
        self.frame_len = frame_len
        self.channels = channels
        self.header: Optional[SbrHeader] = None
        self.tables: Optional[FreqTables] = None
        self.reset = True
        self.st = [_ChannelState(self.nts) for _ in range(channels)]
        self.ch_data: List[Optional[SbrChannel]] = [None] * channels
        self.coupling = 0
        self.parse_errors = 0
        # Parametric Stereo (HE-AAC v2): persistent bitstream + synthesis
        # state; active once a PS header is seen on a 1-channel element.
        # The reference decodes this via libfaad's implicit-PS path
        # (faad-decoder.h:78-165); dabjax synthesizes natively (ps.py).
        from dabbench.gen.audio.ps import PsCommon, PsDecoder
        self.ps_common = PsCommon()
        self.ps_dec = PsDecoder(2 * self.nts)
        self._ps_synth_r: Optional[_QmfSynthesis] = None

    # ------------------------------------------------------------ parse

    def parse_extension(self, payload: bytes, crc: bool) -> None:
        self.ch_data = [None] * self.channels
        try:
            self._parse(BitReader(payload), crc)
        except (ValueError, EOFError, KeyError):
            self.parse_errors += 1
            self.ch_data = [None] * self.channels
            for st in self.st:
                st.clear_history()

    def _parse(self, br: BitReader, crc: bool) -> None:
        if crc:
            br.read(10)                          # bs_sbr_crc_bits
        if br.read1():                           # bs_header_flag
            h = parse_sbr_header(br)
            if (self.header is None
                    or h.table_key() != self.header.table_key()):
                self.tables = derive_tables(h, self.fs_sbr)
                self.reset = True
                for st in self.st:
                    st.clear_history()
            self.header = h
        if self.header is None or self.tables is None:
            return
        if self.channels == 2:
            self._parse_cpe(br)
        else:
            self._parse_sce(br)

    def _new_channel(self) -> SbrChannel:
        ch = SbrChannel()
        ch.amp_res = self.header.amp_res
        return ch

    def _parse_sce(self, br: BitReader) -> None:
        ft = self.tables
        if br.read1():                           # bs_data_extra
            br.read(4)
        ch = self._new_channel()
        parse_sbr_grid(br, self.nts, ch)
        if ch.frame_class == FIXFIX and ch.num_env == 1:
            ch.amp_res = 0                       # §4.6.18.3: forced 1.5 dB
        parse_sbr_dtdf(br, ch)
        parse_sbr_invf(br, ft, ch)
        st = self.st[0]
        parse_sbr_envelope(br, ft, ch, st.env_prev, st.res_prev, False)
        parse_sbr_noise(br, ft, ch, st.noise_prev, False)
        self._parse_add_harmonic(br, ch)
        self._parse_extended(br)
        self.coupling = 0
        self.ch_data = [ch]

    def _parse_cpe(self, br: BitReader) -> None:
        ft = self.tables
        if br.read1():                           # bs_data_extra
            br.read(4)
            br.read(4)
        coupling = br.read1()
        c0, c1 = self._new_channel(), self._new_channel()
        if coupling:
            parse_sbr_grid(br, self.nts, c0)
            for f in ("frame_class", "num_env", "t_env", "freq_res",
                      "pointer", "num_noise", "t_q", "l_a"):
                setattr(c1, f, getattr(c0, f))
            if c0.frame_class == FIXFIX and c0.num_env == 1:
                c0.amp_res = c1.amp_res = 0
            parse_sbr_dtdf(br, c0)
            parse_sbr_dtdf(br, c1)
            parse_sbr_invf(br, ft, c0)
            c1.invf = c0.invf.copy()
            parse_sbr_envelope(br, ft, c0, self.st[0].env_prev,
                               self.st[0].res_prev, False)
            parse_sbr_noise(br, ft, c0, self.st[0].noise_prev, False)
            parse_sbr_envelope(br, ft, c1, self.st[1].env_prev,
                               self.st[1].res_prev, True)
            parse_sbr_noise(br, ft, c1, self.st[1].noise_prev, True)
        else:
            parse_sbr_grid(br, self.nts, c0)
            parse_sbr_grid(br, self.nts, c1)
            if c0.frame_class == FIXFIX and c0.num_env == 1:
                c0.amp_res = 0
            if c1.frame_class == FIXFIX and c1.num_env == 1:
                c1.amp_res = 0
            parse_sbr_dtdf(br, c0)
            parse_sbr_dtdf(br, c1)
            parse_sbr_invf(br, ft, c0)
            parse_sbr_invf(br, ft, c1)
            parse_sbr_envelope(br, ft, c0, self.st[0].env_prev,
                               self.st[0].res_prev, False)
            parse_sbr_envelope(br, ft, c1, self.st[1].env_prev,
                               self.st[1].res_prev, False)
            parse_sbr_noise(br, ft, c0, self.st[0].noise_prev, False)
            parse_sbr_noise(br, ft, c1, self.st[1].noise_prev, False)
        self._parse_add_harmonic(br, c0)
        self._parse_add_harmonic(br, c1)
        self._parse_extended(br)
        self.coupling = coupling
        self.ch_data = [c0, c1]

    def _parse_add_harmonic(self, br: BitReader, ch: SbrChannel) -> None:
        ft = self.tables
        if br.read1():
            ch.add_harmonic = np.array(
                [br.read1() for _ in range(ft.n_high)], int)
        else:
            ch.add_harmonic = np.zeros(ft.n_high, int)

    def _parse_extended(self, br: BitReader) -> None:
        if not br.read1():                       # bs_extended_data
            return
        cnt = br.read(4)
        if cnt == 15:
            cnt += br.read(8)
        bits_left = 8 * cnt
        while bits_left > 7:
            ext_id = br.read(2)
            bits_left -= 2
            if ext_id == 2 and self.channels == 1:  # EXTENSION_ID_PS
                from dabbench.gen.audio.ps import read_ps_data
                p0 = br.pos
                try:
                    read_ps_data(br, self.ps_common, 2 * self.nts)
                except (ValueError, EOFError, KeyError):
                    # PS off until the next header; SBR state untouched
                    self.ps_common.start = False
                    self.ps_common.iid_par[:] = 0
                    self.ps_common.icc_par[:] = 0
                bits_left -= br.pos - p0
            else:
                skip = min(bits_left, br.remaining)
                br.read(skip)
                bits_left = 0
        if bits_left > 0:
            br.read(min(bits_left, br.remaining))

    # ------------------------------------------------------------ apply

    def apply(self, pcm_core: np.ndarray) -> np.ndarray:
        """[frame_len, channels] core PCM -> [2*frame_len, channels].

        Input/output in the core decoder's internal 16-bit-scaled domain.
        The SBR tool delays the signal by 6 QMF slots relative to plain
        2x upsampling (T_HFGEN - T_HFADJ, the spec's alignment of the
        envelope-adjusted slots) — identical to libavcodec/libfaad.
        """
        outs = []
        dequant = self._dequant_frame()
        for c in range(self.channels):
            st = self.st[c]
            w = st.analysis.run(np.asarray(pcm_core[:, c], np.float64))
            x_low = np.concatenate([st.w_prev, w]).T    # [32, 8+2*nts]
            ch = self.ch_data[c] if dequant is not None else None
            if ch is not None:
                x_slots = self._hf_chain(st, ch, x_low, dequant[c])
            else:
                x_slots = np.zeros((2 * self.nts, 64), np.complex128)
                x_slots[:, :32] = \
                    x_low[:, T_HFADJ: T_HFADJ + 2 * self.nts].T
                st.t_end_old = 2 * self.nts
                st.m_old = 0
                st.kx_old = 32
            st.w_prev = w[-T_HFGEN:].copy()
            if self.channels == 1 and self.ps_common.start:
                # Parametric Stereo: mono QMF -> (L, R) before synthesis.
                # The 6 look-ahead slots are the low-band lead the HF
                # chain keeps anyway (libavcodec's X[32..37], sbr_x_gen);
                # high bands there are unused (hybrid touches bands 0-4).
                look = np.zeros((6, 64), np.complex128)
                look[:, :32] = x_low[:, T_HFADJ + 2 * self.nts:].T
                xl, xr = self.ps_dec.apply(
                    x_slots, look, self.ps_common, st.kx_old + st.m_old)
                if self._ps_synth_r is None:
                    self._ps_synth_r = _QmfSynthesis()
                outs.append(st.synthesis.run(xl))
                outs.append(self._ps_synth_r.run(xr))
            else:
                outs.append(st.synthesis.run(x_slots))
        self.reset = False
        return np.stack(outs, axis=1)

    def _dequant_frame(self):
        """Dequantize this frame's envelopes/noise floors per channel."""
        if self.tables is None or any(c is None for c in self.ch_data):
            return None
        if self.channels == 2 and self.coupling:
            c0, c1 = self.ch_data
            e0, e1, q0, q1 = dequant_coupled(
                c0.env_q, c1.env_q, c0.noise_q, c1.noise_q, c0.amp_res)
            return [(e0, q0), (e1, q1)]
        return [(dequant_env(ch.env_q, ch.amp_res),
                 dequant_noise(ch.noise_q)) for ch in self.ch_data]

    # ------------------------------------------------------- HF pipeline

    def _hf_chain(self, st: _ChannelState, ch: SbrChannel,
                  x_low: np.ndarray, dq) -> np.ndarray:
        ft = self.tables
        kx, m_max, nts = ft.kx, ft.m, self.nts
        e_orig, q_orig = dq

        # --- generation (§4.6.18.6): chirped LPC patches
        bw = _chirp(ch.invf, st.invf_prev, st.bw_prev)
        st.bw_prev = bw.copy()
        st.invf_prev = np.zeros(5, int)
        st.invf_prev[: ch.invf.shape[0]] = ch.invf
        x_high = np.zeros((64, x_low.shape[1]), np.complex128)
        b0 = 2 * ch.t_env[0] + T_HFADJ
        b1 = 2 * ch.t_env[-1] + T_HFADJ
        noise_of_band = np.searchsorted(ft.f_noise[1:-1],
                                        kx + np.arange(m_max), side="right")
        # patch source band per target band, then one batched LPC +
        # chirped extrapolation over all patch rows at once
        ps = np.concatenate([start + np.arange(num) for start, num
                             in zip(ft.patch_start, ft.patch_num)])
        bwv = bw[noise_of_band[: ps.shape[0]]]          # [P]
        a0, a1 = _lpc_alphas_batch(x_low[ps])
        seg = x_low[ps, b0:b1]
        live = bwv > 0.0
        c0 = np.where(live, bwv, 0.0)[:, None] * a0[:, None]
        c1 = np.where(live, bwv * bwv, 0.0)[:, None] * a1[:, None]
        seg = seg + c0 * x_low[ps, b0 - 1:b1 - 1] \
            + c1 * x_low[ps, b0 - 2:b1 - 2]
        x_high[kx: kx + ps.shape[0], b0:b1] = seg

        # --- mapping (§4.6.18.7.2)
        n_env = ch.num_env
        e_map = np.zeros((n_env, m_max))
        q_map = np.zeros((n_env, m_max))
        s_index = np.zeros((n_env + 1, m_max), int)
        s_index[0, :] = st.s_index_prev[:m_max]
        s_mapped = np.zeros((n_env, m_max), int)
        e_a1 = ch.l_a
        for e in range(n_env):
            table = ft.f_table(ch.freq_res[e])
            for i in range(ft.n(ch.freq_res[e])):
                e_map[e, table[i] - kx: table[i + 1] - kx] = e_orig[e][i]
            lq = 1 if (ch.num_noise == 2 and ch.t_env[e] >= ch.t_q[1]) else 0
            for i in range(ft.n_q):
                q_map[e, ft.f_noise[i] - kx: ft.f_noise[i + 1] - kx] = \
                    q_orig[lq, i]
            if ch.add_harmonic.any():
                for i in range(ft.n_high):
                    mid = (int(ft.f_high[i]) + int(ft.f_high[i + 1])) >> 1
                    s_index[e + 1, mid - kx] = ch.add_harmonic[i] * (
                        e >= e_a1 or s_index[0, mid - kx] == 1)
            for i in range(ft.n(ch.freq_res[e])):
                lo, hi = table[i] - kx, table[i + 1] - kx
                if s_index[e + 1, lo:hi].any():
                    s_mapped[e, lo:hi] = 1

        # --- envelope estimation (§4.6.18.7.3)
        e_curr = np.zeros((n_env, m_max))
        pw = np.abs(x_high[kx: kx + m_max]) ** 2      # [m, slots]
        for e in range(n_env):
            s0 = 2 * ch.t_env[e] + T_HFADJ
            s1 = 2 * ch.t_env[e + 1] + T_HFADJ
            if self.header.interpol_freq:
                e_curr[e] = pw[:, s0:s1].sum(axis=1) / (s1 - s0)
            else:
                table = ft.f_table(ch.freq_res[e])
                for i in range(ft.n(ch.freq_res[e])):
                    lo, hi = table[i] - kx, table[i + 1] - kx
                    e_curr[e, lo:hi] = (pw[lo:hi, s0:s1].sum()
                                        / ((s1 - s0) * (hi - lo)))

        # --- gain calculation (§4.6.18.7.5)
        eps = np.finfo(np.float32).eps
        limgain = ST.LIMGAIN[self.header.limiter_gains]
        gain = np.zeros((n_env, m_max))
        q_m = np.zeros((n_env, m_max))
        s_m = np.zeros((n_env, m_max))
        for e in range(n_env):
            delta = 0 if (e == st.e_a0 or e == e_a1) else 1
            temp = e_map[e] / (1.0 + q_map[e])
            q_m[e] = np.sqrt(temp * q_map[e])
            s_m[e] = np.sqrt(temp * s_index[e + 1])
            g = np.where(
                s_mapped[e] == 0,
                e_map[e] / ((1.0 + e_curr[e]) * (1.0 + q_map[e] * delta)),
                e_map[e] * q_map[e] / ((1.0 + e_curr[e])
                                       * (1.0 + q_map[e])))
            gain[e] = np.sqrt(g)
            for l in range(ft.n_lim):
                lo = int(ft.f_lim[l]) - kx
                hi = int(ft.f_lim[l + 1]) - kx
                g_max = limgain * np.sqrt(
                    (eps + e_map[e, lo:hi].sum())
                    / (eps + e_curr[e, lo:hi].sum()))
                g_max = min(g_max, 1.0e5)
                q_m[e, lo:hi] = np.minimum(
                    q_m[e, lo:hi],
                    q_m[e, lo:hi] * g_max / np.maximum(gain[e, lo:hi],
                                                       1e-30))
                gain[e, lo:hi] = np.minimum(gain[e, lo:hi], g_max)
                sum0 = eps + e_map[e, lo:hi].sum()
                sum1 = eps + (
                    e_curr[e, lo:hi] * gain[e, lo:hi] ** 2
                    + s_m[e, lo:hi] ** 2
                    + (delta * (s_m[e, lo:hi] == 0)) * q_m[e, lo:hi] ** 2
                ).sum()
                boost = min(np.sqrt(sum0 / sum1), 1.584893192)
                gain[e, lo:hi] *= boost
                q_m[e, lo:hi] *= boost
                s_m[e, lo:hi] *= boost

        # --- assembly (§4.6.18.7.6)
        y = np.zeros((2 * nts + 6, 64), np.complex128)
        h_sl = 0 if self.header.smoothing_mode else 4
        g_temp, q_temp = st.g_temp, st.q_temp
        t0s = 2 * ch.t_env[0]
        if self.reset:
            for i in range(h_sl):
                g_temp[i + t0s, :m_max] = gain[0]
                q_temp[i + t0s, :m_max] = q_m[0]
        elif h_sl:
            for i in range(4):
                g_temp[i + t0s] = g_temp[i + st.t_end_old]
                q_temp[i + t0s] = q_temp[i + st.t_end_old]
        i_fill = np.arange(2 * ch.t_env[0], 2 * ch.t_env[-1])
        e_fill = np.searchsorted(2 * np.asarray(ch.t_env[1:]), i_fill,
                                 side="right")
        g_temp[h_sl + i_fill, :m_max] = gain[e_fill]
        q_temp[h_sl + i_fill, :m_max] = q_m[e_fill]
        h_smooth = np.asarray(ST.H_SMOOTH)
        idx_noise, idx_sine = st.index_noise, st.index_sine
        phi_re = np.array((1.0, 0.0, -1.0, 0.0))
        phi_im = np.array((0.0, 1.0, 0.0, -1.0))
        alt = np.where((kx + np.arange(m_max)) & 1, -1.0, 1.0)
        # one vectorized pass over all 2*t_env[0]..2*t_env[-1] slots (was a
        # per-slot Python loop — the AAC host plane's hottest region): the
        # smoothing filter becomes a sliding-window tensordot, and the
        # noise/sine phase sequences are generated in closed form from the
        # per-slot index recurrences.
        i_all = np.arange(t0s, 2 * ch.t_env[-1])
        if i_all.shape[0]:
            n_sl = i_all.shape[0]
            e_of_i = np.searchsorted(2 * np.asarray(ch.t_env[1:]), i_all,
                                     side="right")
            trans = (e_of_i == st.e_a0) | (e_of_i == e_a1)
            g_now = g_temp[i_all + h_sl, :m_max]
            q_now = q_temp[i_all + h_sl, :m_max]
            if h_sl:
                from numpy.lib.stride_tricks import sliding_window_view
                lo = i_all[0] + h_sl - 4
                gw = sliding_window_view(
                    g_temp[lo: i_all[-1] + h_sl + 1, :m_max], 5, axis=0)
                qw = sliding_window_view(
                    q_temp[lo: i_all[-1] + h_sl + 1, :m_max], 5, axis=0)
                # window tap order matches rows[::-1] * h_smooth
                g_sm = gw[:, :, ::-1] @ h_smooth
                q_sm = qw[:, :, ::-1] @ h_smooth
                g_filt = np.where(trans[:, None], g_now, g_sm)
                q_filt = np.where(trans[:, None], q_now, q_sm)
            else:
                g_filt, q_filt = g_now, q_now
            sl = np.arange(n_sl)
            sine_idx = (idx_sine + sl) & 3
            sine = (s_m[e_of_i]
                    * (phi_re[sine_idx, None]
                       + 1j * phi_im[sine_idx, None] * alt[None, :]))
            noise_idx = (idx_noise + sl[:, None] * m_max + 1
                         + np.arange(m_max)[None, :]) & 0x1ff
            noise = (ST.NOISE_TABLE[noise_idx, 0]
                     + 1j * ST.NOISE_TABLE[noise_idx, 1])
            add = np.where(trans[:, None], sine,
                           np.where(s_m[e_of_i] != 0.0, sine,
                                    q_filt * noise))
            y[i_all, kx: kx + m_max] = \
                x_high[kx: kx + m_max, i_all + T_HFADJ].T * g_filt + add
            idx_noise = (idx_noise + n_sl * m_max) & 0x1ff
            idx_sine = (idx_sine + n_sl) & 3
        st.index_noise, st.index_sine = idx_noise, idx_sine

        # --- X build for synthesis (§4.6.18.8)
        x_slots = np.zeros((2 * nts, 64), np.complex128)
        i_temp = max(st.t_end_old - 2 * nts, 0) if not self.reset else 0
        if i_temp:
            x_slots[:i_temp, : st.kx_old] = \
                x_low[: st.kx_old, T_HFADJ: T_HFADJ + i_temp].T
            x_slots[:i_temp, st.kx_old: st.kx_old + st.m_old] = \
                st.y_prev[2 * nts: 2 * nts + i_temp,
                          st.kx_old: st.kx_old + st.m_old]
        x_slots[i_temp:, :kx] = \
            x_low[:kx, i_temp + T_HFADJ: 2 * nts + T_HFADJ].T
        x_slots[i_temp:, kx: kx + m_max] = \
            y[i_temp: 2 * nts, kx: kx + m_max]

        # --- state carry
        st.y_prev = y
        st.t_end_old = 2 * ch.t_env[-1]
        st.kx_old, st.m_old = kx, m_max
        st.env_prev = ch.env_q[-1]
        st.res_prev = ch.freq_res[-1]
        st.noise_prev = ch.noise_q[-1]
        st.s_index_prev = np.zeros(64, int)
        st.s_index_prev[:m_max] = s_index[n_env]
        st.e_a0 = 0 if ch.l_a == ch.num_env else -1
        return x_slots
