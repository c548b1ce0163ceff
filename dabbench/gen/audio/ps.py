"""Parametric Stereo decoder (HE-AAC v2) — ISO/IEC 14496-3 §8.6.4.

Reconstructs a stereo image from a mono SBR QMF matrix plus the PS
side-info carried in the SBR extension (EXTENSION_ID_PS): IID/ICC
(and optionally IPD/OPD) parameters drive a hybrid-filterbank
analysis, a transient-aware de-correlator (three serial all-pass
links with fractional delays), and per-band 2x2 mixing.

The reference receiver plays ps_flag services through libfaad's PS
synthesis (reference faad-decoder.h:78-165, mp4processor.cpp:185-189
parses psFlag); dabjax decodes PS natively.  The arithmetic follows
the spec's structure with libavcodec's operation ordering (our
correctness oracle), so output matches ffmpeg's float PS decoder to
float32 rounding:

* hybrid analysis: 13-tap conjugate-symmetric complex filters split
  QMF band 0 into 8 sub-bands (merged to 6) and bands 1-2 into 2
  each (20-band mode), or bands 0-4 into 12/8/4/4/4 (34-band mode);
  output slot n is centred on input slot n (6 slots of look-ahead
  from the low-band QMF lead window, zero group delay),
* de-correlation: per-band power -> peak-decay transient detector;
  all-pass chain d_m = {3,4,5} slots, link gains
  a_m * g_decay_slope, fractional-delay phases Q_fract; plain
  delays of 14 (mid bands) / 1 (top bands) slots,
* stereo mixing: H11/H12/H21/H22 from the quantized IID/ICC grid
  (mixing procedure A or B), linearly interpolated across each
  parameter envelope, optional IPD/OPD phase rotation with the
  spec's two-frame phase smoother.

All constant tables are byte-exact ISO values extracted from the
image's libavcodec (dabjax_torch/audio/_ps_tables.py); the runtime tables
(hybrid filters, fractional-delay phases, mixing LUTs) are computed
from the spec formulas at import.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dabbench.gen.audio import _ps_tables as PT
from dabbench.gen.audio.aac_lc import BitReader, Huffman

__all__ = ["PsCommon", "PsDecoder", "read_ps_data"]


# ------------------------------------------------------------ huffman

def _huff(codes, bits, offset):
    h = Huffman(codes, bits)
    h.offset = offset
    return h


_IID_DF = (_huff(PT.HUFF_IID_DF0_CODES, PT.HUFF_IID_DF0_BITS,
                 PT.HUFF_IID_DF0_OFFSET),
           _huff(PT.HUFF_IID_DF1_CODES, PT.HUFF_IID_DF1_BITS,
                 PT.HUFF_IID_DF1_OFFSET))
_IID_DT = (_huff(PT.HUFF_IID_DT0_CODES, PT.HUFF_IID_DT0_BITS,
                 PT.HUFF_IID_DT0_OFFSET),
           _huff(PT.HUFF_IID_DT1_CODES, PT.HUFF_IID_DT1_BITS,
                 PT.HUFF_IID_DT1_OFFSET))
_ICC_DF = _huff(PT.HUFF_ICC_DF_CODES, PT.HUFF_ICC_DF_BITS,
                PT.HUFF_ICC_DF_OFFSET)
_ICC_DT = _huff(PT.HUFF_ICC_DT_CODES, PT.HUFF_ICC_DT_BITS,
                PT.HUFF_ICC_DT_OFFSET)
_IPD_DF = _huff(PT.HUFF_IPD_DF_CODES, PT.HUFF_IPD_DF_BITS, 0)
_IPD_DT = _huff(PT.HUFF_IPD_DT_CODES, PT.HUFF_IPD_DT_BITS, 0)
_OPD_DF = _huff(PT.HUFF_OPD_DF_CODES, PT.HUFF_OPD_DF_BITS, 0)
_OPD_DT = _huff(PT.HUFF_OPD_DT_CODES, PT.HUFF_OPD_DT_BITS, 0)

# nr of parameters per iid/icc mode (modes 3..5 are fine-quant iid)
_NR_PAR_TAB = (10, 20, 34, 10, 20, 34)
_NR_IPDOPD_PAR_TAB = (5, 11, 17, 5, 11, 17)
_NUM_ENV_TAB = ((0, 1, 2, 4), (1, 2, 3, 4))

_AP_LINKS = 3
_MAX_DELAY = 14
_MAX_AP_DELAY = 5
_DECAY_SLOPE = 0.05
_A = np.array([0.65143905753106, 0.56471812200776, 0.48954165955695],
              np.float32)               # all-pass link gains (aacpsdsp)
_FRAC_DELAY_GAIN = 0.39


# --------------------------------------------------- generated tables

def _make_filter(proto, bands):
    """Complex modulation of a 13-tap symmetric prototype: tap n of
    sub-band q gets phase 2*pi*(q+0.5)*(n-6)/bands (spec 8.6.4.7.2;
    only taps 0..6 stored, taps 7..12 follow by conjugate symmetry)."""
    q = np.arange(bands)[:, None]
    n = np.arange(7)[None, :]
    theta = 2 * np.pi * (q + 0.5) * (n - 6) / bands
    f = proto[None, :].astype(np.float64) * np.exp(-1j * theta)
    return f.astype(np.complex64)        # [bands, 7]


_F20_0_8 = _make_filter(PT.G0_Q8, 8)
_F34_0_12 = _make_filter(PT.G0_Q12, 12)
_F34_1_8 = _make_filter(PT.G1_Q8, 8)
_F34_2_4 = _make_filter(PT.G2_Q4, 4)
# 2-way real split of QMF bands 1/2 in 20-band mode (spec Table 8.34;
# inlined as immediates in libavcodec so not extractable)
_G1_Q2 = np.array([0.0, 0.01899487526049, 0.0, -0.07293139167538,
                   0.0, 0.30596630545168, 0.5], np.float32)


def _fract_phases(is34):
    """(phi_fract [nb], q_fract [nb, 3]) complex64 fractional-delay
    phases over the all-pass bands (spec 8.6.4.6.5)."""
    nb = PT.NR_ALLPASS_BANDS[is34]
    ks = np.arange(nb)
    if is34:
        fc = np.where(ks < len(PT.F_CENTER_34),
                      PT.F_CENTER_34[np.minimum(ks, 31)] / 24.0,
                      ks - np.float32(26.5))
    else:
        fc = np.where(ks < len(PT.F_CENTER_20),
                      PT.F_CENTER_20[np.minimum(ks, 9)] * 0.125,
                      ks - np.float32(6.5))
    phi = np.exp(-1j * np.pi * _FRAC_DELAY_GAIN * fc)
    q = np.exp(-1j * np.pi
               * PT.FRACTIONAL_DELAY_LINKS[None, :].astype(np.float64)
               * fc[:, None])
    return phi.astype(np.complex64), q.astype(np.complex64)


_PHI_FRACT = (_fract_phases(0), _fract_phases(1))


def _mixing_luts():
    """HA/HB [46, 8, 4] mixing matrices (spec 8.6.4.6.2.1/.2)."""
    c = PT.IID_PAR_DEQUANT.astype(np.float64)[:, None]
    c1 = np.sqrt(2.0) / np.sqrt(1.0 + c * c)
    c2 = c * c1
    # procedure A
    alpha = 0.5 * PT.ACOS_ICC_INVQ.astype(np.float64)[None, :]
    beta = alpha * (c1 - c2) / np.sqrt(2.0)
    ha = np.stack([c2 * np.cos(beta + alpha), c1 * np.cos(beta - alpha),
                   c2 * np.sin(beta + alpha), c1 * np.sin(beta - alpha)],
                  axis=-1)
    # procedure B
    rho = np.maximum(PT.ICC_INVQ.astype(np.float64), 0.05)[None, :]
    alpha = 0.5 * np.arctan2(2.0 * c * rho, c * c - 1.0)
    mu = c + 1.0 / c
    mu = np.sqrt(1.0 + (4.0 * rho * rho - 4.0) / (mu * mu))
    gamma = np.arctan(np.sqrt((1.0 - mu) / (1.0 + mu)))
    alpha = np.where(alpha < 0, alpha + np.pi / 2, alpha)
    r2 = np.sqrt(2.0)
    hb = np.stack([r2 * np.cos(alpha) * np.cos(gamma),
                   r2 * np.sin(alpha) * np.cos(gamma),
                   -r2 * np.cos(alpha) * np.sin(gamma),
                   r2 * np.sin(alpha) * np.sin(gamma)], axis=-1)
    return ha.astype(np.float32), hb.astype(np.float32)


_HA, _HB = _mixing_luts()


def _pd_smooth():
    """[512] complex two-frame phase smoother LUT: index
    pd0*64 + pd1*8 + pd2 -> normalized 0.25*e(pd0)+0.5*e(pd1)+e(pd2)."""
    e = PT.IPDOPD_COS.astype(np.float64) + 1j * PT.IPDOPD_SIN.astype(
        np.float64)
    v = (0.25 * e[:, None, None] + 0.5 * e[None, :, None]
         + e[None, None, :])
    v = v / np.abs(v)
    return v.reshape(512).astype(np.complex64)


_PD_SMOOTH = _pd_smooth()


# ------------------------------------------------------------- parse

class PsCommon:
    """Persistent PS bitstream state (header fields survive frames
    without a header; parameters feed the fake-envelope carry-over)."""

    def __init__(self):
        self.start = False
        self.enable_iid = False
        self.iid_quant = 0
        self.nr_iid_par = 0
        self.nr_ipdopd_par = 0
        self.enable_icc = False
        self.icc_mode = 0
        self.nr_icc_par = 0
        self.enable_ext = False
        self.enable_ipdopd = False
        self.num_env = 0
        self.num_env_old = 0
        self.is34 = 0
        self.is34_old = 0
        self.border_position = np.zeros(6, int)
        self.iid_par = np.zeros((5, 34), int)
        self.icc_par = np.zeros((5, 34), int)
        self.ipd_par = np.zeros((5, 17), int)
        self.opd_par = np.zeros((5, 17), int)


def _read_pars(br, par, e, num_env_old, nr, dt, huff, limit, wrap):
    """One envelope of delta-coded parameters into par[e, :nr]."""
    prev = par[e - 1] if e else (par[num_env_old - 1]
                                 if num_env_old else np.zeros(34, int))
    for b in range(nr):
        delta = huff.decode(br) - huff.offset
        if dt:
            val = int(prev[b]) + delta
        else:
            val = (int(par[e, b - 1]) if b else 0) + delta
        if wrap:
            val &= 7
        elif abs(val) > limit:
            raise ValueError("PS parameter out of range")
        par[e, b] = val


def read_ps_data(br: BitReader, ps: PsCommon, n_slots: int) -> None:
    """Parse one frame of ps_data (spec Table 8.11) into ``ps``.

    Raises ValueError/EOFError on malformed data; the caller must
    treat that as "PS off this frame" without touching decoder state.
    """
    if br.read1():                       # enable_ps_header
        ps.enable_iid = bool(br.read1())
        if ps.enable_iid:
            iid_mode = br.read(3)
            if iid_mode > 5:
                raise ValueError("bad iid_mode")
            ps.nr_iid_par = _NR_PAR_TAB[iid_mode]
            ps.iid_quant = int(iid_mode > 2)
            ps.nr_ipdopd_par = _NR_IPDOPD_PAR_TAB[iid_mode]
        ps.enable_icc = bool(br.read1())
        if ps.enable_icc:
            ps.icc_mode = br.read(3)
            if ps.icc_mode > 5:
                raise ValueError("bad icc_mode")
            ps.nr_icc_par = _NR_PAR_TAB[ps.icc_mode]
        ps.enable_ext = bool(br.read1())
        ps.start = True
    if not ps.start:
        raise ValueError("PS data before any PS header")

    frame_class = br.read1()
    ps.num_env_old = ps.num_env
    ps.num_env = _NUM_ENV_TAB[frame_class][br.read(2)]
    ps.border_position[0] = -1
    if frame_class:
        for e in range(1, ps.num_env + 1):
            ps.border_position[e] = br.read(5)
            if ps.border_position[e] < ps.border_position[e - 1]:
                raise ValueError("non-monotone PS borders")
    else:
        shift = ps.num_env.bit_length() - 1 if ps.num_env else 0
        for e in range(1, ps.num_env + 1):
            ps.border_position[e] = (e * n_slots >> shift) - 1

    if ps.enable_iid:
        for e in range(ps.num_env):
            dt = br.read1()
            huff = (_IID_DT if dt else _IID_DF)[ps.iid_quant]
            _read_pars(br, ps.iid_par, e, ps.num_env_old, ps.nr_iid_par,
                       dt, huff, 7 + 8 * ps.iid_quant, False)
    else:
        ps.iid_par[:] = 0
    if ps.enable_icc:
        for e in range(ps.num_env):
            dt = br.read1()
            _read_pars(br, ps.icc_par, e, ps.num_env_old, ps.nr_icc_par,
                       dt, _ICC_DT if dt else _ICC_DF, 7, False)
    else:
        ps.icc_par[:] = 0

    if ps.enable_ext:
        cnt = br.read(4)
        if cnt == 15:
            cnt += br.read(8)
        cnt *= 8
        while cnt > 7:
            ext_id = br.read(2)
            cnt -= 2 + _read_extension(br, ps, ext_id)
        if cnt < 0:
            raise ValueError("PS extension overrun")
        br.read(cnt)

    # fake envelope covering the frame tail (or a parameter-less frame)
    if ps.num_env == 0 or ps.border_position[ps.num_env] < n_slots - 1:
        source = ps.num_env - 1 if ps.num_env else ps.num_env_old - 1
        if source >= 0 and source != ps.num_env:
            ps.iid_par[ps.num_env] = ps.iid_par[source]
            ps.icc_par[ps.num_env] = ps.icc_par[source]
            ps.ipd_par[ps.num_env] = ps.ipd_par[source]
            ps.opd_par[ps.num_env] = ps.opd_par[source]
        ps.num_env += 1
        ps.border_position[ps.num_env] = n_slots - 1

    ps.is34_old = ps.is34
    ps.is34 = int(ps.nr_iid_par == 34 or ps.nr_icc_par == 34)


def _read_extension(br: BitReader, ps: PsCommon, ext_id: int) -> int:
    if ext_id != 0:                      # only ipdopd is defined
        return 0
    start = br.pos
    ps.enable_ipdopd = bool(br.read1())
    if ps.enable_ipdopd:
        for e in range(ps.num_env):
            dt = br.read1()
            _read_pars(br, ps.ipd_par, e, ps.num_env_old,
                       ps.nr_ipdopd_par, dt,
                       _IPD_DT if dt else _IPD_DF, 7, True)
            dt = br.read1()
            _read_pars(br, ps.opd_par, e, ps.num_env_old,
                       ps.nr_ipdopd_par, dt,
                       _OPD_DT if dt else _OPD_DF, 7, True)
    br.read1()                           # reserved_ps
    return br.pos - start


# -------------------------------------------------- parameter remaps

def _map_10_to_20(par):
    out = np.zeros(20, par.dtype)
    out[0::2] = par[:10]
    out[1::2] = par[:10]
    return out


# 34-band parameter grid from the 20-band grid (spec Table 8.42 band
# edges; duplication pattern as in libavcodec map_idx_20_to_34)
_MAP_20_TO_34 = np.array([0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 10,
                          11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
                          17, 17, 18, 18, 19, 19, 19])
_MAP_10_TO_34 = np.array([0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5,
                          5, 5, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 8, 8, 8,
                          8, 8, 9, 9])


def _remap(par, nr, is34):
    """[34] parameter row remapped onto the processing band grid."""
    if is34:
        if nr == 34:
            return par[:34]
        if nr == 20:
            return par[_MAP_20_TO_34]
        return par[_MAP_10_TO_34]
    if nr == 34:
        raise ValueError("34-par set with 20-band processing")
    if nr == 20:
        return par[:20]
    return _map_10_to_20(par)


def _remap_ipdopd(par, nr, is34):
    """IPD/OPD rows onto the processing grid's 11/17 phase bands.

    Cross-grid cases (a 20-par stream decoded on the 34-band grid or
    vice versa) reuse the band-edge duplication maps clipped to the
    available parameter count — phases vary slowly across bands, so
    edge duplication is the spec's own coarse-grid behavior."""
    n = PT.NR_IPDOPD_BANDS[is34]
    if is34:
        if nr >= 17:
            return par[:17]
        m = _MAP_20_TO_34[:17] if nr == 11 else _MAP_10_TO_34[:17]
        return par[np.minimum(m, nr - 1)]
    if nr >= 11:
        return par[:11]
    out = np.zeros(11, par.dtype)
    out[0::2] = par[:6] if nr >= 6 else np.pad(par[:nr], (0, 6 - nr))
    out[1::2] = par[:5]
    return out[:n]


# ------------------------------------------------------------ decoder

class PsDecoder:
    """Stateful PS synthesis over per-frame QMF matrices.

    ``apply(x, lookahead, ps)`` takes the frame's mono QMF slots
    ``x`` [n_slots, 64] complex, 6 look-ahead slots [6, 64] (low QMF
    bands of the next window; high bands may be zero — only bands
    0..4 feed the hybrid filters), and the parsed :class:`PsCommon`;
    returns (L, R) QMF matrices [n_slots, 64].
    """

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.in_hist = np.zeros((12, 64), np.complex64)   # filter history
        self.delay = np.zeros((91, _MAX_DELAY), np.complex64)
        self.ap_delay = np.zeros((50, _AP_LINKS, _MAX_AP_DELAY),
                                 np.complex64)
        self.peak_decay_nrg = np.zeros(34, np.float32)
        self.power_smooth = np.zeros(34, np.float32)
        self.peak_decay_diff_smooth = np.zeros(34, np.float32)
        self.h_prev = np.zeros((4, 34), np.float32)        # re parts
        self.h_prev_im = np.zeros((4, 34), np.float32)
        self.opd_hist = np.zeros(17, int)
        self.ipd_hist = np.zeros(17, int)

    # ------------------------------------------------ hybrid banks

    def _hybrid_analysis(self, buf, is34):
        """buf [12 + n_slots + 6, 64] -> hybrid [nb, n_slots] complex.

        Output slot n is centred on buf[n + 12] (the current frame's
        slot n): window buf[n+6 : n+19]."""
        ns = self.n_slots
        nb = PT.NR_BANDS[is34]
        out = np.empty((nb, ns), np.complex64)
        # sliding 13-slot windows of the low QMF bands: [ns, 13, 5]
        idx = np.arange(ns)[:, None] + 6 + np.arange(13)[None, :]
        win = buf[idx, :5]                              # [ns, 13, 5]
        if is34:
            splits = ((0, 0, _F34_0_12), (1, 12, _F34_1_8),
                      (2, 20, _F34_2_4), (3, 24, _F34_2_4),
                      (4, 28, _F34_2_4))
            for band, off, filt in splits:
                sub = _filter13(win[:, :, band], filt)  # [ns, nq]
                out[off: off + filt.shape[0]] = sub.T
            out[32:] = buf[12: 12 + ns, 5: 5 + nb - 32].T
        else:
            t = _filter13(win[:, :, 0], _F20_0_8)       # [ns, 8]
            out[0] = t[:, 6]
            out[1] = t[:, 7]
            out[2] = t[:, 0]
            out[3] = t[:, 1]
            out[4] = t[:, 2] + t[:, 5]
            out[5] = t[:, 3] + t[:, 4]
            for band, off, rev in ((1, 6, 1), (2, 8, 0)):
                re_in = _filter13_real_even(win[:, :, band])
                re_op = _filter13_real_odd(win[:, :, band])
                out[off + rev] = re_in + re_op
                out[off + 1 - rev] = re_in - re_op
            out[10:] = buf[12: 12 + ns, 3: 3 + nb - 10].T
        return out

    def _hybrid_synthesis(self, hyb, is34):
        """hybrid [nb, n_slots] -> QMF [n_slots, 64]."""
        ns = self.n_slots
        out = np.zeros((ns, 64), np.complex64)
        if is34:
            out[:, 0] = hyb[0:12].sum(axis=0)
            out[:, 1] = hyb[12:20].sum(axis=0)
            out[:, 2] = hyb[20:24].sum(axis=0)
            out[:, 3] = hyb[24:28].sum(axis=0)
            out[:, 4] = hyb[28:32].sum(axis=0)
            out[:, 5: 5 + 91 - 32] = hyb[32:].T
        else:
            out[:, 0] = hyb[0:6].sum(axis=0)
            out[:, 1] = hyb[6] + hyb[7]
            out[:, 2] = hyb[8] + hyb[9]
            out[:, 3: 3 + 71 - 10] = hyb[10:].T
        return out

    # -------------------------------------------------- decorrelate

    def _decorrelate(self, lbuf, is34):
        ns = self.n_slots
        nb = PT.NR_BANDS[is34]
        npar = PT.NR_PAR_BANDS[is34]
        nap = PT.NR_ALLPASS_BANDS[is34]
        k_to_i = PT.K_TO_I_34 if is34 else PT.K_TO_I_20
        phi, qf = _PHI_FRACT[is34]

        power = np.zeros((34, ns), np.float32)
        mag2 = (lbuf.real.astype(np.float32) ** 2
                + lbuf.imag.astype(np.float32) ** 2)
        np.add.at(power, np.asarray(k_to_i[:nb]), mag2)

        # transient detection (serial IIR over slots, vector over bands)
        tg = np.empty((34, ns), np.float32)
        pd, psm, pdd = (self.peak_decay_nrg, self.power_smooth,
                        self.peak_decay_diff_smooth)
        for n in range(ns):
            pw = power[:, n]
            np.maximum(np.float32(0.76592833836465) * pd, pw, out=pd)
            psm += np.float32(0.25) * (pw - psm)
            pdd += np.float32(0.25) * (pd - pw - pdd)
            denom = np.float32(1.5) * pdd
            gated = denom > psm
            tg[:, n] = np.where(gated, psm / np.where(gated, denom, 1.0),
                                np.float32(1.0))
        tgk = tg[np.asarray(k_to_i[:nb])]               # [nb, ns]

        out = np.empty_like(lbuf)
        # all-pass bands: serial over slots (link state), vector over k
        ks = np.arange(nap)
        g_decay = np.clip(1.0 - _DECAY_SLOPE
                          * (ks - PT.DECAY_CUTOFF[is34]), 0.0, 1.0)
        ag = (_A[None, :] * g_decay[:, None]).astype(np.float32)  # [nap,3]
        dbuf = np.concatenate([self.delay[:nap, _MAX_DELAY - 2:],
                               lbuf[:nap, : ns - 2]
                               if ns > 2 else lbuf[:nap, :0]], axis=1)
        ap = np.concatenate([self.ap_delay[:nap],
                             np.zeros((nap, _AP_LINKS, ns), np.complex64)],
                            axis=2)
        for n in range(ns):
            cur = dbuf[:, n] * phi
            for m in range(_AP_LINKS):
                link = ap[:, m, n + 2 - m]
                nxt = link * qf[:, m] - ag[:, m] * cur
                ap[:, m, n + 5] = cur + ag[:, m] * nxt
                cur = nxt
            out[:nap, n] = tgk[:nap, n] * cur
        self.ap_delay[:nap] = ap[:, :, ns:]

        # plain-delay bands
        sd = PT.SHORT_DELAY_BAND[is34]
        full = np.concatenate([self.delay[:nb], lbuf[:, :ns]], axis=1)
        out[nap:sd] = tgk[nap:sd] * full[nap:sd,
                                         _MAX_DELAY - 14: _MAX_DELAY - 14 + ns]
        out[sd:nb] = tgk[sd:nb] * full[sd:nb,
                                       _MAX_DELAY - 1: _MAX_DELAY - 1 + ns]
        self.delay[:nb] = full[:, ns:]
        return out

    # ------------------------------------------------------- mixing

    def _stereo(self, lbuf, rbuf, ps: PsCommon, is34):
        ns = self.n_slots
        nb = PT.NR_BANDS[is34]
        npar = PT.NR_PAR_BANDS[is34]
        nipd = PT.NR_IPDOPD_BANDS[is34]
        k_to_i = np.asarray((PT.K_TO_I_34 if is34 else PT.K_TO_I_20)[:nb])
        lut = _HB if ps.icc_mode >= 3 else _HA

        h_now = self.h_prev
        h_now_im = self.h_prev_im
        if is34 != ps.is34_old:
            # processing grid changed (rare): restate carried H on the
            # new grid — 20->34 by band-edge duplication; 34->20 resets
            # (one-envelope ramp from zero, inaudible at the switch)
            if is34:
                h_now = h_now[:, _MAP_20_TO_34]
                h_now_im = h_now_im[:, _MAP_20_TO_34]
            else:
                h_now = np.zeros_like(h_now)
                h_now_im = np.zeros_like(h_now_im)
        use_ipd = ps.enable_ipdopd and ps.nr_ipdopd_par > 0

        for e in range(ps.num_env):
            iid = _remap(ps.iid_par[e], ps.nr_iid_par, is34)
            icc = _remap(ps.icc_par[e], ps.nr_icc_par, is34)
            h_tgt = np.zeros((4, 34), np.float32)
            h_tgt_im = np.zeros((4, 34), np.float32)
            hv = lut[iid[:npar] + 7 + 23 * ps.iid_quant,
                     np.clip(icc[:npar], 0, 7)]          # [npar, 4]
            h_tgt[:, :npar] = hv.T
            if use_ipd:
                ipd = _remap_ipdopd(ps.ipd_par[e], ps.nr_ipdopd_par, is34)
                opd = _remap_ipdopd(ps.opd_par[e], ps.nr_ipdopd_par, is34)
                for b in range(nipd):
                    opd_idx = (self.opd_hist[b] * 8 + opd[b]) & 0x1FF
                    ipd_idx = (self.ipd_hist[b] * 8 + ipd[b]) & 0x1FF
                    opd_v = _PD_SMOOTH[opd_idx]
                    ipd_v = _PD_SMOOTH[ipd_idx]
                    self.opd_hist[b] = opd_idx & 0x3F
                    self.ipd_hist[b] = ipd_idx & 0x3F
                    adj = opd_v * np.conj(ipd_v)
                    h_tgt_im[0, b] = h_tgt[0, b] * opd_v.imag
                    h_tgt_im[2, b] = h_tgt[2, b] * opd_v.imag
                    h_tgt_im[1, b] = h_tgt[1, b] * adj.imag
                    h_tgt_im[3, b] = h_tgt[3, b] * adj.imag
                    h_tgt[0, b] = h_tgt[0, b] * opd_v.real
                    h_tgt[2, b] = h_tgt[2, b] * opd_v.real
                    h_tgt[1, b] = h_tgt[1, b] * adj.real
                    h_tgt[3, b] = h_tgt[3, b] * adj.real

            start = int(ps.border_position[e])
            stop = int(ps.border_position[e + 1])
            width = np.float32(1.0 / max(stop - start, 1))
            bmap = k_to_i
            h0 = h_now[:, bmap]                          # [4, nb]
            h0i = h_now_im[:, bmap]
            # negative-frequency sub-subbands: conjugated phase — applied
            # to the interpolation START values only (the target is
            # stored un-negated and re-negated when it becomes the next
            # envelope's start), matching the reference decoders
            if use_ipd:
                neg = (np.arange(nb) <= 13) & (np.arange(nb) >= 9) \
                    if is34 else (np.arange(nb) <= 1)
                h0i = np.where(neg[None, :], -h0i, h0i)
            ht = h_tgt[:, bmap]
            hti = h_tgt_im[:, bmap]
            step = (ht - h0) * width
            stepi = (hti - h0i) * width
            t = np.arange(1, stop - start + 1, dtype=np.float32)
            hh = h0[:, :, None] + step[:, :, None] * t[None, None, :]
            sl = slice(start + 1, stop + 1)
            l = lbuf[:, sl].copy()       # the mixes write back in place
            r = rbuf[:, sl].copy()
            if use_ipd:
                hhi = h0i[:, :, None] + stepi[:, :, None] * t[None, None, :]
                h11 = hh[0] + 1j * hhi[0]
                h12 = hh[1] + 1j * hhi[1]
                h21 = hh[2] + 1j * hhi[2]
                h22 = hh[3] + 1j * hhi[3]
                lbuf[:, sl] = h11 * l + h21 * r
                rbuf[:, sl] = h12 * l + h22 * r
            else:
                lbuf[:, sl] = hh[0] * l + hh[2] * r
                rbuf[:, sl] = hh[1] * l + hh[3] * r
            h_now = h_tgt
            h_now_im = h_tgt_im

        self.h_prev = h_now.copy()
        self.h_prev_im = h_now_im.copy()

    # -------------------------------------------------------- apply

    def apply(self, x: np.ndarray, lookahead: np.ndarray, ps: PsCommon,
              top: int):
        """Mono QMF frame -> (L, R); ``top`` = kx + m (bands above are
        zero and their decorrelator state is cleared, aacps.c)."""
        ns = self.n_slots
        is34 = ps.is34
        if is34 != ps.is34_old:
            self.peak_decay_nrg[:] = 0
            self.power_smooth[:] = 0
            self.peak_decay_diff_smooth[:] = 0
            self.delay[:] = 0
            self.ap_delay[:] = 0
            self.opd_hist[:] = 0
            self.ipd_hist[:] = 0

        nb = PT.NR_BANDS[is34]
        topb = min(max(top + nb - 64, 0), nb)
        self.delay[topb:] = 0
        if topb < PT.NR_ALLPASS_BANDS[is34]:
            self.ap_delay[topb:] = 0

        buf = np.concatenate(
            [self.in_hist, x.astype(np.complex64),
             lookahead.astype(np.complex64)], axis=0)
        self.in_hist = buf[ns: ns + 12].copy()

        lbuf = self._hybrid_analysis(buf, is34)
        rbuf = self._decorrelate(lbuf, is34)
        self._stereo(lbuf, rbuf, ps, is34)
        return (self._hybrid_synthesis(lbuf, is34),
                self._hybrid_synthesis(rbuf, is34))


# ------------------------------------------------- filter primitives

def _filter13(win, filt):
    """win [ns, 13] complex x filt [nq, 7] -> [ns, nq] complex.

    13-tap conjugate-symmetric filter: sum over j<6 of
    f_j*(w_j + w_{12-j}) using re, f_im*(w_{12-j} - w_j)... matched to
    libavcodec's ps_hybrid_analysis_c pairing:
      re += f_re*(w0r + w12r) - f_im*(w0i - w12i)
      im += f_re*(w0i + w12i) + f_im*(w0r - w12r)
    plus the real centre tap f6_re * w6."""
    w0 = win[:, :6]                       # [ns, 6]
    w12 = win[:, 12:6:-1]                 # taps 12..7
    fre = filt.real[:, :6]                # [nq, 6]
    fim = filt.imag[:, :6]
    sre = ((w0.real + w12.real) @ fre.T - (w0.imag - w12.imag) @ fim.T
           + np.outer(win[:, 6].real, filt.real[:, 6]))
    sim = ((w0.imag + w12.imag) @ fre.T + (w0.real - w12.real) @ fim.T
           + np.outer(win[:, 6].imag, filt.real[:, 6]))
    return (sre + 1j * sim).astype(np.complex64)


def _filter13_real_even(win):
    """Centre tap of the real 2-way split (g1_Q2: in-phase part)."""
    return (_G1_Q2[6] * win[:, 6]).astype(np.complex64)


def _filter13_real_odd(win):
    """Odd taps of g1_Q2: sum f_{j} (w_j + w_{12-j}) for j in 1,3,5."""
    acc = np.zeros(win.shape[0], np.complex64)
    for j in (1, 3, 5):
        acc = acc + _G1_Q2[j] * (win[:, j] + win[:, 12 - j])
    return acc
