"""The plain reference receiver: frame rows of u8 IQ -> what the port's
block graph and MSC chain put in their merged blob.

Written from the definitions (ETSI EN 300 401 and the tap formulas the
port documents), in plain PyTorch at float64, one obvious step at a
time: no kernel, no batching trick and nothing of the port.  Only
constant tables (carrier map, phase reference, puncturing vectors,
PRBS, code polynomials) come from the frozen generator copy
``dabbench.gen``, which the transmitter uses too.

``precision="bfloat16"`` is the control: every demodulation step rounds
its result to bfloat16, the nearest precision below the float32 that
the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dabbench.gen.constants import CIF_BITS, CU_BITS, get_mode
from dabbench.gen.fec import conv, prbs, puncture
from dabbench.gen.fic_layout import fic_codewords_per_frame, fic_profile
from dabbench.gen.ofdm import tables

__all__ = ["Reference", "HISTORY", "DELAYS", "FS"]

FS = 2_048_000.0
HISTORY = 15
#: receive-side time de-interleave delay of bit index i mod 16
DELAYS = (15, 7, 11, 3, 13, 5, 9, 1, 14, 6, 10, 2, 12, 4, 8, 0)
_CRC_POLY = 0x1021


def _crc16_ok(fib: np.ndarray) -> bool:
    """FIB [32] bytes: CRC-CCITT (init 0xFFFF) of the first 30 bytes,
    sent inverted in the last two."""
    reg = 0xFFFF
    for byte in fib[:30]:
        reg ^= int(byte) << 8
        for _ in range(8):
            reg = ((reg << 1) ^ _CRC_POLY if reg & 0x8000 else reg << 1)
            reg &= 0xFFFF
    return (reg ^ 0xFFFF) == (int(fib[30]) << 8 | int(fib[31]))


def _profile(protection: str, bitrate: int, level: int):
    if protection == "UEP":
        return puncture.uep_profile(bitrate, level)
    return puncture.eep_profile(bitrate, level, protection[-1])


class Reference:
    """The reference decoder of one configuration on one device."""

    def __init__(self, cfg: Dict, device, precision: str = "float64"):
        if precision not in ("float64", "bfloat16"):
            raise ValueError(precision)
        self.cfg = cfg
        self.p = get_mode(cfg["mode"])
        self.dev = torch.device(device)
        self.precision = precision
        p = self.p
        self.carriers = torch.as_tensor(
            tables.carrier_bins(p.mode, p.T_u, p.K).astype(np.int64),
            device=self.dev)
        self.prs = tables.phase_ref_bins(p.mode, p.T_u, p.K)
        e = conv.expected_bits_table().astype(np.float64)   # [128, 4]
        self.signs = torch.as_tensor(2.0 * e - 1.0, device=self.dev).T

    # ------------------------------------------------------------ demod

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        """The control's rounding after each demodulation step."""
        if self.precision == "float64":
            return x
        if x.is_complex():
            return torch.complex(self._q(x.real), self._q(x.imag))
        return x.to(torch.bfloat16).to(torch.float64)

    def demod(self, rows_u8) -> Dict[str, np.ndarray]:
        """rows [F, >= (L-1) T_s + T_u, 2] u8 starting at the PRS useful
        part -> soft bits [F, L-1, 2K] (integers in +-127) and the taps."""
        p, q = self.p, self._q
        rows = torch.as_tensor(np.asarray(rows_u8), device=self.dev)
        x = (rows.to(torch.float64) - 128.0) / 128.0
        x = q(torch.complex(x[..., 0], x[..., 1]))
        F = x.shape[0]
        # fine CFO: guard of symbol l (l >= 1) against the end of its
        # useful part, T_u later, summed over every data symbol
        corr = torch.zeros(F, dtype=torch.complex128, device=self.dev)
        for l in range(1, p.L):
            g = x[:, l * p.T_s - p.T_g: l * p.T_s]
            r = x[:, l * p.T_s - p.T_g + p.T_u: l * p.T_s + p.T_u]
            corr = q(corr + q(torch.sum(q(g * torch.conj(r)), dim=-1)))
        fine = q(-torch.angle(corr) / math.pi * (p.carrier_diff / 2.0))
        cfo = fine                                   # no coarse offset
        t = torch.arange(p.T_u, dtype=torch.float64, device=self.dev)
        ramp = q(torch.exp(-2j * math.pi * cfo[:, None] * t / FS))
        specs = []
        for l in range(p.L):
            w = q(x[:, l * p.T_s: l * p.T_s + p.T_u] * ramp)
            specs.append(q(torch.fft.fft(w, dim=-1)))
        spec = torch.stack(specs, dim=1)             # [F, L, T_u]
        s = spec[..., self.carriers]                 # [F, L, K]
        rot = q(torch.exp(-2j * math.pi * cfo * p.T_s / FS))[:, None, None]
        r1 = q(q(s[:, 1:] * torch.conj(s[:, :-1])) * rot)
        u = q(r1 / torch.abs(r1))
        soft = torch.round(torch.cat([-u.real * 127.0, -u.imag * 127.0],
                                     dim=-1))
        spec0 = spec[:, 0]
        v = torch.abs(torch.roll(spec0, p.T_u // 2, dims=-1))
        prs_rows = q(x[:, : p.T_u] * ramp)
        t_off, t_ok = self._prs_timing(prs_rows)
        return {"soft": soft.cpu().numpy(),
                "snr": self._snr(v).cpu().numpy(),
                "fine": fine.cpu().numpy(),
                "coarse": self._coarse(spec0).cpu().numpy(),
                "t_off": t_off, "t_ok": t_ok,
                "spectra": v.cpu().numpy(),
                "constel": soft[:, p.fic_symbols].cpu().numpy()}

    def _snr(self, v: torch.Tensor) -> torch.Tensor:
        """Per-frame SNR in dB from |PRS spectrum| centred (the port's
        ``snr_estimate`` formula, after the reference receiver's)."""
        T_u, K = self.p.T_u, self.p.K
        low = T_u // 2 - K // 2
        high = low + K
        sig = v[:, T_u // 2 - K // 4: T_u // 2 + K // 4].mean(dim=-1)
        noise = (v[:, 10: low - 20].sum(dim=-1)
                 + v[:, high + 20: T_u - 10].sum(dim=-1))
        noise = noise / (low - 30 + T_u - high - 30)
        return (20.0 * torch.log10((sig + 1.0) / 256.0)
                - 20.0 * torch.log10((noise + 1.0) / 256.0))

    def _coarse(self, spec0: torch.Tensor, search: int = 35) -> np.ndarray:
        """Whole-carrier CFO: the shift of the PRS band whose adjacent-bin
        products best match the phase reference's."""
        T_u, K = self.p.T_u, self.p.K
        ref = np.roll(self.prs, T_u // 2)
        d_ref = torch.as_tensor(ref[:-1] * np.conj(ref[1:]), device=self.dev)
        sc = torch.roll(spec0, T_u // 2, dims=-1)
        d_rx = sc[:, :-1] * torch.conj(sc[:, 1:])
        lo = T_u // 2 - K // 2
        scores = []
        for k in range(-search, search + 1):
            a = lo + k
            scores.append(torch.abs(torch.sum(
                d_rx[:, a: a + K] * torch.conj(d_ref[lo: lo + K]), dim=-1)))
        best = torch.argmax(torch.stack(scores, dim=-1), dim=-1)
        return best - search

    def _prs_timing(self, w: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Start of the PRS in each window: the peak of the circular
        correlation with the phase reference, and whether it clears 3x
        the mean."""
        ref = torch.as_tensor(np.conj(self.prs), device=self.dev)
        imp = torch.abs(torch.fft.ifft(torch.fft.fft(w, dim=-1) * ref,
                                       dim=-1))
        peak = torch.argmax(imp, dim=-1)
        ok = imp.amax(dim=-1) >= 3.0 * imp.mean(dim=-1)
        return peak.cpu().numpy(), ok.cpu().numpy()

    # ---------------------------------------------------------- Viterbi

    def viterbi(self, soft: np.ndarray, nbits: int) -> np.ndarray:
        """ML decode of the K=7 rate-1/4 code, started and ended in
        state 0: soft [B, 4 (nbits + 6)] (positive means 1) -> bits
        [B, nbits]."""
        T = nbits + 6
        B = soft.shape[0]
        s = torch.as_tensor(soft, dtype=torch.float64,
                            device=self.dev).reshape(B, T, 4)
        pm = torch.full((B, 64), -1e30, dtype=torch.float64, device=self.dev)
        pm[:, 0] = 0.0
        n = torch.arange(64, device=self.dev)
        p0, p1 = n >> 1, (n >> 1) | 32          # r = n and r = n | 64
        dec = torch.empty((T, B, 64), dtype=torch.bool, device=self.dev)
        for c in range(0, T, 256):
            bm = s[:, c: c + 256] @ self.signs           # [B, c, 128]
            for j in range(bm.shape[1]):
                m0 = pm[:, p0] + bm[:, j, :64]
                m1 = pm[:, p1] + bm[:, j, 64:]
                d = m1 > m0
                dec[c + j] = d
                pm = torch.where(d, m1, m0)
        state = torch.zeros(B, dtype=torch.int64, device=self.dev)
        rows = torch.arange(B, device=self.dev)
        out = torch.empty((T, B), dtype=torch.uint8, device=self.dev)
        for t in range(T - 1, -1, -1):
            out[t] = (state & 1).to(torch.uint8)
            d = dec[t, rows, state].to(torch.int64)
            state = (state >> 1) | (d << 5)
        return out[:nbits].T.cpu().numpy()

    def _depuncture(self, soft: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """[B, >= kept] transmitted soft bits -> [B, len(mask)] with 0
        where the mask punctured."""
        kept = int(mask.sum())
        out = np.zeros((soft.shape[0], mask.shape[0]), np.float64)
        out[:, mask.astype(bool)] = soft[:, :kept]
        return out

    # -------------------------------------------------------------- FIC

    def fic(self, soft: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """soft [F, L-1, 2K] -> (FIB bytes [F, n, 30] without their CRC,
        CRC flags [F, n]) for the mode's n FIBs a frame: its FIC symbols
        hold ``fic_codewords_per_frame`` codewords (Mode I 4, II 1, IV
        2), each of 3 FIBs (768 bits)."""
        p = self.p
        F = soft.shape[0]
        n_cw = fic_codewords_per_frame(p)
        blocks, nbits, fibs_per_cw = fic_profile(p)
        cw = soft[:, : p.fic_symbols].reshape(F * n_cw, -1)
        mask = puncture.puncture_mask(blocks, [16, 15])
        bits = self.viterbi(self._depuncture(cw, mask), nbits)
        bits = bits ^ prbs.prbs(nbits)
        fibs = np.packbits(bits.reshape(F, n_cw * fibs_per_cw, 256),
                           axis=-1)                         # [F, n, 32]
        ok = np.array([[_crc16_ok(f) for f in row] for row in fibs])
        return fibs[..., :30], ok

    # -------------------------------------------------------------- MSC

    def cifs(self, soft: np.ndarray) -> np.ndarray:
        """soft [F, L-1, 2K] -> the CIFs [F * cifs_per_frame, 55296] in
        order (Mode I 4 a frame, II 1, IV 2)."""
        p = self.p
        return soft[:, p.fic_symbols:].reshape(-1, CIF_BITS)

    def msc(self, cifs: np.ndarray, services: Sequence[Dict]
            ) -> Dict[int, np.ndarray]:
        """cifs [T, 55296] (T > 15, consecutive, the first 15 the
        history) -> {subch: logical frames [T - 15, 3 bitrate] bytes};
        output t is de-interleaved from CIFs t .. t + 15.  Subchannels of
        one profile decode as one batch."""
        T = cifs.shape[0]
        groups: Dict[Tuple, List[Dict]] = {}
        for s in services:
            key = (s["protection"], s["bitrate"], s["level"])
            groups.setdefault(key, []).append(s)
        out = {}
        for (prot, bitrate, level), group in groups.items():
            de = []
            for s in group:
                lo = s["start_cu"] * CU_BITS
                sub = np.clip(cifs[:, lo: lo + self._cus(s) * CU_BITS],
                              -127, 127)
                d = np.empty((T - HISTORY, sub.shape[1]), np.float64)
                for i in range(16):
                    k = DELAYS[i]
                    d[:, i::16] = sub[HISTORY - k: T - k, i::16]
                de.append(d)
            de = np.stack(de)                        # [n, T - 15, bits]
            mask = puncture.puncture_mask(*_profile(prot, bitrate, level))
            nbits = 24 * bitrate
            soft = self._depuncture(de.reshape(-1, de.shape[-1]), mask)
            bits = self.viterbi(soft, nbits) ^ prbs.prbs(nbits)
            packed = np.packbits(bits, axis=-1).reshape(len(group),
                                                        T - HISTORY, -1)
            for s, frames in zip(group, packed):
                out[s["subch"]] = frames
        return out

    @staticmethod
    def _cus(s: Dict) -> int:
        """Subchannel size in CUs from its profile."""
        if s["protection"] == "UEP":
            from dabbench.gen.fic.fib import PROT_LEVEL_TABLE, \
                _SHORT_FORM_INDEX
            return PROT_LEVEL_TABLE[_SHORT_FORM_INDEX[
                (s["level"], s["bitrate"])]][0]
        lengths, pis = _profile(s["protection"], s["bitrate"], s["level"])
        return puncture.punctured_length(lengths, pis) // CU_BITS


def loop_rows(u8: np.ndarray, p, frames: Sequence[int]) -> np.ndarray:
    """Rows of the loop's frames, each from its PRS useful part on."""
    need = (p.L - 1) * p.T_s + p.T_u
    base = p.T_null + p.T_g
    return np.stack([u8[f * p.T_F + base: f * p.T_F + base + need]
                     for f in frames])


def decode_loop(ref: Reference, u8: np.ndarray, n_frames: int,
                chunk: int = 10) -> Dict:
    """Everything the reference reads from one period of a loop,
    ``n_frames`` frames of its mode: per-frame taps, FIBs and flags, and
    each subchannel's ``cifs_per_frame * n_frames`` logical frames;
    output CIF t's frame is de-interleaved from the loop's CIFs t - 15 ..
    t, cyclically (the stream repeats)."""
    p = ref.p
    parts: List[Dict] = []
    for f0 in range(0, n_frames, chunk):
        d = ref.demod(loop_rows(u8, p, range(f0, min(f0 + chunk,
                                                     n_frames))))
        d["fib"], d["fic_ok"] = ref.fic(d["soft"])
        d["cifs"] = ref.cifs(d["soft"])
        del d["soft"]
        parts.append(d)
    taps = {k: np.concatenate([d[k] for d in parts])
            for k in ("snr", "fine", "coarse", "t_off", "t_ok", "fib",
                      "fic_ok", "spectra", "constel")}
    cifs = np.concatenate([d["cifs"] for d in parts])
    block = np.concatenate([cifs[-HISTORY:], cifs])
    taps["frames"] = ref.msc(block, ref.cfg["services"])
    return taps
