"""DAB ensemble modulator — synthesizes baseband IQ with known payloads.

The inverse pipeline of the receiver (SURVEY.md §4: the reference ships no
tests; a modulator gives closed-loop golden fixtures).  Pure numpy — runs
anywhere, deterministic, and exact w.r.t. the spec constants shared with the
receive path (same tables, same conventions, opposite direction):

    payload bits -> energy dispersal -> conv encode -> puncture
    -> time interleave (MSC) -> CIF/CU placement -> DQPSK -> IFFT + guard

Reference semantics inverted here: ofdm-decoder.cpp:167-206 (DQPSK sign
conventions), msc-handler.cpp:179-192 (CIF layout), dab-concurrent.cpp:41-43
(time de-interleaver delays; TX uses the 15-complement), fic-handler.cpp
(FIC codeword layout).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from dabbench.gen.constants import CU_BITS, CIF_BITS, get_mode
from dabbench.gen.fec import conv, prbs, puncture
from dabbench.gen.ofdm import tables
from dabbench.gen.tx import fig as figmod
from dabbench.gen.tx.fig import ServiceSpec

__all__ = ["Modulator", "ServiceSpec"]

#: Receiver-side de-interleave delays (dab-concurrent.cpp:41-43).
RX_DELAYS = np.array([15, 7, 11, 3, 13, 5, 9, 1, 14, 6, 10, 2, 12, 4, 8, 0])
#: Transmitter-side delays (EN 300 401 table 21): complement to 15.
TX_DELAYS = 15 - RX_DELAYS


def _subch_mask(s: ServiceSpec):
    if s.protection == "UEP":
        lengths, pis = puncture.uep_profile(s.bitrate, s.prot_level)
    else:
        lengths, pis = puncture.eep_profile(s.bitrate, s.prot_level,
                                            s.protection[-1])
    return puncture.puncture_mask(lengths, pis)


class Modulator:
    """Synthesizes IQ frames for a configurable ensemble.

    ``payloads[subch_id]`` maps to a callable ``f(cif_index) -> bits`` giving
    the 24*bitrate logical-frame payload bits for that CIF; defaults to a
    deterministic PRNG keyed by (subch_id, cif_index) so tests can recompute
    the expected bytes.
    """

    def __init__(self, mode: int = 1, ensemble_id: int = 0x8001,
                 ensemble_label: str = "DABJAX ENSEMBLE",
                 services: Sequence[ServiceSpec] = (),
                 payloads: Optional[Dict[int, object]] = None,
                 amplitude: float = 1.0):
        self.p = get_mode(mode)
        self.ensemble_id = ensemble_id
        self.ensemble_label = ensemble_label
        self.services = list(services)
        self.payloads = payloads or {}
        self.amplitude = amplitude
        self._prs_bins = tables.phase_ref_bins(mode, self.p.T_u, self.p.K)
        self._carrier_bins = tables.carrier_bins(mode, self.p.T_u, self.p.K)
        self._masks = {s.subch_id: _subch_mask(s) for s in self.services}
        # encoded-CIF cache: (subch_id, cif_index) -> punctured bits
        self._enc_cache: Dict[tuple, np.ndarray] = {}
        self._validate_layout()

    # ------------------------------------------------------------- layout

    def _validate_layout(self):
        used = np.zeros(864, bool)
        for s in self.services:
            n = s.length_cus
            if used[s.start_addr:s.start_addr + n].any():
                raise ValueError(f"subchannel overlap at {s.label}")
            used[s.start_addr:s.start_addr + n] = True

    # ------------------------------------------------------------ payload

    def payload_bits(self, subch_id: int, cif_index: int) -> np.ndarray:
        """Logical-frame payload for a subchannel at a CIF index."""
        s = next(x for x in self.services if x.subch_id == subch_id)
        n = 24 * s.bitrate
        gen = self.payloads.get(subch_id)
        if gen is not None:
            bits = np.asarray(gen(cif_index), np.uint8)
            assert bits.shape == (n,)
            return bits
        rng = np.random.default_rng((subch_id << 32) | (cif_index & 0xFFFFFFFF))
        return rng.integers(0, 2, n, dtype=np.uint8)

    def _encoded_subch_bits(self, s: ServiceSpec, cif_index: int) -> np.ndarray:
        """Dispersed+encoded+punctured bits for one subchannel/CIF,
        zero-padded to length_cus*64 (the UEP padding bits)."""
        bits = self.payload_bits(s.subch_id, cif_index)
        bits = prbs.disperse(bits)
        coded = conv.encode(bits)
        tx = puncture.puncture(coded, self._masks[s.subch_id])
        out = np.zeros(s.length_cus * CU_BITS, np.uint8)
        out[: tx.shape[0]] = tx
        return out

    def _interleaved_subch_bits(self, s: ServiceSpec,
                                cif_index: int) -> np.ndarray:
        """Apply EN 300 401 time interleaving across 16 logical frames."""
        n = s.length_cus * CU_BITS
        out = np.empty(n, np.uint8)

        def enc(ci: int) -> np.ndarray:
            key = (s.subch_id, ci)
            if key not in self._enc_cache:
                self._enc_cache[key] = self._encoded_subch_bits(s, ci)
            return self._enc_cache[key]

        idx = np.arange(n)
        delays = TX_DELAYS[idx & 15]
        for d in range(16):
            sel = delays == d
            if sel.any():
                out[sel] = enc(cif_index - d)[sel]
        return out

    # ---------------------------------------------------------------- FIC

    def _fic_codewords(self, frame_index: int) -> np.ndarray:
        """(n_cw, 2304) punctured FIC bits for one frame.

        Mode I: 12 FIBs/frame -> 4 codewords of 3 FIBs each
        (fic-handler.cpp:241-302).
        """
        from dabbench.gen.fic_layout import (fic_codewords_per_frame,
                                            fic_profile)
        n_cw = fic_codewords_per_frame(self.p)
        blocks, _, fibs_per_cw = fic_profile(self.p)
        fibs = figmod.build_fib_schedule(
            self.ensemble_id, self.ensemble_label, self.services,
            n_fibs=fibs_per_cw * n_cw,
            cif_count=(frame_index * self.p.cifs_per_frame) % 5000)
        mask = puncture.puncture_mask(blocks, [16, 15])
        out = np.empty((n_cw, mask.sum()), np.uint8)
        for cw in range(n_cw):
            bits = np.concatenate(
                [figmod.fib_to_bits(fibs[cw * fibs_per_cw + k])
                 for k in range(fibs_per_cw)])
            bits = prbs.disperse(bits)
            coded = conv.encode(bits)        # 4*(nbits+6)
            out[cw] = puncture.puncture(coded, mask)
        return out

    # --------------------------------------------------------------- OFDM

    def _symbol_bits(self, frame_index: int, first_cif: int) -> np.ndarray:
        """(L-1, 2K) bit payload of the data symbols of one frame."""
        p = self.p
        bps = p.bits_per_symbol
        fic = self._fic_codewords(frame_index).reshape(-1)
        assert fic.shape[0] == p.fic_symbols * bps
        msc = np.zeros((p.cifs_per_frame, CIF_BITS), np.uint8)
        for c in range(p.cifs_per_frame):
            ci = first_cif + c
            for s in self.services:
                b = self._interleaved_subch_bits(s, ci)
                lo = s.start_addr * CU_BITS
                msc[c, lo:lo + b.shape[0]] = b
        bits = np.concatenate([fic, msc.reshape(-1)])
        assert bits.shape[0] == (p.L - 1) * bps
        return bits.reshape(p.L - 1, bps)

    def _ofdm_frame(self, sym_bits: np.ndarray) -> np.ndarray:
        """Map (L-1, 2K) bits -> T_F time-domain samples."""
        p = self.p
        K, T_u, T_g = p.K, p.T_u, p.T_g
        n_sym = p.L  # PRS + data
        bins = np.zeros((n_sym, T_u), np.complex64)
        bins[0] = self._prs_bins
        re = 1.0 - 2.0 * sym_bits[:, :K].astype(np.float32)
        im = 1.0 - 2.0 * sym_bits[:, K:].astype(np.float32)
        q = (re + 1j * im) / np.sqrt(2.0)
        ref = self._prs_bins[self._carrier_bins]
        for l in range(1, n_sym):
            cur = ref * q[l - 1]
            bins[l, self._carrier_bins] = cur
            ref = cur
        time = np.fft.ifft(bins, axis=-1).astype(np.complex64) * T_u
        # normalize to unit RMS-ish amplitude
        time *= self.amplitude / np.sqrt(K)
        out = np.zeros(p.T_F, np.complex64)
        pos = p.T_null
        for l in range(n_sym):
            out[pos:pos + T_g] = time[l, -T_g:]
            out[pos + T_g:pos + T_g + T_u] = time[l]
            pos += p.T_s
        assert pos == p.T_F
        return out

    # ----------------------------------------------------------- frontend

    def frames(self, n_frames: int, start_frame: int = 0) -> np.ndarray:
        """Synthesize ``n_frames`` consecutive frames of baseband IQ."""
        p = self.p
        out = np.empty(n_frames * p.T_F, np.complex64)
        for f in range(n_frames):
            fi = start_frame + f
            sym_bits = self._symbol_bits(fi, first_cif=fi * p.cifs_per_frame)
            out[f * p.T_F:(f + 1) * p.T_F] = self._ofdm_frame(sym_bits)
        return out

    def iq(self, n_frames: int, snr_db: Optional[float] = None,
           cfo_hz: float = 0.0, sample_offset: int = 0,
           seed: int = 0) -> np.ndarray:
        """Frames plus optional channel impairments for receiver tests."""
        x = self.frames(n_frames)
        if sample_offset:
            x = np.concatenate(
                [np.zeros(sample_offset, np.complex64), x])
        if cfo_hz:
            n = np.arange(x.shape[0])
            x = x * np.exp(2j * np.pi * cfo_hz * n / 2_048_000).astype(
                np.complex64)
        if snr_db is not None:
            rng = np.random.default_rng(seed)
            sig_pow = np.mean(np.abs(x) ** 2)
            noise_pow = sig_pow / (10 ** (snr_db / 10))
            noise = (rng.standard_normal(x.shape[0])
                     + 1j * rng.standard_normal(x.shape[0]))
            x = x + (np.sqrt(noise_pow / 2) * noise).astype(np.complex64)
        return x.astype(np.complex64)
