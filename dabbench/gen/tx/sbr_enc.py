"""Fixture-grade HE-AAC (AAC-LC + SBR) bitstream writer.

Builds syntactically valid sbr_extension_data payloads (ISO/IEC 14496-3
§4.4.2.8) and splices them as FIL elements into the AAC-LC fixture
encoder's raw_data_blocks.  The point is conformance testing: libavcodec
decodes the produced HE-AAC stream independently, giving an oracle for
dabjax's own SBR decoder (dabjax_torch/audio/sbr.py) — the same cross-check
pattern used for the AAC-LC core (tests/test_aac.py).  The reference
itself has no encoder; it only decodes HE-AAC via libfaad
(faad-decoder.h:78-165).

The "encoder" makes no psychoacoustic decisions: the caller chooses the
header and per-envelope quantized values; tests sweep them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from dabbench.gen.audio import _sbr_tables as ST
from dabbench.gen.audio.sbr import SbrHeader, derive_tables, FIXFIX
from dabbench.gen.tx.aac_enc import AacEncoder, BitWriter

__all__ = ["SbrWriter", "HeAacEncoder"]


def _enc_book(codes, bits):
    lav = (len(bits) - 1) // 2
    return codes, bits, lav


_F_ENV_30 = _enc_book(ST.F_HUFFMAN_ENV_30_CODES, ST.F_HUFFMAN_ENV_30_BITS)
_F_ENV_15 = _enc_book(ST.F_HUFFMAN_ENV_15_CODES, ST.F_HUFFMAN_ENV_15_BITS)
_F_BAL_30 = _enc_book(ST.F_HUFFMAN_ENV_BAL_30_CODES,
                      ST.F_HUFFMAN_ENV_BAL_30_BITS)
_F_BAL_15 = _enc_book(ST.F_HUFFMAN_ENV_BAL_15_CODES,
                      ST.F_HUFFMAN_ENV_BAL_15_BITS)
_T_ENV_30 = _enc_book(ST.T_HUFFMAN_ENV_30_CODES, ST.T_HUFFMAN_ENV_30_BITS)
_T_ENV_15 = _enc_book(ST.T_HUFFMAN_ENV_15_CODES, ST.T_HUFFMAN_ENV_15_BITS)
_T_NOISE_30 = _enc_book(ST.T_HUFFMAN_NOISE_30_CODES,
                        ST.T_HUFFMAN_NOISE_30_BITS)


def _write_sym(bw: BitWriter, book, delta: int) -> None:
    codes, bits, lav = book
    idx = delta + lav
    if not 0 <= idx < len(bits):
        raise ValueError(f"delta {delta} outside codebook")
    bw.write(int(codes[idx]), int(bits[idx]))


class SbrWriter:
    """Serializes one channel element's SBR data (FIXFIX grids only —
    enough to exercise every decode path except variable borders, which
    tests drive via the raw-bits writer below)."""

    def __init__(self, header: SbrHeader, fs_sbr: int):
        self.header = header
        self.ft = derive_tables(header, fs_sbr)

    # ------------------------------------------------------------ header

    def write_header(self, bw: BitWriter) -> None:
        h = self.header
        bw.write(h.amp_res, 1)
        bw.write(h.start_freq, 4)
        bw.write(h.stop_freq, 4)
        bw.write(h.xover_band, 3)
        bw.write(0, 2)                               # bs_reserved
        bw.write(1, 1)                               # header_extra_1
        bw.write(1, 1)                               # header_extra_2
        bw.write(h.freq_scale, 2)
        bw.write(h.alter_scale, 1)
        bw.write(h.noise_bands, 2)
        bw.write(h.limiter_bands, 2)
        bw.write(h.limiter_gains, 2)
        bw.write(h.interpol_freq, 1)
        bw.write(h.smoothing_mode, 1)

    # -------------------------------------------------------------- data

    def _amp_res(self, num_env: int) -> int:
        return 0 if num_env == 1 else self.header.amp_res

    def write_channel(self, bw: BitWriter, envs: Sequence[np.ndarray],
                      noises: Sequence[np.ndarray], freq_res: int,
                      invf: Sequence[int],
                      add_harmonic: Optional[Sequence[int]] = None,
                      balance: bool = False,
                      skip_grid: bool = False) -> None:
        """FIXFIX grid + dtdf(all-fresh) + invf + envelope + noise."""
        num_env = len(envs)
        assert num_env in (1, 2, 4)
        if not skip_grid:
            bw.write(FIXFIX, 2)
            bw.write({1: 0, 2: 1, 4: 2}[num_env], 2)
            bw.write(freq_res, 1)
        num_noise = 1 if num_env == 1 else 2
        assert len(noises) == num_noise
        for _ in range(num_env):
            bw.write(0, 1)                           # bs_df_env = fresh
        for _ in range(num_noise):
            bw.write(0, 1)                           # bs_df_noise
        if not balance:
            for v in invf:
                bw.write(int(v), 2)
        amp_res = self._amp_res(num_env)
        delta = 2 if balance else 1
        if balance:
            f_book = _F_BAL_30 if amp_res else _F_BAL_15
            start_bits = 5 if amp_res else 6
        else:
            f_book = _F_ENV_30 if amp_res else _F_ENV_15
            start_bits = 6 if amp_res else 7
        nb = self.ft.n(freq_res)
        for env in envs:
            env = np.asarray(env, int)
            assert env.shape[0] == nb, (env.shape, nb)
            assert np.all(env % delta == 0)
            bw.write(int(env[0]) // delta, start_bits)
            for j in range(1, nb):
                _write_sym(bw, f_book, (int(env[j]) - int(env[j - 1]))
                           // delta)
        nq = self.ft.n_q
        n_book = _F_BAL_30 if balance else _F_ENV_30
        for row in noises:
            row = np.asarray(row, int)
            assert row.shape[0] == nq
            assert np.all(row % delta == 0)
            bw.write(int(row[0]) // delta, 5)
            for j in range(1, nq):
                _write_sym(bw, n_book, (int(row[j]) - int(row[j - 1]))
                           // delta)
        if add_harmonic is None:
            bw.write(0, 1)
        else:
            bw.write(1, 1)
            ah = list(add_harmonic)
            assert len(ah) == self.ft.n_high
            for b in ah:
                bw.write(int(b), 1)

    def sce_payload(self, envs, noises, freq_res=0, invf=None,
                    add_harmonic=None, send_header=True,
                    ps_bits=None) -> List[int]:
        """Full sbr_extension_data bit list for one SCE (no CRC).

        ``ps_bits``: optional ps_data bit list (tx/ps_enc.py) carried
        in the bs_extended_data container as EXTENSION_ID_PS."""
        bw = BitWriter()
        bw.write(1 if send_header else 0, 1)
        if send_header:
            self.write_header(bw)
        bw.write(0, 1)                               # bs_data_extra
        if invf is None:
            invf = [0] * self.ft.n_q
        self.write_channel(bw, envs, noises, freq_res, invf, add_harmonic)
        if ps_bits is None:
            bw.write(0, 1)                           # bs_extended_data
        else:
            bw.write(1, 1)
            total = 2 + len(ps_bits)                 # ext_id + ps_data
            cnt = (total + 7) // 8
            if cnt < 15:
                bw.write(cnt, 4)
            else:
                bw.write(15, 4)
                bw.write(cnt - 15, 8)
            bw.write(2, 2)                           # EXTENSION_ID_PS
            for b in ps_bits:
                bw.write(int(b), 1)
            bw.write(0, 8 * cnt - total)             # fill bits
        return bw._bits

    def cpe_payload(self, envs0, noises0, envs1, noises1, freq_res=0,
                    invf=None, coupling=False, add_harmonic0=None,
                    add_harmonic1=None, send_header=True) -> List[int]:
        bw = BitWriter()
        bw.write(1 if send_header else 0, 1)
        if send_header:
            self.write_header(bw)
        bw.write(0, 1)                               # bs_data_extra
        bw.write(1 if coupling else 0, 1)
        if invf is None:
            invf = [0] * self.ft.n_q
        num_env = len(envs0)
        num_noise = 1 if num_env == 1 else 2
        if coupling:
            bw.write(FIXFIX, 2)
            bw.write({1: 0, 2: 1, 4: 2}[num_env], 2)
            bw.write(freq_res, 1)
            for _ in range(2 * num_env):             # dtdf both channels
                bw.write(0, 1)
            for _ in range(2 * num_noise):
                bw.write(0, 1)
            for v in invf:
                bw.write(int(v), 2)
            self._env_noise_only(bw, envs0, noises0, freq_res, False)
            self._env_noise_only(bw, envs1, noises1, freq_res, True)
        else:
            bw.write(FIXFIX, 2)
            bw.write({1: 0, 2: 1, 4: 2}[num_env], 2)
            bw.write(freq_res, 1)
            bw.write(FIXFIX, 2)
            bw.write({1: 0, 2: 1, 4: 2}[num_env], 2)
            bw.write(freq_res, 1)
            for _ in range(2 * num_env):
                bw.write(0, 1)
            for _ in range(2 * num_noise):
                bw.write(0, 1)
            for v in invf:
                bw.write(int(v), 2)
            for v in invf:
                bw.write(int(v), 2)
            self._env_noise_only(bw, envs0, None, freq_res, False)
            self._env_noise_only(bw, envs1, None, freq_res, False)
            self._noise_only(bw, noises0, False)
            self._noise_only(bw, noises1, False)
        for ah in (add_harmonic0, add_harmonic1):
            if ah is None:
                bw.write(0, 1)
            else:
                bw.write(1, 1)
                for b in ah:
                    bw.write(int(b), 1)
        bw.write(0, 1)                               # bs_extended_data
        return bw._bits

    def _env_noise_only(self, bw, envs, noises, freq_res, balance):
        num_env = len(envs)
        amp_res = self._amp_res(num_env)
        delta = 2 if balance else 1
        if balance:
            f_book = _F_BAL_30 if amp_res else _F_BAL_15
            start_bits = 5 if amp_res else 6
        else:
            f_book = _F_ENV_30 if amp_res else _F_ENV_15
            start_bits = 6 if amp_res else 7
        nb = self.ft.n(freq_res)
        for env in envs:
            env = np.asarray(env, int)
            bw.write(int(env[0]) // delta, start_bits)
            for j in range(1, nb):
                _write_sym(bw, f_book, (int(env[j]) - int(env[j - 1]))
                           // delta)
        if noises is not None:
            self._noise_only(bw, noises, balance)

    def _noise_only(self, bw, noises, balance):
        delta = 2 if balance else 1
        n_book = _F_BAL_30 if balance else _F_ENV_30
        for row in noises:
            row = np.asarray(row, int)
            bw.write(int(row[0]) // delta, 5)
            for j in range(1, row.shape[0]):
                _write_sym(bw, n_book, (int(row[j]) - int(row[j - 1]))
                           // delta)


def add_fil_sbr(au: bytes, sbr_bits: List[int]) -> bytes:
    """Splice a FIL(EXT_SBR_DATA) element before the END of an AU.

    The fixture AUs end with the 3-bit END marker followed by byte-align
    padding; rebuild the tail with the FIL in front of it.
    """
    bits = np.unpackbits(np.frombuffer(au, np.uint8)).tolist()
    # strip byte-align zeros, then the END '111'
    while bits and bits[-1] == 0:
        bits.pop()
    assert bits[-3:] == [1, 1, 1], "AU does not end with END"
    body = bits[:-3]
    payload = [1, 1, 0, 1] + list(sbr_bits)          # ext type 13 + data
    n_bytes = (len(payload) + 7) // 8
    payload += [0] * (8 * n_bytes - len(payload))    # bs_fill_bits
    bw = BitWriter()
    bw._bits = list(body)
    bw.write(6, 3)                                   # ID_FIL
    cnt = n_bytes
    if cnt >= 15:
        bw.write(15, 4)
        bw.write(cnt - 14, 8)
    else:
        bw.write(cnt, 4)
    bw._bits.extend(payload)
    bw.write(7, 3)                                   # END
    return bw.to_bytes()


class HeAacEncoder:
    """AAC-LC core + per-AU SBR FIL payloads.

    ``payload_fn(frame_index) -> List[int]`` supplies the SBR bits for
    each AU (tests parameterize envelopes per frame).
    """

    def __init__(self, core_sr_index: int, channels: int, frame_len: int,
                 payload_fn, max_q: int = 6000):
        self.enc = AacEncoder(sr_index=core_sr_index, channels=channels,
                              frame_len=frame_len, max_q=max_q)
        self.payload_fn = payload_fn

    def encode(self, pcm: np.ndarray) -> List[bytes]:
        aus = self.enc.encode(pcm)
        return [add_fil_sbr(au, self.payload_fn(i))
                for i, au in enumerate(aus)]


# ------------------------------------------- variable grids + delta-time

_T_BAL_30 = _enc_book(ST.T_HUFFMAN_ENV_BAL_30_CODES,
                      ST.T_HUFFMAN_ENV_BAL_30_BITS)
_T_BAL_15 = _enc_book(ST.T_HUFFMAN_ENV_BAL_15_CODES,
                      ST.T_HUFFMAN_ENV_BAL_15_BITS)
_T_NOISE_BAL_30 = _enc_book(ST.T_HUFFMAN_NOISE_BAL_30_CODES,
                            ST.T_HUFFMAN_NOISE_BAL_30_BITS)


def _ceil_log2(n: int) -> int:
    return int(np.ceil(np.log2(n))) if n > 1 else 0


class GridSpec:
    """Explicit sbr_grid parameters for the variable frame classes."""

    def __init__(self, frame_class: int, freq_res, pointer: int = 0,
                 var_bord_0: int = 0, var_bord_1: int = 0,
                 rel_0=(), rel_1=()):
        self.frame_class = frame_class
        self.freq_res = list(freq_res)
        self.pointer = pointer
        self.var_bord_0 = var_bord_0
        self.var_bord_1 = var_bord_1
        self.rel_0 = list(rel_0)
        self.rel_1 = list(rel_1)

    @property
    def num_env(self) -> int:
        return len(self.freq_res)

    def write(self, bw: BitWriter) -> None:
        fc, ne = self.frame_class, self.num_env
        bw.write(fc, 2)
        if fc == FIXFIX:
            bw.write({1: 0, 2: 1, 4: 2}[ne], 2)
            bw.write(self.freq_res[0], 1)
            return
        if fc == 1:                                   # FIXVAR
            bw.write(self.var_bord_1, 2)
            bw.write(ne - 1, 2)
            for r in self.rel_1:
                bw.write((r - 2) // 2, 2)
            bw.write(self.pointer, _ceil_log2(ne + 1))
            for f in self.freq_res[::-1]:
                bw.write(f, 1)
        elif fc == 2:                                 # VARFIX
            bw.write(self.var_bord_0, 2)
            bw.write(ne - 1, 2)
            for r in self.rel_0:
                bw.write((r - 2) // 2, 2)
            bw.write(self.pointer, _ceil_log2(ne + 1))
            for f in self.freq_res:
                bw.write(f, 1)
        else:                                         # VARVAR
            bw.write(self.var_bord_0, 2)
            bw.write(self.var_bord_1, 2)
            bw.write(len(self.rel_0), 2)
            bw.write(len(self.rel_1), 2)
            for r in self.rel_0:
                bw.write((r - 2) // 2, 2)
            for r in self.rel_1:
                bw.write((r - 2) // 2, 2)
            bw.write(self.pointer, _ceil_log2(ne + 1))
            for f in self.freq_res:
                bw.write(f, 1)


class SbrStreamWriter:
    """Stateful per-stream SCE writer: variable grids and delta-time
    envelope/noise coding against the previous frame (same freq_res
    across the stream keeps the writer simple; the decoder handles the
    cross-resolution map, which the oracle fuzz exercises via res
    switches between frames of different streams)."""

    def __init__(self, writer: SbrWriter):
        self.w = writer
        self.prev_env = None
        self.prev_res = 1
        self.prev_noise = None

    def _map_idx(self, j: int, res: int, prev_res: int,
                 prev_n: int) -> int:
        """Cross-resolution delta-time index map (decoder's rule)."""
        odd = self.w.ft.n_high & 1
        if res == prev_res:
            k = min(j, prev_n - 1)
        elif res:                                   # cur high, prev low
            k = (j + odd) >> 1
        else:                                       # cur low, prev high
            k = 2 * j - odd if j else 0
        return min(max(k, 0), prev_n - 1)

    def payload(self, grid: GridSpec, envs, noises, invf,
                df_env=None, df_noise=None, add_harmonic=None,
                send_header=True) -> List[int]:
        w = self.w
        amp_res = w.header.amp_res
        if grid.frame_class == FIXFIX and grid.num_env == 1:
            amp_res = 0
        bw = BitWriter()
        bw.write(1 if send_header else 0, 1)
        if send_header:
            w.write_header(bw)
        bw.write(0, 1)                               # bs_data_extra
        grid.write(bw)
        df_env = list(df_env or [0] * grid.num_env)
        num_noise = 1 if grid.num_env == 1 else 2
        df_noise = list(df_noise or [0] * num_noise)
        if self.prev_env is None:
            df_env[0] = 0
        if self.prev_noise is None:
            df_noise[0] = 0
        for b in df_env:
            bw.write(b, 1)
        for b in df_noise:
            bw.write(b, 1)
        for v in invf:
            bw.write(int(v), 2)
        f_book = _F_ENV_30 if amp_res else _F_ENV_15
        t_book = _T_ENV_30 if amp_res else _T_ENV_15
        start_bits = 6 if amp_res else 7
        last, last_res = self.prev_env, self.prev_res
        for e, env in enumerate(envs):
            env = np.asarray(env, int)
            res = grid.freq_res[e]
            if df_env[e]:
                assert last is not None
                for j in range(env.shape[0]):
                    k = self._map_idx(j, res, last_res, last.shape[0])
                    _write_sym(bw, t_book, int(env[j]) - int(last[k]))
            else:
                bw.write(int(env[0]), start_bits)
                for j in range(1, env.shape[0]):
                    _write_sym(bw, f_book, int(env[j]) - int(env[j - 1]))
            last, last_res = env, res
        self.prev_env, self.prev_res = last, last_res
        lastn = self.prev_noise
        for e, row in enumerate(noises):
            row = np.asarray(row, int)
            if df_noise[e]:
                assert lastn is not None
                for j in range(row.shape[0]):
                    _write_sym(bw, _T_NOISE_30, int(row[j]) - int(lastn[j]))
            else:
                bw.write(int(row[0]), 5)
                for j in range(1, row.shape[0]):
                    _write_sym(bw, _F_ENV_30, int(row[j]) - int(row[j - 1]))
            lastn = row
        self.prev_noise = lastn
        if add_harmonic is None:
            bw.write(0, 1)
        else:
            bw.write(1, 1)
            for b in add_harmonic:
                bw.write(int(b), 1)
        bw.write(0, 1)                               # bs_extended_data
        return bw._bits
