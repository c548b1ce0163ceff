"""Fixture-grade AAC-LC encoder (960 or 1024 transform).

The reference has no encoder — it binds libfaad for decode only.  The
framework needs one to close the DAB+ audio loop the same way the MP2
fixture encoder (dabjax_torch/audio/mp2.py) and the DAB modulator (dabjax_torch/tx/)
close theirs: PCM -> AUs -> superframe -> modulated IQ -> receiver -> PCM.

Deliberately simple but spec-conformant output (ISO/IEC 14496-3 §4.4):
only-long windows, sine shape, one global scalefactor, spectral data in
the escape codebook (11) with zero-codebook sections for empty bands.
Any conformant AAC-LC decoder (including libavcodec at 1024) decodes the
produced raw_data_blocks; tests/test_aac.py cross-checks exactly that.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dabbench.gen.audio import _aac_tables as T
from dabbench.gen.audio.aac_lc import ESC_HCB, ZERO_HCB, _imdct_matrix, \
    _sine_window

__all__ = ["BitWriter", "AacEncoder"]


class BitWriter:
    def __init__(self):
        self._bits: List[int] = []

    def write(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def byte_align(self) -> None:
        while len(self._bits) % 8:
            self._bits.append(0)

    def to_bytes(self) -> bytes:
        self.byte_align()
        arr = np.array(self._bits, np.uint8)
        return np.packbits(arr).tobytes()


# escape-codebook Huffman (encode direction)
_ESC_CODES = T.SPECTRAL_CODES[ESC_HCB - 1]
_ESC_BITS = T.SPECTRAL_BITS[ESC_HCB - 1]
# scalefactor codebook index 60 == delta 0
_SF_ZERO_CODE = T.SCALEFACTOR_CODE[60]
_SF_ZERO_BITS = T.SCALEFACTOR_BITS[60]


def _write_esc_pair(bw: BitWriter, x: int, y: int) -> None:
    ax, ay = abs(x), abs(y)
    idx = min(ax, 16) * 17 + min(ay, 16)
    bw.write(_ESC_CODES[idx], _ESC_BITS[idx])
    for v in (x, y):
        if v != 0:
            bw.write(1 if v < 0 else 0, 1)
    for v in (ax, ay):
        if v >= 16:
            nz = int(v).bit_length() - 5       # v in [2^(nz+4), 2^(nz+5))
            bw.write((1 << nz) - 1, nz)        # nz ones
            bw.write(0, 1)
            bw.write(v - (1 << (nz + 4)), nz + 4)


class AacEncoder:
    """Streaming PCM -> AAC-LC access units.

    ``encode(pcm)`` consumes float PCM in [-1, 1], shape [n] (mono) or
    [n, 2] (stereo), and yields one AU per ``frame_len`` samples.  Uses a
    one-frame lookahead window like any MDCT codec; flush by feeding a
    trailing frame of zeros.
    """

    def __init__(self, sr_index: int, channels: int = 1,
                 frame_len: int = 960, max_q: int = 6000):
        self.sr_index = sr_index
        self.channels = channels
        self.frame_len = frame_len
        # quantization ceiling: must stay under the 8191 escape cap; lower
        # values trade SNR for smaller AUs (to fit superframe bit budgets)
        self.MAX_Q = max_q
        swb = {960: T.SWB_OFFSET_960, 1024: T.SWB_OFFSET_1024}[frame_len]
        num = {960: T.NUM_SWB_960, 1024: T.NUM_SWB_1024}[frame_len]
        self.swb_offset = swb[sr_index]
        self.num_swb = num[sr_index]
        n = frame_len
        self.forward = _imdct_matrix(n) * (2 * n)    # exact TDAC inverse
        w = _sine_window(n)
        self.window = np.concatenate([w, w[::-1]])
        self._hist = np.zeros((n, channels))

    # ----------------------------------------------------------- encoding

    def _quantize(self, spec: np.ndarray) -> tuple:
        """One channel's MDCT spectrum -> (global_gain, q[int])."""
        peak = float(np.max(np.abs(spec)))
        sf = 100
        if peak > 0:
            # need (peak * 2^{-(sf-100)/4})^{3/4} <= MAX_Q
            need = 4.0 * np.log2(max(peak / self.MAX_Q ** (4.0 / 3.0), 1e-12))
            sf = int(np.clip(np.ceil(100 + need), 1, 255))
        scaled = np.abs(spec) * 2.0 ** (-0.25 * (sf - 100))
        q = np.sign(spec) * np.round(scaled ** 0.75)
        return sf, q.astype(np.int64)

    def _write_ics(self, bw: BitWriter, gain: int, q: np.ndarray,
                   common_window: bool) -> None:
        bw.write(gain, 8)                            # global_gain
        if not common_window:
            self._write_ics_info(bw)
        # band types: ESC where any nonzero, ZERO otherwise
        cbs = []
        for b in range(self.num_swb):
            lo, hi = self.swb_offset[b], self.swb_offset[b + 1]
            cbs.append(ESC_HCB if np.any(q[lo:hi]) else ZERO_HCB)
        # section_data: runs, 5-bit lengths with esc 31
        i = 0
        while i < self.num_swb:
            j = i
            while j < self.num_swb and cbs[j] == cbs[i]:
                j += 1
            run = j - i
            bw.write(cbs[i], 4)
            while run >= 31:
                bw.write(31, 5)
                run -= 31
            bw.write(run, 5)
            i = j
        # scale_factor_data: delta 0 per active band
        for cb in cbs:
            if cb != ZERO_HCB:
                bw.write(_SF_ZERO_CODE, _SF_ZERO_BITS)
        bw.write(0, 1)                               # pulse_data_present
        bw.write(0, 1)                               # tns_data_present
        bw.write(0, 1)                               # gain_control_present
        # spectral_data: pairs in band order
        for b, cb in enumerate(cbs):
            if cb == ZERO_HCB:
                continue
            lo, hi = self.swb_offset[b], self.swb_offset[b + 1]
            for k in range(lo, hi, 2):
                _write_esc_pair(bw, int(q[k]), int(q[k + 1]))

    def _write_ics_info(self, bw: BitWriter) -> None:
        bw.write(0, 1)                               # ics_reserved
        bw.write(0, 2)                               # ONLY_LONG_SEQUENCE
        bw.write(0, 1)                               # sine shape
        bw.write(self.num_swb, 6)                    # max_sfb
        bw.write(0, 1)                               # predictor_data_present

    def encode_frame(self, frame: np.ndarray) -> bytes:
        """frame: [frame_len, channels] float -> one raw_data_block."""
        n = self.frame_len
        block = np.concatenate([self._hist, frame], axis=0)  # [2n, ch]
        self._hist = frame.copy()
        bw = BitWriter()
        specs = []
        gains = []
        qs = []
        for c in range(self.channels):
            spec = self.forward @ (self.window * block[:, c] * 32768.0)
            gain, q = self._quantize(spec)
            specs.append(spec)
            gains.append(gain)
            qs.append(q)
        if self.channels == 1:
            bw.write(0, 3)                           # SCE
            bw.write(0, 4)                           # element_instance_tag
            self._write_ics(bw, gains[0], qs[0], common_window=False)
        else:
            bw.write(1, 3)                           # CPE
            bw.write(0, 4)
            bw.write(1, 1)                           # common_window
            self._write_ics_info(bw)
            bw.write(0, 2)                           # ms_mask_present = 0
            self._write_ics(bw, gains[0], qs[0], common_window=True)
            self._write_ics(bw, gains[1], qs[1], common_window=True)
        bw.write(7, 3)                               # END
        return bw.to_bytes()

    def encode(self, pcm: np.ndarray) -> List[bytes]:
        x = np.asarray(pcm, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        assert x.shape[1] == self.channels
        n = self.frame_len
        n_frames = x.shape[0] // n
        return [self.encode_frame(x[i * n: (i + 1) * n])
                for i in range(n_frames)]
