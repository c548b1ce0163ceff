"""MPEG-1/2 Audio Layer II codec for classic DAB (ISO/IEC 11172-3).

Decode side covers the reference's embedded kjmp2 fixed-point decoder
(``mp2processor.cpp:38-634``) re-designed as a float/matmul pipeline: bit
parsing on the host, dequantization vectorized, and the polyphase synthesis
filterbank expressed as a [64,32] matrixing matmul + windowed reduction —
the exact shape that maps onto the TPU MXU when batched across frames.

A minimal encoder (fixed allocation) is included for closed-loop golden
fixtures — the reference has no encoder at all (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

from dabbench.gen.audio._mp2_tables import D_FIXED

__all__ = ["Mp2Decoder", "Mp2Encoder", "decode_frame", "frame_size_bytes"]

STEREO, JOINT_STEREO, DUAL_CHANNEL, MONO = 0, 1, 2, 3

SAMPLE_RATES = [44100, 48000, 32000, 0, 22050, 24000, 16000, 0]
BITRATES = [32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384,
            8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]

# Quantizer classes (ISO 11172-3 Table 3-B.4) keyed by number of steps:
# steps -> (grouping flag, code bits).  Grouped classes pack 3 samples
# into one base-`steps` codeword.
QUANT_BY_STEPS = {
    3: (1, 5), 5: (1, 7), 7: (0, 3), 9: (1, 10), 15: (0, 4), 31: (0, 5),
    63: (0, 6), 127: (0, 7), 255: (0, 8), 511: (0, 9), 1023: (0, 10),
    2047: (0, 11), 4095: (0, 12), 8191: (0, 13), 16383: (0, 14),
    32767: (0, 15), 65535: (0, 16),
}


def _rows(n, nbal, steps):
    return n * [(nbal, steps)]


# Bit-allocation tables as the spec prints them — per subband, the number
# of allocation bits and the possible quantizer step counts (allocation
# code c selects steps[c-1]; c == 0 means not transmitted).
# ISO 11172-3 Tables 3-B.2a (sblimit 27) / 3-B.2b (sblimit 30) share rows:
_ALLOC_AB = (
    _rows(3, 4, (3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
                 16383, 32767, 65535))
    + _rows(8, 4, (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                   8191, 65535))
    + _rows(12, 3, (3, 5, 7, 9, 15, 31, 65535))
    + _rows(7, 2, (3, 5, 65535)))
# Tables 3-B.2c (sblimit 8) / 3-B.2d (sblimit 12) share rows:
_ALLOC_CD = (
    _rows(2, 4, (3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
                 16383, 65535))
    + _rows(10, 3, (3, 5, 9, 15, 31, 63, 127)))
# ISO 13818-3 Table B.1 (MPEG-2 LSF, sblimit 30):
_ALLOC_LSF = (
    _rows(4, 4, (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
                 8191, 16383))
    + _rows(7, 3, (3, 5, 9, 15, 31, 63, 127))
    + _rows(19, 2, (3, 5, 9)))


def _alloc_table(bitrate_per_ch: int, sample_rate: int):
    """MPEG-1 allocation-table selection (ISO 11172-3 §2.4.2.6, the a/b/c/d
    applicability columns of Tables 3-B.2): returns (rows, sblimit)."""
    if bitrate_per_ch <= 48:
        return (_ALLOC_CD, 12) if sample_rate == 32000 else (_ALLOC_CD, 8)
    if bitrate_per_ch <= 80 or sample_rate == 48000:
        return _ALLOC_AB, 27
    return _ALLOC_AB, 30

#: ISO synthesis window (Table 3-B.3), float.
D = np.array(D_FIXED, np.float64) / 65536.0
#: Analysis window (Table 3-C.1) = D / 32.
C = D / 32.0


@functools.lru_cache(maxsize=None)
def _synthesis_matrix() -> np.ndarray:
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64)


@functools.lru_cache(maxsize=None)
def _analysis_matrix() -> np.ndarray:
    i = np.arange(32)[:, None]
    j = np.arange(64)[None, :]
    return np.cos((2 * i + 1) * (j - 16) * np.pi / 64)


def _scale_value(sf: int) -> float:
    return 0.0 if sf == 63 else 2.0 ** (1.0 - sf / 3.0)


class _BitReader:
    def __init__(self, data: np.ndarray, bitpos: int = 0):
        self.bits = np.unpackbits(np.asarray(data, np.uint8))
        self.pos = bitpos

    def u(self, n: int) -> int:
        v = 0
        for b in self.bits[self.pos: self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v


def _read_fields(bits: np.ndarray, starts: np.ndarray,
                 widths: np.ndarray) -> np.ndarray:
    """Extract many MSB-first bit fields from an unpacked bit array in one
    vectorized pass (the per-field Python loop was the receiver's single
    hottest host function before this: 600k+ np.arange calls per second of
    MP2 audio)."""
    n = len(starts)
    if n == 0:
        return np.zeros(0, np.int64)
    W = int(widths.max())
    j = np.arange(W)
    idx = starts[:, None] + j[None, :]
    valid = j[None, :] < widths[:, None]
    need = int(idx.max()) + 1
    if need > bits.shape[0]:          # truncated frame: missing bits read 0
        bits = np.concatenate([bits, np.zeros(need - bits.shape[0],
                                              bits.dtype)])
    vals = bits[idx].astype(np.int64)
    weights = np.where(valid,
                       np.left_shift(1, np.maximum(
                           widths[:, None] - 1 - j[None, :], 0)), 0)
    return (vals * weights * valid).sum(axis=1)


def frame_size_bytes(bitrate_kbps: int, sample_rate: int,
                     padding: int = 0) -> int:
    return 144000 * bitrate_kbps // sample_rate + padding


@dataclasses.dataclass
class FrameInfo:
    mpeg2: bool
    bitrate: int
    sample_rate: int
    mode: int
    frame_size: int


def parse_header(frame: np.ndarray) -> Optional[FrameInfo]:
    if frame[0] != 0xFF or (frame[1] & 0xF6) != 0xF4:
        return None
    if not (0x10 <= frame[2] < 0xF0):
        return None
    mpeg2 = (int(frame[1]) & 0x08) == 0
    bri = (int(frame[2]) >> 4) - 1
    sfi = (int(frame[2]) >> 2) & 3
    if sfi == 3 or bri < 0:
        return None
    bitrate = BITRATES[bri + (14 if mpeg2 else 0)]
    rate = SAMPLE_RATES[sfi + (4 if mpeg2 else 0)]
    padding = (int(frame[2]) >> 1) & 1
    mode = (int(frame[3]) >> 6) & 3
    return FrameInfo(mpeg2, bitrate, rate, mode,
                     frame_size_bytes(bitrate, rate, padding))


class _SynthesisState:
    """Polyphase synthesis state (ISO 11172-3 §2.4.3.3), kept as the 15
    most recent 64-sample matrixing blocks per channel (oldest first) so a
    whole frame's 36 granules synthesize in one batched pass."""

    def __init__(self):
        self.chron = np.zeros((2, 15, 64), np.float64)

    def run_batch(self, S: np.ndarray) -> np.ndarray:
        """``S``: [G, 2, 32] subband granules -> [G*32, 2] PCM float.

        Equivalent to G sequential runs of the classic 1024-sample rolling
        V-buffer: V blocks become rows of a chronological [2, 15+G, 64]
        array; each granule's 512-sample U vector is assembled from its 16
        newest blocks (first half of even blocks, second half of odd — the
        ±96 shifting of the spec) via a sliding window, then windowed by D
        and folded.  Ref: mp2processor.cpp:38-634 (kjmp2 synthesis)."""
        from numpy.lib.stride_tricks import sliding_window_view
        G = S.shape[0]
        n = _synthesis_matrix()
        new = np.einsum('ks,gcs->cgk', n, S)             # [2, G, 64]
        chron = np.concatenate([self.chron, new], axis=1)
        win = sliding_window_view(chron, 16, axis=1)     # [2, G, 64, 16]
        nf = win[..., ::-1].transpose(0, 1, 3, 2)        # newest-first
        u = np.concatenate([nf[:, :, 0::2, :32],
                            nf[:, :, 1::2, 32:]], axis=-1)
        w = u.reshape(2, G, 512) * D
        pcm = -(w.reshape(2, G, 16, 32).sum(axis=2))     # [2, G, 32]
        self.chron = chron[:, -15:].copy()
        return pcm.transpose(1, 2, 0).reshape(G * 32, 2)


class _SynthesisStateRef:
    """1024-sample rolling V buffer per channel — the scalar reference the
    batched _SynthesisState is differentially tested against."""

    def __init__(self):
        self.V = np.zeros((2, 1024), np.float64)
        self.off = 64

    def run(self, s: np.ndarray) -> np.ndarray:
        """``s``: [2, 32] subband samples -> [32, 2] PCM float (-1..1)."""
        self.off = (self.off - 64) & 1023
        n = _synthesis_matrix()
        out = np.empty((32, 2))
        for ch in range(2):
            self.V[ch, self.off: self.off + 64] = n @ s[ch]
            # build U from V with the standard shifting
            u = np.empty(512)
            for i in range(8):
                base = (self.off + (i << 7)) & 1023
                u[(i << 6):(i << 6) + 32] = self.V[ch][(base + np.arange(32))
                                                       & 1023]
                u[(i << 6) + 32:(i << 6) + 64] = \
                    self.V[ch][(base + 96 + np.arange(32)) & 1023]
            w = u * D
            out[:, ch] = -w.reshape(16, 32).sum(axis=0)
        return out


_SCFSI_COUNT = {0: 3, 1: 2, 2: 1, 3: 2}


def decode_frame(frame: np.ndarray, state: Optional[_SynthesisState] = None
                 ) -> Tuple[Optional[np.ndarray], Optional[FrameInfo]]:
    """Decode one Layer II frame -> (pcm int16 [1152, 2], info).

    Vectorized: the bit stream is parsed in four staged `_read_fields`
    passes (allocation -> scfsi -> scalefactors -> all 12 granule-groups
    of samples, whose layout repeats exactly once the allocation is
    known), dequantization is one array expression, and synthesis runs
    all 36 granules in a single batched filterbank pass.  ~50x faster
    than the per-bit reader it replaced; differentially tested against
    `_decode_frame_ref` (tests/test_audio.py).
    """
    info = parse_header(frame)
    if info is None:
        return None, None
    frame = np.asarray(frame, np.uint8)
    bits = np.unpackbits(frame)
    protection = int(frame[1]) & 1
    mode = (int(frame[3]) >> 6) & 3
    bound = 32
    if mode == JOINT_STEREO:
        bound = (((int(frame[3]) >> 4) & 3) + 1) << 2
    elif mode == MONO:
        bound = 0
    pos = 32 + (16 if protection == 0 else 0)

    nch = 1 if mode == MONO else 2
    if info.mpeg2:
        rows, sblimit = _ALLOC_LSF, 30
    else:
        rows, sblimit = _alloc_table(info.bitrate // nch, info.sample_rate)
    bound = min(bound, sblimit)

    # ---- stage 1: allocation codes (widths known from the table alone)
    widths, read_sb = [], []
    for sb in range(bound):
        widths += [rows[sb][0]] * 2
        read_sb += [sb, sb]
    for sb in range(bound, sblimit):
        widths.append(rows[sb][0])
        read_sb.append(sb)
    w = np.asarray(widths, np.int64)
    starts = pos + np.concatenate([[0], np.cumsum(w)[:-1]])
    codes = _read_fields(bits, starts, w)
    pos += int(w.sum())

    nlev = np.zeros((2, 32), np.int64)
    i = 0
    for sb in range(bound):
        for ch in range(2):
            c = int(codes[i]); i += 1
            if c:
                nlev[ch, sb] = rows[sb][1][c - 1]
    for sb in range(bound, sblimit):
        c = int(codes[i]); i += 1
        if c:
            nlev[0, sb] = nlev[1, sb] = rows[sb][1][c - 1]

    # ---- stage 2: scfsi (2 bits per transmitted subband/channel)
    sel = [(ch, sb) for sb in range(sblimit) for ch in range(nch)
           if nlev[ch, sb]]
    n2 = len(sel)
    v2 = _read_fields(bits, pos + 2 * np.arange(n2), np.full(n2, 2))
    pos += 2 * n2
    scfsi = np.zeros((2, 32), np.int64)
    for (ch, sb), v in zip(sel, v2):
        scfsi[ch, sb] = v
    if mode == MONO:
        scfsi[1] = scfsi[0]

    # ---- stage 3: scalefactors (all 6-bit; count set by scfsi pattern)
    n3 = sum(_SCFSI_COUNT[int(scfsi[ch, sb])] for ch, sb in sel)
    v6 = _read_fields(bits, pos + 6 * np.arange(n3), np.full(n3, 6))
    pos += 6 * n3
    sf = np.zeros((2, 32, 3), np.int64)
    i = 0
    for ch, sb in sel:
        s = int(scfsi[ch, sb])
        if s == 0:
            sf[ch, sb] = v6[i:i + 3]; i += 3
        elif s == 1:
            sf[ch, sb] = (v6[i], v6[i], v6[i + 1]); i += 2
        elif s == 2:
            sf[ch, sb] = (v6[i],) * 3; i += 1
        else:
            sf[ch, sb] = (v6[i], v6[i + 1], v6[i + 1]); i += 2
    if mode == MONO:
        sf[1] = sf[0]

    # ---- stage 4: samples.  Every one of the 12 granule-groups has the
    # identical field layout, so one extraction covers the whole frame.
    ent = []                  # (ch or None=shared, sb, nlevels, grouped, fi)
    w1: List[int] = []
    for sb in range(bound):
        for ch in range(2):
            n = int(nlev[ch, sb])
            if n == 0:
                continue
            grouped, nbits = QUANT_BY_STEPS[n]
            ent.append((ch, sb, n, grouped, len(w1)))
            w1 += [nbits] if grouped else [nbits] * 3
    for sb in range(bound, sblimit):
        n = int(nlev[0, sb])
        if n == 0:
            continue
        grouped, nbits = QUANT_BY_STEPS[n]
        ent.append((None, sb, n, grouped, len(w1)))
        w1 += [nbits] if grouped else [nbits] * 3
    wa = np.asarray(w1, np.int64)
    W1 = int(wa.sum())
    off1 = np.concatenate([[0], np.cumsum(wa)[:-1]])
    starts = (pos + np.arange(12)[:, None] * W1 + off1[None, :]).ravel()
    raw = _read_fields(bits, starts, np.tile(wa, 12)).reshape(12, len(wa))

    scale = np.where(sf == 63, 0.0, 2.0 ** (1.0 - sf / 3.0))  # [2, 32, 3]
    part = np.arange(12) // 4
    s_all = np.zeros((12, 2, 32, 3))
    for ch, sb, n, grouped, fi in ent:
        if grouped:
            val = raw[:, fi]
            v = np.stack([val % n, (val // n) % n,
                          val // (n * n)], axis=-1).astype(np.float64)
        else:
            v = raw[:, fi:fi + 3].astype(np.float64)
        frac = ((((n + 1) >> 1) - 1) - v) / ((n + 1) / 2.0)
        if ch is None:        # shared samples, per-channel scalefactors
            s_all[:, 0, sb] = frac * scale[0, sb, part, None]
            s_all[:, 1, sb] = frac * scale[1, sb, part, None]
        else:
            s_all[:, ch, sb] = frac * scale[ch, sb, part, None]

    state = state or _SynthesisState()
    granules = s_all.transpose(0, 3, 1, 2).reshape(36, 2, 32)
    pcm = state.run_batch(granules)
    out = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
    return out, info


def _decode_frame_ref(frame: np.ndarray,
                      state: Optional[_SynthesisStateRef] = None
                      ) -> Tuple[Optional[np.ndarray], Optional[FrameInfo]]:
    """Scalar per-bit reference decoder (the original implementation),
    kept for differential testing of the vectorized `decode_frame`.

    Layer II frames carry 36 samples x 32 subbands = 1152 PCM frames
    (MPEG-1) — DAB uses 48 kHz MPEG-1 or 24 kHz MPEG-2 LSF, both 1152.
    """
    info = parse_header(frame)
    if info is None:
        return None, None
    r = _BitReader(frame)
    r.pos = 16  # past syncword/version/layer/protection
    protection = frame[1] & 1
    r.u(4)  # bitrate index
    r.u(2)  # sampling freq
    r.u(1)  # padding
    r.u(1)  # private
    mode = r.u(2)
    r.u(2)  # mode extension (bound) -- re-read below if joint stereo
    bound = 32
    if mode == JOINT_STEREO:
        r.pos -= 2
        bound = (r.u(2) + 1) << 2
    elif mode == MONO:
        bound = 0
    r.u(4)  # copyright/original/emphasis
    if protection == 0:
        r.u(16)

    nch = 1 if mode == MONO else 2
    if info.mpeg2:
        rows, sblimit = _ALLOC_LSF, 30
    else:
        rows, sblimit = _alloc_table(info.bitrate // nch, info.sample_rate)
    bound = min(bound, sblimit)

    def read_alloc(sb: int):
        nbal, steps = rows[sb]
        code = r.u(nbal)
        if code == 0:
            return None
        n = steps[code - 1]
        grouping, bits = QUANT_BY_STEPS[n]
        return n, grouping, bits

    alloc = [[None] * 32, [None] * 32]
    for sb in range(bound):
        for ch in range(2):
            alloc[ch][sb] = read_alloc(sb)
    for sb in range(bound, sblimit):
        alloc[0][sb] = alloc[1][sb] = read_alloc(sb)

    scfsi = np.zeros((2, 32), np.int64)
    for sb in range(sblimit):
        for ch in range(nch):
            if alloc[ch][sb]:
                scfsi[ch][sb] = r.u(2)
        if mode == MONO:
            scfsi[1][sb] = scfsi[0][sb]

    sf = np.zeros((2, 32, 3), np.int64)
    for sb in range(sblimit):
        for ch in range(nch):
            if alloc[ch][sb]:
                s = scfsi[ch][sb]
                if s == 0:
                    sf[ch, sb] = [r.u(6), r.u(6), r.u(6)]
                elif s == 1:
                    a, b = r.u(6), r.u(6)
                    sf[ch, sb] = [a, a, b]
                elif s == 2:
                    a = r.u(6)
                    sf[ch, sb] = [a, a, a]
                else:
                    a, b = r.u(6), r.u(6)
                    sf[ch, sb] = [a, b, b]
        if mode == MONO:
            sf[1, sb] = sf[0, sb]

    def read_samples(q, sfv: int) -> np.ndarray:
        if q is None:
            return np.zeros(3)
        nlevels, grouping, bits = q
        if grouping:
            val = r.u(bits)
            v = np.array([val % nlevels, (val // nlevels) % nlevels,
                          val // (nlevels * nlevels)], np.float64)
        else:
            v = np.array([r.u(bits) for _ in range(3)], np.float64)
        adj = ((nlevels + 1) >> 1) - 1
        frac = (adj - v) / ((nlevels + 1) / 2.0)
        return frac * _scale_value(sfv)

    state = state or _SynthesisStateRef()
    pcm = np.empty((36 * 32, 2), np.float64)
    pos = 0
    for part in range(3):
        for gr in range(4):
            s = np.zeros((2, 32, 3))
            for sb in range(bound):
                for ch in range(2):
                    s[ch, sb] = read_samples(alloc[ch][sb], sf[ch, sb, part])
            for sb in range(bound, sblimit):
                v = read_samples(alloc[0][sb], sf[0, sb, part])
                s[0, sb] = v
                s[1, sb] = v
            for idx in range(3):
                pcm[pos:pos + 32] = state.run(s[:, :, idx])
                pos += 32
    out = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
    return out, info


class Mp2Decoder:
    """Stateful DAB MP2 elementary-stream decoder (one subchannel).

    Feed decoded logical-frame bits/bytes; performs the bit-level frame sync
    of the reference (mp2processor.cpp:572-617) and yields PCM.
    """

    def __init__(self, es_dump_path: "str | None" = None):
        self._buf = b""
        self._state = _SynthesisState()
        self.frames_ok = 0
        self.frames_bad = 0
        self.sample_rate = 48000
        # raw .mp2 elementary-stream tap (mp2processor.cpp:581-583)
        self._es_dump = open(es_dump_path, "wb") if es_dump_path else None

    def add_bytes(self, data: bytes) -> List[np.ndarray]:
        if self._es_dump is not None:
            self._es_dump.write(data)
            self._es_dump.flush()
        self._buf += data
        out = []
        while True:
            idx = self._find_sync()
            if idx is None:
                return out
            if idx:
                self._buf = self._buf[idx:]
            frame = np.frombuffer(self._buf, np.uint8)
            info = parse_header(frame)
            if info is None or info.frame_size > len(self._buf):
                if info is None:
                    self._buf = self._buf[1:]
                    continue
                return out
            pcm, info = decode_frame(frame[:info.frame_size], self._state)
            self._buf = self._buf[info.frame_size:]
            if pcm is None:
                self.frames_bad += 1
            else:
                self.frames_ok += 1
                self.sample_rate = info.sample_rate
                out.append(pcm)

    def _find_sync(self) -> Optional[int]:
        b = np.frombuffer(self._buf, np.uint8)
        if b.shape[0] < 4:
            return None
        hits = np.flatnonzero((b[:-3] == 0xFF) & ((b[1:-2] & 0xF6) == 0xF4))
        return int(hits[0]) if hits.size else None


# --------------------------------------------------------------- encoder

class Mp2Encoder:
    """Minimal Layer II encoder for golden fixtures (48 kHz MPEG-1).

    Fixed allocation: every coded subband uses the 16-bit quantizer and
    scfsi=2 (one scalefactor per frame part set equal); not rate-optimal,
    but produces fully standard frames a third-party decoder accepts.
    Supported: mode MONO or STEREO at bitrates with table 3-B.2a
    (>=56 kbit/s/channel at 48 kHz).
    """

    def __init__(self, bitrate: int = 192, mode: int = MONO,
                 sample_rate: int = 48000):
        assert sample_rate == 48000
        self.bitrate = bitrate
        self.mode = mode
        self.nch = 1 if mode == MONO else 2
        self._hist = np.zeros((self.nch, 512))
        self.frame_bytes = frame_size_bytes(bitrate, sample_rate)
        # choose how many subbands we can afford at 16-bit quantization
        self._plan_allocation()

    def _plan_allocation(self):
        self.rows, self.sblimit = _alloc_table(self.bitrate // self.nch,
                                               48000)
        budget = self.frame_bytes * 8 - 32  # minus header
        # per coded subband cost: nbal + 2 (scfsi) + 6 (scale) + 36*16
        self.coded_sb = []
        used = 0
        for sb in range(self.sblimit):
            nbal, steps = self.rows[sb]
            # allocation code selecting the 65535-step (16-bit) quantizer
            q_idx = steps.index(65535) + 1 if 65535 in steps else None
            if q_idx is None:
                continue
            cost = (nbal + 2 + 6 + 36 * 16) * self.nch
            base_cost = nbal * self.nch
            if used + cost + base_cost * (self.sblimit - sb) > budget:
                break
            used += cost
            self.coded_sb.append((sb, q_idx, nbal))
        self.coded_set = {sb for sb, _, _ in self.coded_sb}

    def encode(self, pcm: np.ndarray) -> bytes:
        """``pcm``: float (-1..1) [1152] mono or [1152, 2] -> one frame."""
        pcm = np.asarray(pcm, np.float64)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        assert pcm.shape == (1152, self.nch)
        # analysis filterbank: 36 granules of 32 samples per channel
        sub = np.empty((self.nch, 36, 32))
        m = _analysis_matrix()
        for ch in range(self.nch):
            for g in range(36):
                x = pcm[g * 32:(g + 1) * 32, ch][::-1]
                self._hist[ch] = np.concatenate([x, self._hist[ch][:-32]])
                z = self._hist[ch] * C
                y = z.reshape(8, 64).sum(axis=0)
                sub[ch, g] = m @ y
        bits: List[int] = []

        def put(v: int, n: int):
            bits.extend(((v >> (n - 1 - i)) & 1) for i in range(n))

        # header
        put(0xFFF, 12)
        put(1, 1)          # MPEG-1
        put(0b10, 2)       # Layer II
        put(1, 1)          # no CRC
        put(BITRATES.index(self.bitrate) + 1, 4)
        put(1, 2)          # 48 kHz
        put(0, 1)          # padding
        put(0, 1)          # private
        put(self.mode, 2)
        put(0, 2)          # mode ext
        put(0, 4)          # copyright/original/emphasis
        # allocation
        for sb in range(self.sblimit):
            nbal, _ = self.rows[sb]
            q_idx = next((q for s, q, _ in self.coded_sb if s == sb), 0)
            for ch in range(self.nch):
                put(q_idx if sb in self.coded_set else 0, nbal)
        # scfsi
        for sb in range(self.sblimit):
            if sb in self.coded_set:
                for ch in range(self.nch):
                    put(2, 2)
        # scale factors: pick per subband/channel
        sfs = {}
        for sb in range(self.sblimit):
            if sb not in self.coded_set:
                continue
            for ch in range(self.nch):
                peak = np.abs(sub[ch, :, sb]).max() + 1e-12
                sf = 0
                while sf < 62 and _scale_value(sf + 1) > peak:
                    sf += 1
                sfs[(ch, sb)] = sf
                put(sf, 6)
        # samples: 12 groups of 3 granules
        nlevels = 65535
        half = (nlevels + 1) / 2.0
        adj = ((nlevels + 1) >> 1) - 1
        for part in range(3):
            for gr in range(4):
                base = (part * 4 + gr) * 3
                for sb in range(self.sblimit):
                    if sb not in self.coded_set:
                        continue
                    for ch in range(self.nch):
                        sc = _scale_value(sfs[(ch, sb)])
                        for k in range(3):
                            v = sub[ch, base + k, sb] / sc
                            code = int(round(adj - v * half))
                            code = max(0, min(nlevels - 1, code))
                            put(code, 16)
        # pad to frame size
        total = self.frame_bytes * 8
        assert len(bits) <= total, (len(bits), total)
        bits.extend([0] * (total - len(bits)))
        return np.packbits(np.array(bits, np.uint8)).tobytes()
