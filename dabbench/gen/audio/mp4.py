"""DAB+ superframe processing (ETSI TS 102 563).

Decode side mirrors the reference's ``mp4processor.cpp:71-292``:
five 24 ms logical frames form a superframe; a fire-code over the header
gates alignment (sliding one frame on failure), RS(120,110) runs over
``RSDims = bitrate/8`` column-interleaved codewords, then the header yields
the AU table and each AU is CRC-16 gated.  AAC decoding itself is delegated
to :mod:`dabbench.gen.audio.aac` (the reference binds libfaad, a third-party
codec; see faad-decoder.h:28-165).

Build side (for the modulator) produces valid superframes from raw AU
payload bytes, so the whole DAB+ chain is closed-loop testable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dabbench.gen.fec.crc import (crc16_ccitt, firecode_check, firecode_parity)
from dabbench.gen.fec.rs import rs_decode_batch, rs_encode

__all__ = ["SuperframeDecoder", "build_superframe", "DabPlusHeader",
           "AccessUnit"]


@dataclasses.dataclass
class DabPlusHeader:
    dac_rate: int        # 0 = 32 kHz, 1 = 48 kHz
    sbr_flag: int
    aac_channel_mode: int
    ps_flag: int
    mpeg_surround: int

    @property
    def num_aus(self) -> int:
        return {0: 4, 1: 2, 2: 6, 3: 3}[2 * self.dac_rate + self.sbr_flag]

    @property
    def au_table_start(self) -> int:
        return {0: 8, 1: 5, 2: 11, 3: 6}[2 * self.dac_rate + self.sbr_flag]


@dataclasses.dataclass
class AccessUnit:
    data: bytes
    crc_ok: bool


def _au_crc(msg: np.ndarray) -> bool:
    """AU CRC check: CRC over payload equals inverted stored CRC
    (mp4processor.cpp:40-61)."""
    acc = crc16_ccitt(msg[:-2])
    stored = (~((int(msg[-2]) << 8) | int(msg[-1]))) & 0xFFFF
    return acc == stored


def _au_append_crc(payload: bytes) -> bytes:
    acc = crc16_ccitt(np.frombuffer(payload, np.uint8))
    inv = (~acc) & 0xFFFF
    return payload + bytes([inv >> 8, inv & 0xFF])


class SuperframeDecoder:
    """Stateful DAB+ frame aligner + superframe decoder for one subchannel.

    Feed 24 ms logical frames (as bytes) with :meth:`add_frame`; decoded AUs
    are returned whenever a superframe completes.  Alignment self-heals by
    sliding the 5-frame window on firecode failure
    (mp4processor.cpp:107-143).
    """

    def __init__(self, bitrate: int):
        self.bitrate = bitrate
        self.rs_dims = bitrate // 8
        self.frame_bytes = 3 * bitrate     # 24 ms at bitrate kbps, in bytes
        self._window: List[np.ndarray] = []
        self.superframe_errors = 0
        self.superframes_ok = 0
        self.au_errors = 0
        self.au_count = 0
        self.rs_corrected = 0

    def add_frame(self, frame: np.ndarray) -> List[AccessUnit]:
        frame = np.asarray(frame, np.uint8)
        assert frame.shape == (self.frame_bytes,)
        self._window.append(frame)
        if len(self._window) < 5:
            return []
        buf = np.concatenate(self._window)
        aus = self._try_superframe(buf)
        if aus is None:
            self._window.pop(0)            # slide one frame
            self.superframe_errors += 1
            return []
        self._window.clear()
        self.superframes_ok += 1
        return aus

    # ------------------------------------------------------------- decode

    def _try_superframe(self, buf: np.ndarray) -> Optional[List[AccessUnit]]:
        rd = self.rs_dims
        # column de-interleave: codeword j = buf[j::rd] (120 bytes)
        cws = buf.reshape(120, rd).T           # [rd, 120]
        if not firecode_check(buf[:11]):
            return None
        data, ncorr = rs_decode_batch(cws)
        if (ncorr < 0).any():
            return None
        self.rs_corrected += int(ncorr.sum())
        out = data.T.reshape(-1)               # [rd * 110]
        return self._parse_payload(out)

    def _parse_payload(self, out: np.ndarray) -> Optional[List[AccessUnit]]:
        hdr = DabPlusHeader(
            dac_rate=(out[2] >> 6) & 1,
            sbr_flag=(out[2] >> 5) & 1,
            aac_channel_mode=(out[2] >> 4) & 1,
            ps_flag=(out[2] >> 3) & 1,
            mpeg_surround=out[2] & 7,
        )
        n = hdr.num_aus
        starts = [hdr.au_table_start]
        bit = 24
        for _ in range(n - 1):
            byte = bit // 8
            if bit % 8 == 0:
                starts.append(int(out[byte]) * 16 + (int(out[byte + 1]) >> 4))
            else:
                starts.append((int(out[byte]) & 0xF) * 256
                              + int(out[byte + 1]))
            bit += 12
        starts.append(110 * self.rs_dims)
        self.header = hdr

        aus: List[AccessUnit] = []
        for i in range(n):
            if starts[i + 1] < starts[i]:
                return None
            ln = starts[i + 1] - starts[i] - 2
            if ln < 0 or ln >= 2 * 960 * (self.rs_dims // 6 + 1):
                return None
            au = out[starts[i]: starts[i + 1]]
            self.au_count += 1
            ok = bool(_au_crc(au))
            if not ok:
                self.au_errors += 1
            aus.append(AccessUnit(data=au[:-2].tobytes(), crc_ok=ok))
        return aus


# ------------------------------------------------------------------ build

def build_superframe(bitrate: int, au_payloads: Sequence[bytes],
                     dac_rate: int = 1, sbr_flag: int = 0,
                     aac_channel_mode: int = 1, ps_flag: int = 0,
                     mpeg_surround: int = 0) -> np.ndarray:
    """Build one superframe (5 logical frames of 3*bitrate bytes each).

    ``au_payloads``: AU byte strings *without* CRC; count must match the
    (dac_rate, sbr_flag) configuration.  Returns [5, 3*bitrate] uint8.
    """
    rd = bitrate // 8
    hdr = DabPlusHeader(dac_rate, sbr_flag, aac_channel_mode, ps_flag,
                        mpeg_surround)
    n = hdr.num_aus
    assert len(au_payloads) == n, (len(au_payloads), n)
    payload = np.zeros(110 * rd, np.uint8)
    aus = [_au_append_crc(p) for p in au_payloads[:-1]]
    starts = [hdr.au_table_start]
    for a in aus:
        starts.append(starts[-1] + len(a))
    # the last AU implicitly ends at 110*rd (mp4processor.cpp au_start[n]):
    # zero-pad its payload so the superframe is exactly filled.
    last_room = 110 * rd - starts[-1] - 2
    last = au_payloads[-1]
    assert len(last) <= last_room, f"AUs too large: {len(last)} > {last_room}"
    aus.append(_au_append_crc(last + b"\x00" * (last_room - len(last))))
    # header config byte
    payload[2] = ((dac_rate & 1) << 6) | ((sbr_flag & 1) << 5) | \
                 ((aac_channel_mode & 1) << 4) | ((ps_flag & 1) << 3) | \
                 (mpeg_surround & 7)
    # AU start table: 12-bit entries from bit 24 for AUs 1..n-1
    bit = 24
    for s in starts[1:]:
        byte = bit // 8
        if bit % 8 == 0:
            payload[byte] = (s >> 4) & 0xFF
            payload[byte + 1] |= (s & 0xF) << 4
        else:
            payload[byte] |= (s >> 8) & 0xF
            payload[byte + 1] = s & 0xFF
        bit += 12
    for s, a in zip(starts, aus):
        payload[s: s + len(a)] = np.frombuffer(a, np.uint8)
    # firecode over bytes 2..10 stored in bytes 0..1
    parity = firecode_parity(payload[2:11])
    payload[0] = parity >> 8
    payload[1] = parity & 0xFF
    # RS encode columns and interleave back
    data_cols = payload.reshape(110, rd).T          # [rd, 110]
    cws = rs_encode(data_cols)                      # [rd, 120]
    frame = cws.T.reshape(-1)                       # [120 * rd]
    assert firecode_check(frame[:11])
    return frame.reshape(5, 3 * bitrate)
