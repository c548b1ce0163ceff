"""FIG/FIB encoder — transmitter-side control plane for golden fixtures.

Inverse of :mod:`dabbench.gen.fic.fib` (field layouts cited there against
``fib-processor.cpp``).  The reference has no modulator; SURVEY.md §4 calls
for one to synthesize test ensembles with known payloads.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from dabbench.gen.data import charsets
from dabbench.gen.fec.crc import crc16_append_bits
from dabbench.gen.fic.fib import _SHORT_FORM_INDEX

__all__ = ["ServiceSpec", "build_fib_schedule", "fib_to_bits"]


@dataclasses.dataclass
class ServiceSpec:
    """A service in a synthesized ensemble."""
    label: str
    sid: int
    subch_id: int
    start_addr: int          # CUs
    bitrate: int             # kbps
    protection: str          # "UEP" | "EEP-A" | "EEP-B"
    prot_level: int
    kind: str = "DAB"        # "DAB" | "DAB+" | "packet"
    dscty: int = 60          # packet services: data service component type
    packet_address: int = 1
    fec_scheme: int = 0
    dgflag: int = 0

    @property
    def ascty(self) -> int:
        return 0o77 if self.kind == "DAB+" else 0

    @property
    def length_cus(self) -> int:
        from dabbench.gen.fec import puncture
        if self.protection == "UEP":
            idx = _SHORT_FORM_INDEX.get((self.prot_level, self.bitrate))
            if idx is None:
                raise ValueError(
                    f"no UEP entry for {self.bitrate}kbps P{self.prot_level}")
            from dabbench.gen.fic.fib import PROT_LEVEL_TABLE
            return PROT_LEVEL_TABLE[idx][0]
        profile = self.protection[-1]
        lengths, pis = puncture.eep_profile(self.bitrate, self.prot_level,
                                            profile)
        n = puncture.punctured_length(lengths, pis)
        assert n % 64 == 0
        return n // 64


class _FigWriter:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def raw_bytes(self, data: bytes):
        for b in data:
            self.u(b, 8)

    def to_fig(self, figtype: int) -> bytes:
        assert len(self.bits) % 8 == 0
        body = np.packbits(np.array(self.bits, np.uint8)).tobytes()
        assert len(body) <= 29
        header = (figtype << 5) | len(body)
        return bytes([header]) + body


def _fig0_header(w: _FigWriter, ext: int, pd: int = 0, cn: int = 0):
    w.u(cn, 1)   # C/N
    w.u(0, 1)    # OE
    w.u(pd, 1)   # P/D
    w.u(ext, 5)


def fig0_0(ensemble_id: int, cif_count: int) -> bytes:
    w = _FigWriter()
    _fig0_header(w, 0)
    w.u(ensemble_id, 16)
    w.u(0, 2)                      # change flag
    w.u(0, 1)                      # AL flag
    w.u((cif_count // 250) % 20, 5)
    w.u(cif_count % 250, 8)
    return w.to_fig(0)


def _chunks(seq, n):
    return [seq[i:i + n] for i in range(0, len(seq), n)]


def fig0_1(services: Sequence[ServiceSpec]) -> List[bytes]:
    """Subchannel organization; split over FIGs (max 6 entries each)."""
    figs = []
    for group in _chunks(list(services), 6):
        w = _FigWriter()
        _fig0_header(w, 1)
        for s in group:
            w.u(s.subch_id, 6)
            w.u(s.start_addr, 10)
            if s.protection == "UEP":
                w.u(0, 1)  # short form
                w.u(0, 1)  # table switch
                w.u(_SHORT_FORM_INDEX[(s.prot_level, s.bitrate)], 6)
            else:
                w.u(1, 1)  # long form
                w.u(0 if s.protection.endswith("A") else 1, 3)
                w.u(s.prot_level - 1, 2)
                w.u(s.length_cus, 10)
        figs.append(w.to_fig(0))
    return figs


def fig0_2(services: Sequence[ServiceSpec]) -> List[bytes]:
    """Service organization; split over FIGs (max 5 services each)."""
    figs = []
    for group in _chunks(list(services), 5):
        w = _FigWriter()
        _fig0_header(w, 2)
        for s in group:
            w.u(s.sid, 16)
            w.u(0, 1)   # local flag
            w.u(0, 3)   # CAId
            w.u(1, 4)   # number of components
            if s.kind == "packet":
                w.u(3, 2)                 # TMid packet
                w.u(s.subch_id, 12)       # SCId (reuse subch_id as SCId)
                w.u(0, 1)                 # PS
                w.u(0, 1)                 # CA
            else:
                w.u(0, 2)                 # TMid audio
                w.u(s.ascty, 6)
                w.u(s.subch_id, 6)
                w.u(1, 1)                 # PS (primary)
                w.u(0, 1)                 # CA
        figs.append(w.to_fig(0))
    return figs


def fig0_3(s: ServiceSpec) -> bytes:
    """Packet service component parameters (SCId = subch_id convention)."""
    w = _FigWriter()
    _fig0_header(w, 3)
    w.u(s.subch_id, 12)      # SCId
    w.u(0, 3)                # Rfa
    w.u(0, 1)                # CAOrg flag
    w.u(s.dgflag, 1)         # DG flag
    w.u(0, 1)                # Rfu
    w.u(s.dscty, 6)
    w.u(s.subch_id, 6)
    w.u(s.packet_address, 10)
    w.u(0, 16)               # CAOrg (consumed unconditionally by parser)
    return w.to_fig(0)


def fig0_14(services: Sequence[ServiceSpec]) -> bytes:
    w = _FigWriter()
    _fig0_header(w, 14)
    for s in services:
        w.u(s.subch_id, 6)
        w.u(s.fec_scheme, 2)
    return w.to_fig(0)


def fig1_0(ensemble_id: int, label: str) -> bytes:
    w = _FigWriter()
    w.u(charsets.EBU_LATIN, 4)
    w.u(0, 1)   # OE
    w.u(0, 3)   # ext
    w.u(ensemble_id, 16)
    w.raw_bytes(charsets.encode_ebu_latin(label))
    w.u(0xFF00, 16)  # character flag field
    return w.to_fig(1)


def fig1_1(s: ServiceSpec) -> bytes:
    w = _FigWriter()
    w.u(charsets.EBU_LATIN, 4)
    w.u(0, 1)
    w.u(1, 3)
    w.u(s.sid, 16)
    w.raw_bytes(charsets.encode_ebu_latin(s.label))
    w.u(0xFF00, 16)
    return w.to_fig(1)


def fig1_3(region_id: int, label: str) -> bytes:
    """Region label (fib-processor.cpp:912-920 layout)."""
    w = _FigWriter()
    w.u(charsets.EBU_LATIN, 4)
    w.u(0, 1)
    w.u(3, 3)
    w.u(0, 2)              # rfa
    w.u(region_id, 6)
    w.raw_bytes(charsets.encode_ebu_latin(label))
    w.u(0xFF00, 16)
    return w.to_fig(1)


def fig1_4(sid: int, scids: int, label: str, pd: int = 0) -> bytes:
    """Service component label (fib-processor.cpp:922-940 layout)."""
    w = _FigWriter()
    w.u(charsets.EBU_LATIN, 4)
    w.u(0, 1)
    w.u(4, 3)
    w.u(pd, 1)
    w.u(0, 3)              # rfa
    w.u(scids, 4)
    w.u(sid, 32 if pd else 16)
    w.raw_bytes(charsets.encode_ebu_latin(label))
    w.u(0xFF00, 16)
    return w.to_fig(1)


def fig1_6(sid: int, scids: int, xpad_aid: int, label: str,
           pd: int = 0) -> bytes:
    """X-PAD user application label (fib-processor.cpp:966-994 layout)."""
    w = _FigWriter()
    w.u(charsets.EBU_LATIN, 4)
    w.u(0, 1)
    w.u(6, 3)
    w.u(pd, 1)
    w.u(0, 3)
    w.u(scids, 4)
    w.u(sid, 32 if pd else 16)
    w.u(0, 2)              # rfa
    w.u(0, 1)              # rfu
    w.u(xpad_aid, 5)
    w.raw_bytes(charsets.encode_ebu_latin(label))
    w.u(0xFF00, 16)
    return w.to_fig(1)


def fig2_label(ext: int, sid: int, label: str, sid_bits: int = 16) -> bytes:
    """FIG type 2 label in the reference's layout (process_FIG2,
    fib-processor.cpp:998-1037 — same body as FIG 1)."""
    w = _FigWriter()
    w.u(charsets.EBU_LATIN, 4)
    w.u(0, 1)
    w.u(ext, 3)
    w.u(sid, sid_bits)
    w.raw_bytes(charsets.encode_ebu_latin(label))
    w.u(0xFF00, 16)
    return w.to_fig(2)


def pack_fibs(figs: Sequence[bytes]) -> List[bytes]:
    """Pack FIGs into as many 30-byte FIBs as needed (0xFF end padding)."""
    fibs: List[bytes] = []
    cur = b""
    for fig in figs:
        if len(cur) + len(fig) > 30:
            fibs.append(cur + b"\xff" * (30 - len(cur)))
            cur = b""
        assert len(fig) <= 30
        cur += fig
    fibs.append(cur + b"\xff" * (30 - len(cur)))
    return fibs


def build_fib_schedule(ensemble_id: int, ensemble_label: str,
                       services: Sequence[ServiceSpec],
                       n_fibs: int, cif_count: int = 0) -> List[bytes]:
    """Produce ``n_fibs`` FIBs carrying the full ensemble description.

    The FIG set is rotated/repeated to fill the requested count (a frame in
    Mode I consumes 12 FIBs).
    """
    figs: List[bytes] = [
        fig0_0(ensemble_id, cif_count),
        *fig0_1(services),
        *fig0_2(services),
        fig1_0(ensemble_id, ensemble_label),
    ]
    for s in services:
        figs.append(fig1_1(s))
        if s.kind == "packet":
            figs.append(fig0_3(s))
    if any(s.kind == "packet" for s in services):
        figs.append(fig0_14([s for s in services if s.kind == "packet"]))

    fibs = pack_fibs(figs)
    out = []
    i = 0
    while len(out) < n_fibs:
        out.append(fibs[i % len(fibs)])
        i += 1
    return out


def fib_to_bits(fib: bytes) -> np.ndarray:
    """30-byte FIB -> 256 bits incl. inverted CRC16 (EN 300 401 §5.2.1)."""
    assert len(fib) == 30
    bits = np.unpackbits(np.frombuffer(fib, np.uint8))
    return crc16_append_bits(bits, inverted=True)
