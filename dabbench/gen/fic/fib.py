"""FIB/FIG parser and ensemble database (ETSI EN 300 401 §6/§8).

Host-side control plane: parses CRC-passed FIBs into an ensemble database
(subchannel organization, service -> component bindings, labels, user
applications, time).  Semantics follow the reference's
``fib-processor.cpp`` (cited per handler); the representation is a plain
Python dataclass DB that the TPU decode plane queries for *static* subchannel
geometry (start address / size / protection) used to build jit-compiled
decode programs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from dabbench.gen.constants import AUDIO_SERVICE, PACKET_SERVICE, UNKNOWN_SERVICE
from dabbench.gen.data import charsets

__all__ = ["EnsembleDB", "Subchannel", "Service", "ServiceComponent",
           "AudioServiceData", "PacketServiceData", "PROT_LEVEL_TABLE"]

#: Short-form (UEP) subchannel table: index -> (size CUs, prot level,
#: bitrate kbps). EN 300 401 table 7 (fib-processor.cpp:32-95).
PROT_LEVEL_TABLE: List[Tuple[int, int, int]] = [
    (16, 5, 32), (21, 4, 32), (24, 3, 32), (29, 2, 32), (35, 1, 32),
    (24, 5, 48), (29, 4, 48), (35, 3, 48), (42, 2, 48), (52, 1, 48),
    (29, 5, 56), (35, 4, 56), (42, 3, 56), (52, 2, 56),
    (32, 5, 64), (42, 4, 64), (48, 3, 64), (58, 2, 64), (70, 1, 64),
    (40, 5, 80), (52, 4, 80), (58, 3, 80), (70, 2, 80), (84, 1, 80),
    (48, 5, 96), (58, 4, 96), (70, 3, 96), (84, 2, 96), (104, 1, 96),
    (58, 5, 112), (70, 4, 112), (84, 3, 112), (104, 2, 112),
    (64, 5, 128), (84, 4, 128), (96, 3, 128), (116, 2, 128), (140, 1, 128),
    (80, 5, 160), (104, 4, 160), (116, 3, 160), (140, 2, 160), (168, 1, 160),
    (96, 5, 192), (116, 4, 192), (140, 3, 192), (168, 2, 192), (208, 1, 192),
    (116, 5, 224), (140, 4, 224), (168, 3, 224), (208, 2, 224), (232, 1, 224),
    (128, 5, 256), (168, 4, 256), (192, 3, 256), (232, 2, 256), (280, 1, 256),
    (160, 5, 320), (208, 4, 320), (280, 2, 320),
    (192, 5, 384), (280, 3, 384), (416, 1, 384),
]

_SHORT_FORM_INDEX = {(lvl, br): i
                     for i, (_, lvl, br) in enumerate(PROT_LEVEL_TABLE)}


class _Bits:
    """MSB-first bit reader over a byte buffer."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    def u(self, bit_offset: int, nbits: int) -> int:
        v = 0
        for i in range(nbits):
            pos = bit_offset + i
            v = (v << 1) | ((self.data[pos >> 3] >> (7 - (pos & 7))) & 1)
        return v

    def bytes_at(self, bit_offset: int, n: int) -> bytes:
        assert bit_offset % 8 == 0
        o = bit_offset // 8
        return self.data[o:o + n]


@dataclasses.dataclass
class Subchannel:
    """Subchannel organization entry (FIG 0/1; fib-processor.cpp:278-347)."""
    subch_id: int = -1
    start_addr: int = 0
    length: int = 0          # CUs
    uep_flag: int = 0        # 0 = short form (UEP), 1 = long form (EEP)
    prot_level: int = 0      # 1..5 (UEP) or 1..4 (EEP)
    eep_profile: str = ""    # "A"/"B" when uep_flag == 1
    bitrate: int = 0         # kbps
    language: int = 0
    fec_scheme: int = 0

    @property
    def protection(self) -> Tuple[str, int]:
        if self.uep_flag:
            return (f"EEP-{self.eep_profile}", self.prot_level)
        return ("UEP", self.prot_level)


@dataclasses.dataclass
class Service:
    sid: int
    label: str = ""
    has_label: bool = False
    program_type: int = 0
    language: int = 0
    has_language: bool = False
    pnum: int = -1


@dataclasses.dataclass
class ServiceComponent:
    tmid: int
    sid: int
    comp_nr: int
    subch_id: int = -1
    ps_flag: int = 0
    ascty: int = -1          # audio: 0 = MP2, 63 = AAC (DAB+)
    scid: int = -1           # packet: service component id
    dscty: int = -1
    dgflag: int = 0
    packet_address: int = -1
    ca_flag: int = 0


@dataclasses.dataclass
class AudioServiceData:
    """Query result mirroring the reference ``audiodata`` struct."""
    subch_id: int
    start_addr: int
    uep_flag: int
    prot_level: int
    eep_profile: str
    length: int
    bitrate: int
    ascty: int
    language: int
    program_type: int

    @property
    def is_dab_plus(self) -> bool:
        return self.ascty == 0o77


@dataclasses.dataclass
class PacketServiceData:
    subch_id: int
    start_addr: int
    uep_flag: int
    prot_level: int
    eep_profile: str
    length: int
    bitrate: int
    dscty: int
    fec_scheme: int
    dgflag: int
    packet_address: int


class EnsembleDB:
    """Ensemble database built from FIGs (the fib_processor equivalent)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.ensemble_id: int = -1
        self.ensemble_label: str = ""
        self.subchannels: Dict[int, Subchannel] = {}
        self.services: Dict[int, Service] = {}
        self.components: List[ServiceComponent] = []
        self.datetime: Optional[Tuple[int, ...]] = None
        self.cif_count: int = -1
        self.lto_halfhours: int = 0
        self.linkage_sets: set = set()
        self.announcements: Dict[int, int] = {}
        self.active_announcements: Dict[int, Tuple[int, int]] = {}
        # label planes beyond the service label (FIG 1 ext 3/4/6;
        # the reference parses these but discards them,
        # fib-processor.cpp:912-994 — here they are kept queryable)
        self.region_labels: Dict[int, str] = {}
        self.component_labels: Dict[Tuple[int, int], str] = {}  # (SId,SCIdS)
        self.xpad_labels: Dict[Tuple[int, int, int], str] = {}  # +XPAD aid

    # ------------------------------------------------------------- ingest

    def process_fib_bytes(self, fib: bytes):
        """Process one 30-byte CRC-passed FIB (fib-processor.cpp:123-158)."""
        d = _Bits(fib)
        pos = 0
        while pos < 30:
            figtype = d.u(pos * 8, 3)
            figlen = d.u(pos * 8 + 3, 5)
            if figtype == 7:
                return
            body = fib[pos:pos + figlen + 1]
            if figtype == 0:
                self._fig0(_Bits(body), figlen)
            elif figtype in (1, 2):
                self._fig1(_Bits(body), figlen)
            pos += figlen + 1

    def process_fib_bits(self, bits: np.ndarray):
        """Process a FIB given as 256 bits (incl. CRC16, already checked)."""
        self.process_fib_bytes(np.packbits(bits[:240]).tobytes())

    # -------------------------------------------------------------- FIG 0

    def _fig0(self, d: _Bits, figlen: int):
        ext = d.u(8 + 3, 5)
        pd = d.u(8 + 2, 1)
        handler = getattr(self, f"_fig0_{ext}", None)
        if handler is not None:
            handler(d, figlen, pd)

    def _fig0_0(self, d: _Bits, figlen: int, pd: int):
        # ensemble info (fib-processor.cpp:241-270)
        self.ensemble_id = d.u(16, 16)
        high = d.u(16 + 19, 5) % 20
        low = d.u(16 + 24, 8) % 250
        self.cif_count = high * 250 + low

    def _fig0_1(self, d: _Bits, figlen: int, pd: int):
        # subchannel organization (fib-processor.cpp:278-347)
        used = 2
        while used < figlen - 1:
            off = used * 8
            subch_id = d.u(off, 6)
            sc = self.subchannels.setdefault(subch_id,
                                             Subchannel(subch_id=subch_id))
            sc.start_addr = d.u(off + 6, 10)
            if d.u(off + 16, 1) == 0:  # short form (UEP)
                idx = d.u(off + 18, 6)
                if idx < len(PROT_LEVEL_TABLE):
                    size, lvl, br = PROT_LEVEL_TABLE[idx]
                    sc.length, sc.prot_level, sc.bitrate = size, lvl, br
                sc.uep_flag = 0
                used += 3
            else:                       # long form (EEP)
                option = d.u(off + 17, 3)
                lvl = d.u(off + 20, 2) + 1
                size = d.u(off + 22, 10)
                sc.uep_flag = 1
                sc.prot_level = lvl
                sc.length = size
                if option == 0:
                    sc.eep_profile = "A"
                    sc.bitrate = size // {1: 12, 2: 8, 3: 6, 4: 4}[lvl] * 8
                else:
                    sc.eep_profile = "B"
                    sc.bitrate = size // {1: 27, 2: 21, 3: 18, 4: 15}[lvl] * 32
                used += 4

    def _fig0_2(self, d: _Bits, figlen: int, pd: int):
        # service organization (fib-processor.cpp:356-418)
        used = 2
        while used < figlen:
            off = used * 8
            if pd:
                sid = d.u(off, 32)
                off += 32
                used += 4
            else:
                sid = d.u(off, 16)
                off += 16
                used += 2
            ncomp = d.u(off + 4, 4)
            off += 8
            used += 1
            svc = self.services.setdefault(sid, Service(sid=sid))
            for i in range(ncomp):
                tmid = d.u(off, 2)
                if tmid == 0:       # audio component
                    self._bind(ServiceComponent(
                        tmid=0, sid=svc.sid, comp_nr=i,
                        ascty=d.u(off + 2, 6),
                        subch_id=d.u(off + 8, 6),
                        ps_flag=d.u(off + 14, 1)))
                elif tmid == 3:     # packet component
                    self._bind(ServiceComponent(
                        tmid=3, sid=svc.sid, comp_nr=i,
                        scid=d.u(off + 2, 12),
                        ps_flag=d.u(off + 14, 1),
                        ca_flag=d.u(off + 15, 1)))
                off += 16
                used += 2

    def _fig0_3(self, d: _Bits, figlen: int, pd: int):
        # packet component parameters (fib-processor.cpp:424-453)
        used = 2
        while used < figlen:
            off = used * 8
            scid = d.u(off, 12)
            dgflag = d.u(off + 16, 1)
            dscty = d.u(off + 18, 6)
            subch_id = d.u(off + 24, 6)
            packet_address = d.u(off + 30, 10)
            used += 7
            comp = self._find_packet_component(scid)
            if comp is not None:
                comp.subch_id = subch_id
                comp.dscty = dscty
                comp.dgflag = dgflag
                comp.packet_address = packet_address

    def _fig0_5(self, d: _Bits, figlen: int, pd: int):
        # language (fib-processor.cpp:455-487)
        used = 2
        while used < figlen:
            off = used * 8
            if d.u(off, 1) == 0:     # short form
                if d.u(off + 1, 1) == 0:
                    subch_id = d.u(off + 2, 6)
                    sc = self.subchannels.setdefault(
                        subch_id, Subchannel(subch_id=subch_id))
                    sc.language = d.u(off + 8, 8)
                used += 2
            else:
                used += 3

    def _fig0_6(self, d: _Bits, figlen: int, pd: int):
        # service linking info: parse-and-skip, recording linkage set
        # numbers (fib-processor.cpp:489-528 skips entirely)
        used = 2
        while used < figlen:
            off = used * 8
            id_list = d.u(off, 1)
            ils = d.u(off + 3, 1)
            lsn = d.u(off + 4, 12)
            self.linkage_sets.add(lsn)
            if id_list == 0:
                off += 16
            else:
                nids = d.u(off + 20, 4)
                if pd == 0 and ils == 0:
                    off += 16 + 4 + 5 + nids * 16
                elif pd == 0:
                    off += 16 + 4 + 4 + nids * 24
                else:
                    off += 16 + 4 + 4 + nids * 32
            prev, used = used, off // 8
            if used <= prev:
                break

    def _fig0_8(self, d: _Bits, figlen: int, pd: int):
        # service component global definition: parse-and-skip
        # (fib-processor.cpp:530-578)
        used = 2
        while used < figlen:
            off = used * 8
            off += 32 if pd else 16
            ext_flag = d.u(off, 1)
            off += 8
            ls_flag = d.u(off + 8, 1)
            off += 16 if ls_flag else 8
            if ext_flag:
                off += 8
            used = off // 8

    def _fig0_9(self, d: _Bits, figlen: int, pd: int):
        # local time offset (fib-processor.cpp:582-589): half-hours
        # relative to UTC, sign bit first
        off = 16
        sign = d.u(off + 2, 1)
        halves = d.u(off + 3, 4)
        self.lto_halfhours = -halves if sign else halves

    def _fig0_10(self, d: _Bits, figlen: int, pd: int):
        # date & time via MJD (fib-processor.cpp:591-627)
        off = 16
        mjd = d.u(off + 1, 17)
        jd = mjd + 2400001
        j = jd + 32044
        g, dg = divmod(j, 146097)
        c = ((dg // 36524) + 1) * 3 // 4
        dc = dg - c * 36524
        b, db = divmod(dc, 1461)
        a = ((db // 365) + 1) * 3 // 4
        da = db - a * 365
        y = g * 400 + c * 100 + b * 4 + a
        m = (da * 5 + 308) // 153 - 2
        day = da - (m + 4) * 153 // 5 + 122
        year, month, dom = y - 4800 + (m + 2) // 12, (m + 2) % 12 + 1, day + 1
        hours = d.u(off + 21, 5)
        minutes = d.u(off + 26, 6)
        utc_flag = d.u(off + 20, 1)
        seconds = d.u(off + 32, 6) if utc_flag else 0
        self.datetime = (year, month, dom, hours, minutes, seconds)

    def _fig0_13(self, d: _Bits, figlen: int, pd: int):
        # user applications (fib-processor.cpp:629-686): parsed and stored
        used = 2
        while used < figlen:
            off = used * 8
            nbits = 32 if pd else 16
            sid = d.u(off, nbits)
            off += nbits
            napps = d.u(off + 4, 4)
            off += 8
            used = off // 8
            svc = self.services.setdefault(sid, Service(sid=sid))
            for _ in range(napps):
                app_type = d.u(off, 11)
                ln = d.u(off + 11, 5)
                off += 16 + 8 * ln
                used = off // 8
                setattr(svc, "user_app", app_type)

    def _fig0_14(self, d: _Bits, figlen: int, pd: int):
        # packet FEC scheme (fib-processor.cpp:688-705)
        used = 2
        while used < figlen:
            subch_id = d.u(used * 8, 6)
            scheme = d.u(used * 8 + 6, 2)
            used += 1
            sc = self.subchannels.get(subch_id)
            if sc is not None:
                sc.fec_scheme = scheme

    def _fig0_16(self, d: _Bits, figlen: int, pd: int):
        # programme number (fib-processor.cpp:706-722)
        off = 16
        while off < figlen * 8:
            sid = d.u(off, 16)
            svc = self.services.setdefault(sid, Service(sid=sid))
            if svc.pnum < 0:
                svc.pnum = d.u(off + 16, 16)
            off += 72

    def _fig0_18(self, d: _Bits, figlen: int, pd: int):
        # announcement support (fib-processor.cpp:750-764): record flags
        off = 16
        while off // 8 < figlen - 1:
            sid = d.u(off, 16)
            asu_flags = d.u(off + 16, 16)
            n_clusters = d.u(off + 35, 5)
            self.announcements[sid] = asu_flags
            off += 40 + n_clusters * 8

    def _fig0_19(self, d: _Bits, figlen: int, pd: int):
        # announcement switching (fib-processor.cpp:766-797): record the
        # active cluster -> subchannel mapping
        off = 16
        while off // 8 < figlen - 1:
            cluster = d.u(off, 8)
            asw_flags = d.u(off + 8, 16)
            region_flag = d.u(off + 25, 1)
            subch_id = d.u(off + 26, 6)
            self.active_announcements[cluster] = (asw_flags, subch_id)
            off += 40 if region_flag else 32

    def _fig0_21(self, d: _Bits, figlen: int, pd: int):
        # frequency information: parse-and-discard (fib-processor.cpp:799+)
        pass

    def _fig0_22(self, d: _Bits, figlen: int, pd: int):
        # TII transmitter coordinates: parse-and-discard
        pass

    def _fig0_17(self, d: _Bits, figlen: int, pd: int):
        # program type (fib-processor.cpp FIG0Extension17)
        off = 16
        while off < figlen * 8:
            sid = d.u(off, 16)
            l_flag = d.u(off + 18, 1)
            cc_flag = d.u(off + 19, 1)
            svc = self.services.setdefault(sid, Service(sid=sid))
            if l_flag:
                svc.language = d.u(off + 24, 8)
                svc.has_language = True
                off += 8
            svc.program_type = d.u(off + 27, 5)
            off += 40 if cc_flag else 32

    # -------------------------------------------------------------- FIG 1

    def _fig1(self, d: _Bits, figlen: int):
        charset = d.u(8, 4)
        ext = d.u(8 + 5, 3)
        if ext == 0:        # ensemble label
            self.ensemble_id = d.u(16, 16)
            self.ensemble_label = charsets.decode_label(
                d.bytes_at(32, 16), charset)
        elif ext == 1:      # programme service label (16-bit SId)
            sid = d.u(16, 16)
            svc = self.services.setdefault(sid, Service(sid=sid))
            if not svc.has_label:
                svc.label = charsets.decode_label(d.bytes_at(32, 16), charset)
                svc.has_label = True
        elif ext == 3:      # region label (fib-processor.cpp:912-920)
            region_id = d.u(16 + 2, 6)
            self.region_labels[region_id] = charsets.decode_label(
                d.bytes_at(24, 16), charset)
        elif ext == 4:      # service component label (:922-940)
            pd_flag = d.u(16, 1)
            scids = d.u(20, 4)
            if pd_flag:
                sid = d.u(24, 32)
                off = 56
            else:
                sid = d.u(24, 16)
                off = 40
            self.component_labels[(sid, scids)] = charsets.decode_label(
                d.bytes_at(off, 16), charset)
        elif ext == 5:      # data service label (32-bit SId)
            sid = d.u(16, 32)
            svc = self.services.setdefault(sid, Service(sid=sid))
            if not svc.has_label:
                svc.label = charsets.decode_label(d.bytes_at(48, 16), charset)
                svc.has_label = True
        elif ext == 6:      # X-PAD user application label (:966-994)
            pd_flag = d.u(16, 1)
            scids = d.u(20, 4)
            if pd_flag:
                sid = d.u(24, 32)
                xpad_aid = d.u(59, 5)
                off = 64
            else:
                sid = d.u(24, 16)
                xpad_aid = d.u(43, 5)
                off = 48
            self.xpad_labels[(sid, scids, xpad_aid)] = charsets.decode_label(
                d.bytes_at(off, 16), charset)

    # ------------------------------------------------------------ binding

    def _bind(self, comp: ServiceComponent):
        for c in self.components:
            if c.sid == comp.sid and c.comp_nr == comp.comp_nr:
                return
        self.components.append(comp)

    def _find_packet_component(self, scid: int) -> Optional[ServiceComponent]:
        for c in self.components:
            if c.tmid == 3 and c.scid == scid:
                return c
        return None

    # ------------------------------------------------------------ queries

    def _service_by_label(self, label: str) -> Optional[Service]:
        for svc in self.services.values():
            if svc.has_label and svc.label.strip() == label.strip():
                return svc
        return None

    def kind_of_service(self, label: str) -> int:
        """AUDIO/PACKET/UNKNOWN (fib-processor.cpp:1197-1236)."""
        svc = self._service_by_label(label)
        if svc is None:
            return UNKNOWN_SERVICE
        for c in self.components:
            if c.sid == svc.sid:
                if c.tmid == 3:
                    return PACKET_SERVICE
                if c.tmid == 0:
                    return AUDIO_SERVICE
        return UNKNOWN_SERVICE

    def data_for_audio_service(self, label: str) -> Optional[AudioServiceData]:
        svc = self._service_by_label(label)
        if svc is None:
            return None
        for c in self.components:
            if c.sid == svc.sid and c.tmid == 0:
                sc = self.subchannels.get(c.subch_id)
                if sc is None:
                    return None
                return AudioServiceData(
                    subch_id=sc.subch_id, start_addr=sc.start_addr,
                    uep_flag=sc.uep_flag, prot_level=sc.prot_level,
                    eep_profile=sc.eep_profile, length=sc.length,
                    bitrate=sc.bitrate, ascty=c.ascty,
                    language=svc.language, program_type=svc.program_type)
        return None

    def data_for_data_service(self, label: str) -> Optional[PacketServiceData]:
        svc = self._service_by_label(label)
        if svc is None:
            return None
        for c in self.components:
            if c.sid == svc.sid and c.tmid == 3:
                sc = self.subchannels.get(c.subch_id)
                if sc is None:
                    return None
                return PacketServiceData(
                    subch_id=sc.subch_id, start_addr=sc.start_addr,
                    uep_flag=sc.uep_flag, prot_level=sc.prot_level,
                    eep_profile=sc.eep_profile, length=sc.length,
                    bitrate=sc.bitrate, dscty=c.dscty,
                    fec_scheme=sc.fec_scheme, dgflag=c.dgflag,
                    packet_address=c.packet_address)
        return None

    def service_labels(self) -> List[str]:
        return [s.label for s in self.services.values() if s.has_label]

    def audio_services(self) -> List[AudioServiceData]:
        out = []
        for s in self.services.values():
            if s.has_label:
                d = self.data_for_audio_service(s.label)
                if d is not None:
                    out.append(d)
        return out
