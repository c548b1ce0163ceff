"""The receiver runtime on torch: source -> OFDM -> FIC/MSC -> audio/data.

Port of the single-device :class:`dabjax.runtime.receiver.Receiver`.  The
host logic (sample buffer, timing and CFO correctors, FIB parsing,
logical-frame routing, audio services and pools) is dabjax's, copied; the
device parts are torch:

* ``stage()`` uploads the block's frame rows and runs the whole device
  chain (demod + FIC + PRS timing + scopes + CIF assembly + every MSC
  bucket) with no sync; every host-bound output is merged into one uint8
  blob in dabjax's byte layout (float32 taps as little-endian bytes, then
  30-byte FIB rows, then the bit-packed logical frames of each bucket);
* ``consume()`` pulls that blob once and parses it exactly as dabjax does.

IQ is uploaded as raw uint8 pairs when the source offers ``read_u8``
(the ``u8`` kind) and as float32 pairs otherwise (the ``f32`` kind).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dabjax.audio.aac import AacSink, decode_au_hook
from dabjax.audio.mp2 import Mp2Decoder
from dabjax.audio.mp4 import SuperframeDecoder
from dabjax.constants import CIF_BITS, DabParams, get_mode
from dabjax.data.pad import PadHandler
from dabjax.data.packet import PacketService
from dabjax.fic.fib import EnsembleDB
from dabjax.runtime.config import ReceiverConfig
from dabjax.runtime.metrics import Metrics
from dabjax.runtime.profiling import StageProfiler
from dabjax_torch.fic.fic_decoder import (decode_fic, fic_codewords_per_frame,
                                          fic_profile)
from dabjax_torch.msc.cif import cifs_from_soft
from dabjax_torch.msc.deinterleave import HISTORY
from dabjax_torch.msc.subchannel import (EnsembleDecoder, SubchGeometry,
                                         pack_bits_u8, subch_puncture_mask)
from dabjax_torch.ofdm import acquisition, demod

__all__ = ["Receiver", "AudioService", "BlockFn"]


def default_data_handler_factory(db: EnsembleDB, subch_id: int):
    """Build a PacketService from the ensemble DB's packet component
    signalling (the set_dataChannel analog, msc-handler.cpp:125)."""
    for comp in db.components:
        if comp.tmid == 3 and comp.subch_id == subch_id and comp.dscty >= 0:
            sc = db.subchannels.get(subch_id)
            fec = sc.fec_scheme if sc is not None else 0
            return PacketService(comp.dscty, fec_scheme=fec)
    return None


def _per_subch_path(path: Optional[str], subch_id: int) -> Optional[str]:
    """Suffix a dump path with the subchannel id so concurrent services
    never truncate each other's tap (``tap.mp2`` -> ``tap.3.mp2``)."""
    if path is None:
        return None
    import os
    stem, ext = os.path.splitext(path)
    return f"{stem}.{subch_id}{ext}"


class AudioService:
    """Per-service audio chain: logical frames -> PCM / AUs (+ PAD)."""

    def __init__(self, subch_id: int, bitrate: int, is_dab_plus: bool,
                 metrics: Metrics, es_dump_path=None, pcm_dump_path=None):
        self.subch_id = subch_id
        self.is_dab_plus = is_dab_plus
        self.metrics = metrics
        self.pad = PadHandler()
        es_dump_path = _per_subch_path(es_dump_path, subch_id)
        if is_dab_plus:
            self.superframe = SuperframeDecoder(bitrate)
            self.aac = AacSink(decoder=decode_au_hook())
            self.mp2 = None
            self._es_dump = (open(es_dump_path, "wb")
                             if es_dump_path else None)
        else:
            self.superframe = None
            self.mp2 = Mp2Decoder(es_dump_path=es_dump_path)
            self._es_dump = None
        # PCM tap (the audiosink WAV-dump path, gui.cpp:961-996)
        self._pcm_dump_path = _per_subch_path(pcm_dump_path, subch_id)
        self._pcm_sink = None
        self.pcm: List[np.ndarray] = []
        #: accumulated host wall-seconds spent decoding this service
        self.decode_seconds = 0.0

    def _emit_pcm(self, pcm: np.ndarray, rate: int):
        self.pcm.append(pcm)
        if self._pcm_dump_path is not None:
            if self._pcm_sink is None:
                from dabjax.io.audio_out import WavSink
                self._pcm_sink = WavSink(self._pcm_dump_path)
            self._pcm_sink.write(pcm, rate)

    @property
    def dynamic_label(self) -> str:
        return self.pad.label

    @property
    def slides(self):
        return self.pad.mot.objects

    def add_logical_frame(self, bits: np.ndarray):
        """Bit-vector entry point (tests / external callers)."""
        self.add_frame_bytes(np.packbits(np.asarray(bits, np.uint8)))

    def add_frame_bytes(self, data: np.ndarray):
        """Byte entry point — the receiver fast path (frames arrive
        already bit-packed from the device)."""
        import time
        t0 = time.perf_counter()
        try:
            self._add_frame_bytes(data)
        finally:
            self.decode_seconds += time.perf_counter() - t0

    def _add_frame_bytes(self, data: np.ndarray):
        if self.is_dab_plus:
            aus = self.superframe.add_frame(data)
            for au in aus:
                if au.crc_ok:
                    self.metrics.au_ok += 1
                    hdr = self.superframe.header
                    self.pad.process_au(bytes(au.data))
                    self.aac.configure(hdr.dac_rate, hdr.sbr_flag,
                                       hdr.mpeg_surround,
                                       hdr.aac_channel_mode)
                    pcm = self.aac.add_au(au.data)
                    if pcm is not None and pcm.size:
                        self._emit_pcm(pcm, self.aac.rate)
                    if self._es_dump is not None:
                        self._es_dump.write(bytes(au.data))
                else:
                    self.metrics.au_bad += 1
            self.metrics.superframes_ok = self.superframe.superframes_ok
            self.metrics.superframes_bad = self.superframe.superframe_errors
            self.metrics.rs_corrected = self.superframe.rs_corrected
        else:
            for pcm in self.mp2.add_bytes(data.tobytes()):
                self._emit_pcm(pcm, self.mp2.sample_rate)
            self.metrics.mp2_frames_ok = self.mp2.frames_ok
            self.metrics.mp2_frames_bad = self.mp2.frames_bad


@dataclasses.dataclass
class _Blk:
    """One staged block: the un-pulled merged device blob + its layout."""
    F: int
    merged: object                      # device uint8 [total]
    n_taps: int                         # float32 count at blob head
    n_fib: int
    buckets: List[Tuple]                # [(geoms, dev_shape)]
    warmup: int


class BlockFn(nn.Module):
    """The per-block device graph: CFO -> demod -> FIC -> PRS timing ->
    scopes -> CIF assembly.

    ``kind``: "f32" takes float32 (re, im) pairs; "u8" takes raw uint8 IQ
    pairs and applies the classic (x-128)/128 conversion on the device
    (bit-identical to the host conversion).  ``forward`` returns ``(cifs,
    blob)``: blob is one uint8 vector with the float32 taps as bytes, then
    the CRC-gated FIB payloads bit-packed to 30-byte rows."""

    def __init__(self, p: DabParams, kind: str, *, device):
        super().__init__()
        if kind not in ("u8", "f32"):
            raise ValueError(f"unknown input kind {kind!r}")
        self.p = p
        self.kind = kind
        self.device = torch.device(device)

    def forward(self, rows: torch.Tensor, coarse_hz: torch.Tensor):
        p = self.p
        if self.kind == "u8":
            x = (rows.to(torch.float32) - 128.0) * (1.0 / 128.0)
        else:
            x = rows.to(torch.float32)
        x = torch.view_as_complex(x.contiguous())
        # the coarse CFO is a whole number of carrier spacings, a multiple
        # of 2*pi in the guard-correlation angle, so the fine estimate on
        # the unrotated rows is unaffected and one rotation serves both
        fine = demod.fine_cfo_estimate(x, p)
        cfo = fine + coarse_hz
        soft, spec0 = demod.demodulate_frames_cfo(x, cfo, p)
        prs_rows = demod.apply_cfo(x[:, : p.T_u], cfo)
        snr = demod.snr_estimate(spec0, p)
        coarse = demod.coarse_cfo_estimate(spec0, p)
        fibs, fic_ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        t_off, t_ok = acquisition.prs_sync(prs_rows, p)
        spectrum = torch.mean(
            torch.abs(torch.roll(spec0, p.T_u // 2, dims=-1)), dim=0)
        cifs = cifs_from_soft(soft, p)
        constel = soft[0, p.fic_symbols, :]       # first data symbol
        taps = torch.cat([t.to(torch.float32).reshape(-1) for t in (
            snr, fine, coarse, t_off, t_ok, fic_ok, spectrum, constel)])
        fib_bytes = pack_bits_u8(fibs[..., :240])     # [F, n_fib, 30]
        blob = torch.cat([taps.view(torch.uint8), fib_bytes.reshape(-1)])
        return cifs, blob


class Receiver:
    """Block-batched DAB receiver on one torch device."""

    _next_tag = itertools.count()

    def __init__(self, source, config: Optional[ReceiverConfig] = None,
                 data_handler_factory=None, audio_pool=None, *, device):
        self.source = source
        self.cfg = config or ReceiverConfig()
        self.device = torch.device(device)
        self.p = get_mode(self.cfg.mode)
        self.db = EnsembleDB()
        self.metrics = Metrics()
        self.profiler = StageProfiler()
        self.audio: Dict[int, AudioService] = {}
        self.data_handler_factory = (data_handler_factory
                                     or default_data_handler_factory)
        self.data_handlers: Dict[int, object] = {}
        self._audio_pools: Dict[int, object] = {}
        self._audio_futs: List[object] = []
        self._chan_tag = next(Receiver._next_tag)
        self._proc_pool = audio_pool
        self._own_pool = False
        self._pool_meta: Dict[int, Tuple[int, bool]] = {}
        self._u8 = callable(getattr(source, "read_u8", None))
        self._empty_buf()
        self._buf_base = 0          # absolute index of _buf[0]
        self._u0: Optional[float] = None  # absolute PRS-useful-start index
        self._frame_len = float(self.p.T_F)
        self._coarse_hz = 0.0
        self._cif_hist = torch.zeros((HISTORY, CIF_BITS), dtype=torch.float32,
                                     device=self.device)
        self._hist_valid = 0        # CIFs of real history accumulated
        self._decoder: Optional[EnsembleDecoder] = None
        self._decoder_key = None
        self._bad_blocks = 0        # consecutive blocks with zero FIC CRCs
        self._fib_seen: set = set()   # recently parsed FIB payloads
        self._unsupported_warned: set = set()
        self._iq_dump = None
        if self.cfg.dump_iq_path:
            from dabjax.io.iq_dump import IqDumpWriter
            self._iq_dump = IqDumpWriter(self.cfg.dump_iq_path)
        self._block_fn = self._build_block_fn()

    def _empty_buf(self) -> np.ndarray:
        """(Re)initialize the preallocated sample buffer; ``self._buf``
        is always the valid-region view ``_arr[_start:_start+_len]``."""
        shape = ((1 << 20, 2) if self._u8 else (1 << 20,))
        self._arr = np.zeros(shape, np.uint8 if self._u8 else np.complex64)
        self._start = 0
        self._len = 0
        return self._arr[:0]

    @property
    def _buf(self) -> np.ndarray:
        return self._arr[self._start: self._start + self._len]

    @_buf.setter
    def _buf(self, value: np.ndarray) -> None:
        if value.shape[0] == 0:
            self._empty_buf()
            return
        raise ValueError("append via _buf_append")

    def _buf_append(self, chunk: np.ndarray) -> None:
        """Append without reallocating the whole stream."""
        n = chunk.shape[0]
        cap = self._arr.shape[0]
        if self._start + self._len + n > cap:
            if (self._len + n) * 2 > cap:
                new_cap = max((self._len + n) * 2, cap)
                new = np.empty((new_cap,) + self._arr.shape[1:],
                               self._arr.dtype)
                new[: self._len] = self._buf
                self._arr = new
            else:
                # compact in place: dest window starts before src and the
                # copy runs forward, so the overlapping move is safe
                self._arr[: self._len] = self._buf
            self._start = 0
        end = self._start + self._len
        self._arr[end: end + n] = chunk
        self._len += n

    def reset(self, source=None) -> None:
        """Retune: clear all stream/ensemble state but keep the device
        block function."""
        if source is not None:
            self.source = source
            self._u8 = callable(getattr(source, "read_u8", None))
            self._block_fn = self._build_block_fn()
        self.db = EnsembleDB()
        self.metrics = Metrics()
        self.audio = {}
        self._drain_audio()
        self._audio_pools = {}
        self.data_handlers = {}
        self._empty_buf()
        self._buf_base = 0
        self._u0 = None
        self._frame_len = float(self.p.T_F)
        self._coarse_hz = 0.0
        self._cif_hist = torch.zeros((HISTORY, CIF_BITS), dtype=torch.float32,
                                     device=self.device)
        self._hist_valid = 0
        self._decoder = None
        self._decoder_key = None
        self._bad_blocks = 0
        self._fib_seen = set()
        self._unsupported_warned = set()

    # ----------------------------------------------------- stream state

    def stream_state(self) -> Dict:
        """The stream state a block depends on, on the host: the CIF
        history, how much of it is real, the tracked PRS position, frame
        length and coarse CFO."""
        return {"cif_hist": self._cif_hist.cpu().numpy(),
                "hist_valid": self._hist_valid, "u0": self._u0,
                "frame_len": self._frame_len, "coarse_hz": self._coarse_hz}

    def load_stream_state(self, d: Dict) -> None:
        """Take over a stream mid-way from :meth:`stream_state`'s dict (or
        the same attributes of a dabjax Receiver)."""
        hist = np.asarray(d["cif_hist"], np.float32)
        if hist.shape != (HISTORY, CIF_BITS):
            raise ValueError(f"cif_hist shape {hist.shape}")
        self._cif_hist = torch.tensor(hist, device=self.device)
        self._hist_valid = int(d["hist_valid"])
        self._u0 = None if d["u0"] is None else float(d["u0"])
        self._frame_len = float(d["frame_len"])
        self._coarse_hz = float(d["coarse_hz"])

    # ------------------------------------------------------------- device

    def _build_block_fn(self) -> BlockFn:
        return BlockFn(self.p, "u8" if self._u8 else "f32",
                       device=self.device)

    # --------------------------------------------------------------- I/O

    def _ensure(self, abs_end: int) -> bool:
        """Grow the buffer to cover absolute sample index < abs_end."""
        need = abs_end - (self._buf_base + self._len)
        if need > 0:
            chunk = (self.source.read_u8(int(need)) if self._u8
                     else self.source.read(int(need)))
            if chunk.shape[0]:
                self._buf_append(chunk)
            if chunk.shape[0] < need:
                return False
        return True

    def _drop_before(self, abs_idx: int):
        # never drop past what was actually read: _buf_base + _len must
        # stay equal to the number of samples consumed from the source
        cut = min(abs_idx - self._buf_base, self._len)
        if cut > 0:
            self._start += cut
            self._len -= cut
            self._buf_base += cut

    def _cx(self, lo: int, hi: int) -> np.ndarray:
        """Buffer slice as complex64 ((x-128)/128 for u8 pairs)."""
        if not self._u8:
            return self._buf[lo:hi]
        x = (self._buf[lo:hi].astype(np.float32) - 128.0) / 128.0
        return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)

    # ---------------------------------------------------------- acquire

    def acquire(self) -> bool:
        p = self.p
        for _ in range(self.cfg.scan_attempts):
            if not self._ensure(self._buf_base + 2 * p.T_F + p.T_null
                                + p.T_u):
                return False
            u0 = acquisition.acquire(self._cx(0, self._buf.shape[0]), p,
                                     self.cfg.sync_threshold,
                                     device=self.device)
            if u0 is not None:
                self._u0 = float(self._buf_base + int(u0))
                self._probe_frame_len()
                self.metrics.synced = True
                return True
            self._drop_before(self._buf_base + p.T_F)
        self.metrics.synced = False
        return False

    def _probe_frame_len(self):
        """Initial sample-clock estimate: locate the PRS k frames ahead of
        u0 and divide the residual by k (ofdm-processor.cpp:344-380)."""
        p = self.p
        k = 8
        if not self._ensure(int(self._u0) + k * p.T_F + p.T_u):
            return
        base = int(self._u0) - self._buf_base + k * p.T_F
        win = torch.as_tensor(self._cx(base, base + p.T_u),
                              device=self.device)
        start, ok = acquisition.prs_sync(win[None, :], p,
                                         self.cfg.sync_threshold)
        if not bool(ok[0]):
            return
        d = int(start[0])
        d = (d + p.T_u // 2) % p.T_u - p.T_u // 2
        if abs(d) <= p.T_g:
            self._frame_len = p.T_F + d / k

    # -------------------------------------------------------------- stage

    def stage(self) -> Optional[_Blk]:
        """Host staging + the entire device work of one block, with no
        device synchronization.  Returns None when the source is
        exhausted."""
        p = self.p
        F = self.cfg.frames_per_block
        if self._u0 is None and not self.acquire():
            return None
        need = demod.min_frame_samples(p)
        pos = np.round(self._u0
                       + np.arange(F) * self._frame_len).astype(np.int64)
        end = int(pos[-1]) + need
        if not self._ensure(end):
            return None
        base = pos - self._buf_base
        with self.profiler.stage("stage_host", items=F * p.T_F):
            rows = np.stack([self._buf[b: b + need] for b in base])
            if self._iq_dump is not None:    # raw-IQ tap at pipeline input
                self._iq_dump.write(self._cx(int(base[0]),
                                             int(base[0]) + F * p.T_F))
            if not self._u8:                 # complex64 -> (re, im) pairs
                rows = rows.view(np.float32).reshape(F, need, 2)
            rows_dev = torch.from_numpy(rows).to(self.device)
            coarse = torch.full((F,), self._coarse_hz, dtype=torch.float32,
                                device=self.device)
            cifs, blob = self._block_fn(rows_dev, coarse)

        # ----- MSC buckets (skipped entirely in FIC-only use)
        bucket_meta: List[Tuple] = []
        merged = None
        warmup = 0
        if self.cfg.decode_audio or self.cfg.decode_data:
            geoms = self._geometries()
            if geoms:
                key = tuple(sorted((g.subch_id,) + g.shape_key
                                   + (g.start_addr,) for g in geoms))
                if key != self._decoder_key:
                    self._decoder = EnsembleDecoder(geoms, p,
                                                    device=self.device)
                    self._decoder_key = key
                warmup = max(0, HISTORY - self._hist_valid)
                merged, self._cif_hist, bucket_meta = \
                    self._decoder.fused(self._cif_hist, cifs, blob)
                self._hist_valid = min(HISTORY,
                                       self._hist_valid + cifs.shape[0])
            else:
                self._push_history(cifs)
        if merged is None:
            merged = blob
        n_fib = fic_codewords_per_frame(p) * fic_profile(p)[2]
        n_taps = 5 * F + F * n_fib + p.T_u + 2 * p.K
        blk = _Blk(F=F, merged=merged, n_taps=n_taps, n_fib=n_fib,
                   buckets=bucket_meta, warmup=warmup)
        # advance to the next block now (predictive); consume() applies the
        # measured intercept/slope corrections before the next stage()
        self._u0 += F * self._frame_len
        self._drop_before(int(self._u0) - p.T_u)
        return blk

    # ------------------------------------------------------------ consume

    def consume(self, blk: _Blk, big: Optional[np.ndarray] = None) -> None:
        """Pull the block's merged blob (the one device sync) and do every
        piece of host processing."""
        p = self.p
        F = blk.F
        if big is None:
            with self.profiler.stage("pull", items=F * p.T_F):
                big = blk.merged.cpu().numpy()
        with self.profiler.stage("consume_host", items=F * p.T_F):
            self._consume_parsed(blk, big)

    def _consume_parsed(self, blk: _Blk, big: np.ndarray) -> None:
        p = self.p
        F = blk.F
        # frombuffer-of-copy instead of .view: the slice may not be
        # 4-byte aligned
        taps = np.frombuffer(big[: 4 * blk.n_taps].tobytes(), np.float32)
        off = 4 * blk.n_taps
        pos = 0

        def take(n, shape=None):
            nonlocal pos
            v = taps[pos: pos + n]
            pos += n
            return v if shape is None else v.reshape(shape)

        snr = take(F)
        fine = take(F)
        coarse = take(F)
        t_off = take(F)
        t_ok = take(F)
        fic_ok = take(F * blk.n_fib, (F, blk.n_fib))
        spectrum = take(p.T_u)
        constel = take(2 * p.K)
        fib_sz = F * blk.n_fib * 30
        fib_bytes = big[off: off + fib_sz].reshape(F, blk.n_fib, 30)
        off += fib_sz
        self.metrics.spectrum = spectrum
        k = self.p.K
        self.metrics.constellation = (
            -constel[:k] - 1j * constel[k:]) / 127.0

        # ----- metrics + correctors
        self.metrics.frames += F
        self.metrics.samples_processed += F * p.T_F
        self.metrics.snr_db = float(np.mean(snr))
        self.metrics.fine_cfo_hz = float(np.mean(fine))
        if self.cfg.coarse_cfo:
            step = float(np.median(coarse)) * p.carrier_diff
            self._coarse_hz += step
            if abs(self._coarse_hz) > self.cfg.max_coarse_khz * 1000:
                self._coarse_hz = 0.0
            self.metrics.coarse_cfo_hz = self._coarse_hz
        # ----- timing tracking: per-frame PRS offsets, least-squares drift
        # fit (ofdm-processor.cpp:344-380)
        offv = t_off.astype(np.int64)
        offv = (offv + p.T_u // 2) % p.T_u - p.T_u // 2
        good = (t_ok > 0) & (np.abs(offv) <= p.T_g)
        if good.sum() >= 2:
            slope, intercept = np.polyfit(
                np.arange(F)[good], offv[good].astype(np.float64), 1)
            self._u0 += float(np.clip(intercept, -p.T_g, p.T_g))
            self._frame_len = float(np.clip(
                self._frame_len + slope,
                p.T_F * (1 - 3e-4), p.T_F * (1 + 3e-4)))
        elif good.any():
            self._u0 += int(offv[np.argmax(good)])
        self.metrics.avg_frame_len = (
            self._frame_len if self.metrics.avg_frame_len == 0.0
            else 0.9 * self.metrics.avg_frame_len + 0.1 * self._frame_len)

        # ----- FIC -> ensemble database; each distinct payload once
        ok_mask = fic_ok > 0
        block_ok = int(ok_mask.sum())
        self.metrics.fic_crc_ok += block_ok
        self.metrics.fic_crc_bad += int(ok_mask.size - block_ok)
        if len(self._fib_seen) > 8192:
            self._fib_seen = set()
        for f, i in zip(*np.nonzero(ok_mask)):
            payload = fib_bytes[f, i].tobytes()
            if payload not in self._fib_seen:
                self._fib_seen.add(payload)
                self.db.process_fib_bytes(payload)

        # ----- failure detection: sync loss -> full re-acquisition
        if block_ok == 0:
            self._bad_blocks += 1
            if self._bad_blocks >= self.cfg.resync_after_bad_blocks:
                self._u0 = None
                self._coarse_hz = 0.0
                self._bad_blocks = 0
                self.metrics.synced = False
                self.metrics.resyncs += 1
                self._hist_valid = 0
                return
        else:
            self._bad_blocks = 0

        # ----- MSC routing (bytes straight from the device bit-packing)
        for geoms, shape in blk.buckets:
            nbytes = int(np.prod(shape))
            arr = big[off: off + nbytes].reshape(shape)
            off += nbytes
            for i, g in enumerate(geoms):
                self._route_rows(g.subch_id, arr[i], blk.warmup)

    # --------------------------------------------------------------- step

    def step(self) -> bool:
        """Process one block of cfg.frames_per_block frames.

        Returns False when the source is exhausted.
        """
        blk = self.stage()
        if blk is None:
            return False
        self.consume(blk)
        return True

    # --------------------------------------------------------------- MSC

    def _decodable(self, g: SubchGeometry) -> bool:
        """True when a puncturing profile exists for this geometry; an
        unknown profile skips that subchannel only (deconvolve.cpp:142-166)."""
        try:
            subch_puncture_mask(g.protection, g.bitrate, g.prot_level)
            return True
        except (ValueError, KeyError):
            if g.subch_id not in self._unsupported_warned:
                self._unsupported_warned.add(g.subch_id)
                self.metrics.unsupported_subch += 1
            return False

    def _geometries(self) -> List[SubchGeometry]:
        geoms = []
        if self.cfg.service is not None:
            ad = self.db.data_for_audio_service(self.cfg.service)
            pd = (self.db.data_for_data_service(self.cfg.service)
                  if ad is None else None)
            d = ad or pd
            if d is None:
                return []
            sc = self.db.subchannels[d.subch_id]
            g = SubchGeometry.from_db(sc)
            return [g] if self._decodable(g) else []
        for sc in self.db.subchannels.values():
            if sc.bitrate > 0 and sc.length > 0:
                g = SubchGeometry.from_db(sc)
                if self._decodable(g):
                    geoms.append(g)
        return geoms

    def _push_history(self, cifs: torch.Tensor):
        self._cif_hist = torch.cat([self._cif_hist, cifs], dim=0)[-HISTORY:]
        self._hist_valid = min(HISTORY, self._hist_valid + cifs.shape[0])

    # ------------------------------------------------------------- route

    def _audio_meta(self, subch_id: int):
        for svc in self.db.services.values():
            if not svc.has_label:
                continue
            d = self.db.data_for_audio_service(svc.label)
            if d is not None and d.subch_id == subch_id:
                return d
        return None

    def _submit_audio_rows(self, svc: AudioService, rows: List[np.ndarray]):
        """Feed a block's logical frames to a service — on its worker
        thread when async_audio is set (one single-thread executor per
        service keeps frame order), inline otherwise."""
        if not self.cfg.async_audio:
            for r in rows:
                svc.add_frame_bytes(r)
            return
        pool = self._audio_pools.get(svc.subch_id)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=1)
            self._audio_pools[svc.subch_id] = pool

        def work(svc=svc, rows=rows):
            for r in rows:
                svc.add_frame_bytes(r)

        self._audio_futs.append(pool.submit(work))

    def _drain_audio(self):
        for f in self._audio_futs:
            f.result()                   # surfaces worker exceptions too
        self._audio_futs.clear()

    def _pool(self):
        if self._proc_pool is None and self.cfg.audio_workers > 0:
            from dabjax.runtime.audio_pool import AudioWorkerPool
            self._proc_pool = AudioWorkerPool(self.cfg.audio_workers)
            self._own_pool = True
        return self._proc_pool

    def merge_pool_counters(self, counters: Dict) -> None:
        """Fold worker-process audio counters (cumulative per key) for
        this receiver's channel into Metrics."""
        from dabjax.runtime.audio_pool import COUNTER_FIELDS
        mine = {k: v for k, v in counters.items()
                if k[0] == self._chan_tag}
        if not mine:
            return
        for f in COUNTER_FIELDS:
            setattr(self.metrics, f, sum(v[f] for v in mine.values()))
        self.metrics.audio_decode_seconds = sum(
            v["decode_seconds"] for v in mine.values())

    def drain_pool(self) -> None:
        if self._proc_pool is not None and self._own_pool:
            self.merge_pool_counters(self._proc_pool.drain())

    def _route_rows(self, subch_id: int, frames: np.ndarray, warmup: int):
        """Route a block's decoded logical frames (byte rows) for one
        subchannel to its audio/data handler."""
        if (self.cfg.audio_workers > 0 or self._proc_pool is not None) \
                and self.cfg.decode_audio:
            meta = self._pool_meta.get(subch_id)
            if meta is None:
                d = self._audio_meta(subch_id)
                if d is not None:
                    meta = (d.bitrate, d.is_dab_plus)
                    self._pool_meta[subch_id] = meta
            if meta is not None:
                if frames.shape[0] > warmup:
                    self._pool().submit_rows(
                        (self._chan_tag, subch_id), meta[0], meta[1],
                        frames[warmup:])
                return
        rows = [frames[t] for t in range(warmup, frames.shape[0])]
        if not rows:
            return
        if subch_id in self.audio:
            self._submit_audio_rows(self.audio[subch_id], rows)
            return
        if subch_id in self.data_handlers:
            h = self.data_handlers[subch_id]
            for r in rows:
                h.add_logical_frame(np.unpackbits(r))
            return
        meta = self._audio_meta(subch_id)
        if meta is not None and self.cfg.decode_audio:
            self.audio[subch_id] = AudioService(
                subch_id, meta.bitrate, meta.is_dab_plus, self.metrics,
                es_dump_path=self.cfg.dump_es_path,
                pcm_dump_path=self.cfg.dump_audio_path)
            self._submit_audio_rows(self.audio[subch_id], rows)
            return
        if self.cfg.decode_data and self.data_handler_factory is not None:
            h = self.data_handler_factory(self.db, subch_id)
            if h is not None:
                self.data_handlers[subch_id] = h
                for r in rows:
                    h.add_logical_frame(np.unpackbits(r))

    # ---------------------------------------------------------------- run

    def run(self, n_blocks: int) -> Metrics:
        for _ in range(n_blocks):
            if not self.step():
                break
        self._drain_audio()              # metrics/pcm settled on return
        self.drain_pool()
        return self.metrics

    def close(self) -> None:
        self._drain_audio()
        for pool in self._audio_pools.values():
            pool.shutdown(wait=True)
        self._audio_pools = {}
        if self._proc_pool is not None and self._own_pool:
            self._proc_pool.close()
            self._proc_pool = None
        if self._iq_dump is not None:
            self._iq_dump.close()
            self._iq_dump = None
