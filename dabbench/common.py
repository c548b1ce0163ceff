"""Pieces the drivers share: the port's geometries for a configuration,
a cyclic u8 source over a loop, the reference's reading of a loop, and
the context the per-layer readers take."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from dabbench.gen.constants import INPUT_RATE, get_mode
from dabbench.gen.fic_layout import fic_codewords_per_frame, fic_profile
from dabbench.gen.loop import Loop, period
from dabbench.reference.receiver import Reference, decode_loop

__all__ = ["geometries", "LoopSource", "reference_of", "LayerContext",
           "frame_s", "Recorder", "Tap", "sample_blocks", "packed", "locked",
           "check_receiver", "traced_profiler"]


def frame_s(cfg: Dict) -> float:
    """Seconds of signal in one frame of the configuration's mode."""
    return get_mode(cfg["mode"]).T_F / INPUT_RATE


def geometries(cfg: Dict):
    """The port's ``SubchGeometry`` of each configured service, in the
    configuration's order."""
    from dabjax_torch.msc.subchannel import SubchGeometry
    return [SubchGeometry(s["subch"], s["start_cu"], Reference._cus(s),
                          s["bitrate"], s["protection"], s["level"])
            for s in cfg["services"]]


class LoopSource:
    """A loop's u8 IQ played end to end from ``offset`` samples on, by
    ``read_u8`` (the SDR front end's format, the receiver's u8 upload
    path).  A read that does not wrap returns a view of the loop, so the
    source costs the receiver no copy of its own (the receiver copies
    what it reads into its buffer)."""

    sample_rate = 2_048_000

    def __init__(self, u8: np.ndarray, offset: int = 0):
        self._u8 = u8
        self._pos = offset % u8.shape[0]

    def read_u8(self, n: int) -> np.ndarray:
        if self._pos + n <= self._u8.shape[0]:
            out = self._u8[self._pos: self._pos + n]
            self._pos = (self._pos + n) % self._u8.shape[0]
            return out
        out = np.empty((n, 2), np.uint8)
        got = 0
        while got < n:
            take = min(n - got, self._u8.shape[0] - self._pos)
            out[got: got + take] = self._u8[self._pos: self._pos + take]
            got += take
            self._pos = (self._pos + take) % self._u8.shape[0]
        return out


def reference_of(loop: Loop, device, precision: str = "float64") -> Dict:
    """The reference's reading of one period of ``loop``."""
    ref = Reference(loop.cfg, device, precision)
    return decode_loop(ref, loop.u8, period(ref.p).frames)


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads: the traced window's device trace
    and harness spans, the port's own spans and counters over the
    window, and the window's work."""
    trace: object
    blocks: int                      # blocks completed in the window
    periods: int                     # bank periods (blocks otherwise)
    signal_s: float                  # seconds of signal in the window
    program_spans: Dict[str, float]  # StageProfiler seconds, summed
    counters: Dict[str, float]       # Metrics over the window, summed
    shapes: Dict                     # the cell's shapes, for bounds
    cfg: Dict
    wl: Dict


def locked(rx, n_services: int) -> bool:
    """The receiver has read the whole ensemble (every service with its
    label) and decodes every subchannel with a full history."""
    db = rx.db
    return (len(db.services) == n_services
            and all(s.has_label for s in db.services.values())
            and len(rx._geometries()) == n_services
            and rx._hist_valid >= 15)


def sample_blocks(seed: int, span: int, n: int) -> set:
    """Indices of the window's blocks whose outputs are kept for the
    comparison: block 0 and ``n`` more drawn from the seed below
    ``span``."""
    from dabbench.gen.loop import rng_for
    rng = rng_for(seed, 3)
    return {0, *(int(x) for x in rng.choice(span, size=min(n, span),
                                             replace=False))}


class Recorder:
    """A receiver's data handlers: every logical frame routed to a
    subchannel is counted; while ``keep`` is set it is also kept, with
    its index in the subchannel's stream, for the comparison."""

    def __init__(self):
        self.keep = False
        self.count: Dict[int, int] = {}
        self.kept: Dict[int, List[Tuple[int, np.ndarray]]] = {}

    def factory(self, db, subch_id: int):
        self.count.setdefault(subch_id, 0)
        self.kept.setdefault(subch_id, [])
        return _Handler(self, subch_id)


def packed(kept: Dict[int, List[Tuple[int, np.ndarray]]]) -> Dict:
    """A recorder's kept frames with their bits packed to bytes."""
    return {sid: [(k, np.packbits(b)) for k, b in rows]
            for sid, rows in kept.items()}


class _Handler:
    def __init__(self, rec: Recorder, subch_id: int):
        self.rec, self.sid = rec, subch_id

    def add_logical_frame(self, bits: np.ndarray) -> None:
        rec = self.rec
        if rec.keep:
            rec.kept[self.sid].append((rec.count[self.sid], bits))
        rec.count[self.sid] += 1


class Tap:
    """Wraps a receiver's block graph call (``Receiver._block``) and its
    MSC routing (``Receiver._route_rows``): keeps the frame rows and the
    taps-and-FIB blob of the blocks marked ``keep`` (the blob cloned on
    the device, pulled after the window), and counts the logical frames
    routed to each subchannel."""

    def __init__(self, rx):
        self.keep = False
        self.kept: List[Tuple[np.ndarray, object, float]] = []
        self.routed: Dict[int, int] = {}
        block, route = rx._block, rx._route_rows

        def _block(rows):
            cifs, blob = block(rows)
            if self.keep:
                self.kept.append((rows.numpy().copy(), blob.clone(),
                                  float(rx._coarse_hz)))
            return cifs, blob

        def _route_rows(subch_id, frames, warmup):
            self.routed[subch_id] = self.routed.get(subch_id, 0) + max(
                0, frames.shape[0] - warmup)
            return route(subch_id, frames, warmup)

        rx._block, rx._route_rows = _block, _route_rows

    def pulled(self) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        return [(rows, blob.cpu().numpy(), coarse)
                for rows, blob, coarse in self.kept]


def traced_profiler(rx, spans) -> None:
    """Under a traced run, let the receiver's own ``StageProfiler`` spans
    (``stage_host``, ``pull``, ``consume_host``) open harness spans of
    the same name, so the trace can place its device work and gaps."""
    if not spans.enabled:
        return
    prof = rx.profiler
    stage = prof.stage

    @contextlib.contextmanager
    def _stage(name, items=0.0):
        with spans(name), stage(name, items):
            yield

    prof.stage = _stage


def check_receiver(checks, rx, tap: "Tap", cfg: Dict, device) -> None:
    """The kept blocks' taps and FIBs (the reference demodulates the same
    rows), the ensemble database, the FIC counters and sync."""
    from dabbench.check import compare_db, compare_taps, parse_blob
    refr = Reference(cfg, device)
    p = refr.p
    n_fib = fic_codewords_per_frame(p) * fic_profile(p)[2]
    for rows, blob, coarse in tap.pulled():
        F = rows.shape[0]
        port = parse_blob(blob, F, n_fib, p.T_u, p.K, [])
        d = refr.demod(rows)
        d["fib"], d["fic_ok"] = refr.fic(d["soft"])
        compare_taps(checks, port, d)
        checks.add("timing_bad", int(coarse != 0.0))
    compare_db(checks, rx.db, cfg)
    checks.add("fic_crc_bad", rx.metrics.fic_crc_bad)
    checks.add("sync_bad", rx.metrics.resyncs + int(not rx.metrics.synced))
