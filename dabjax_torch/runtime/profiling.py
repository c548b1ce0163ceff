"""Tracing and performance counters (torch port of
:mod:`dabjax.runtime.profiling`).

* :class:`StageProfiler`: cheap wall-time and throughput counters per
  span, always on; renders a text dashboard (``info --watch`` prints it).
  The receiver's and the channel bank's spans are named once, in
  :data:`SPANS`; the process's own, which no block owns, in
  :data:`PROCESS_SPANS`.
* Span records: while a torch profiler runs (``torch.profiler.profile``,
  :func:`device_trace` among them), every span a :class:`StageProfiler`
  closes, every garbage collection (``gc``) and every CUDA graph capture
  (``capture``, :data:`PROCESS`) also becomes one :class:`SpanRecord`
  (name, owner, block, start, end, parent, items) in one bounded ring of
  :data:`RING` records for the process; :func:`records` returns them and
  :func:`overflow` counts those the ring lost.  When no profiler runs, a
  span or a collection costs one read of the profiler's flag.
* :func:`device_trace` runs the body under ``torch.profiler`` and writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``); inside it
  every span also opens a ``record_function`` range of its name, on the
  trace's clock.

A record's clock is ``time.time_ns()``, Unix nanoseconds, read when the
span opens and when it closes: the time axis of the Chrome trace that
``torch.profiler`` writes, on which an event lies at ``ts`` +
``baseTimeNanoseconds`` / 1000 Unix microseconds, so that ``start_ns /
1000`` and ``end_ns / 1000`` fall on it unconverted.  The sums keep
``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler

__all__ = ["SPANS", "PROCESS_SPANS", "PROCESS", "RING", "SpanRecord",
           "StageProfiler", "device_trace", "records", "overflow",
           "clear_records"]

#: the receiver's spans, in the order a block opens them, then the
#: channel bank's (``MultiReceiver``), in the order a period opens them;
#: a bank period holds its channels' receiver spans
SPANS = (
    "source",        # receiver: the source read into the sample buffer
    "stage_host",    # receiver: row stacking, upload and block-graph issue
    "blockgraph",    # block graph: BlockFn.frames + assemble (in stage_host)
    "msc",           # MSC chain: geometries, decoder key, fused issue
    "pull",          # receiver: the block's one device-to-host copy
    "pull_wait",     # receiver: the wait for the block's device work, the
                     # stream it was issued on synchronized (in pull)
    "consume_host",  # receiver: the pulled blob parsed, correctors, FIBs
    "route",         # host plane: frames to handlers (in consume_host)
    "bank_stage",    # entry: every channel's stage(); items channels staged
    "bank_pull",     # entry: the blobs joined on the device and the bank's
                     # one device-to-host copy; items bytes pulled
    "bank_consume",  # host plane: every channel's consume()
)

#: the process's spans, which no block owns (so never once a block)
PROCESS_SPANS = (
    "gc",            # a garbage collection; items its generation
    "capture",       # a CUDA graph captured (graphs.BlockGraph.replay)
)

#: set while a :func:`device_trace` body runs: spans then also open a
#: ``record_function`` range
_recording = False

#: records the ring holds; a 1 s live window makes about 2,100 and a 2 s
#: bank32 window about 4,300
RING = 1 << 16


class SpanRecord(NamedTuple):
    """One closed span."""
    id: int                 # the span's number, in the order spans opened
    parent: int             # id of the span open on the same thread when
                            # this one began, -1 for none
    name: str
    owner: object           # a receiver's channel tag, "bank", None
    block: Optional[int]    # the owner's block (period) number, or None
    start_ns: int           # time.time_ns() at open
    end_ns: int             # time.time_ns() at close
    items: float


_ring: List[Optional[tuple]] = [None] * RING
_written = 0                # records written since the last clear
# reentrant: a collection that an allocation under it starts writes its
# own record from the gc hook on the same thread
_ring_lock = threading.RLock()
_ids = itertools.count()
_open = threading.local()   # .stack: ids of the thread's open recorded spans
_gc_open: Optional[tuple] = None   # (start_ns, parent) of a collection


def _stack() -> List[int]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _write(rec: tuple) -> None:
    global _written
    with _ring_lock:
        i = _written
        _ring[i % RING] = rec
        _written = i + 1


def records() -> List[SpanRecord]:
    """The ring's records, oldest first (in the order spans closed)."""
    with _ring_lock:
        n = _written
        if n <= RING:
            held = _ring[:n]
        else:
            k = n % RING
            held = _ring[k:] + _ring[:k]
    return [SpanRecord._make(r) for r in held]


def overflow() -> int:
    """Records the ring has lost since the last :func:`clear_records`:
    the oldest, written over by newer ones."""
    return max(0, _written - RING)


def clear_records() -> None:
    """Empty the ring (and its overflow count)."""
    global _written
    empty = [None] * RING
    with _ring_lock:
        _written = 0
        _ring[:] = empty


def _on_gc(phase: str, info: Dict) -> None:
    """``gc.callbacks`` hook: a ``gc`` record of each collection while a
    profiler runs, its parent the span open on the collecting thread."""
    global _gc_open
    if not _torch_profiler._is_profiler_enabled:
        return
    if phase == "start":
        stack = _stack()
        _gc_open = (time.time_ns(), stack[-1] if stack else -1)
    elif _gc_open is not None:
        start, parent = _gc_open
        _gc_open = None
        _write((next(_ids), parent, "gc", None, None, start,
                time.time_ns(), float(info["generation"])))


gc.callbacks.append(_on_gc)


@dataclass
class _Stage:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0


class _Open:
    """A span while its body runs: the body may set ``items`` once it
    knows them, or :meth:`drop` the span, which is then not counted."""
    __slots__ = ("items", "dropped")

    def __init__(self, items: float):
        self.items = items
        self.dropped = False

    def drop(self) -> None:
        self.dropped = True


@dataclass
class StageProfiler:
    """Accumulates per-span wall time and item throughput.

    >>> prof = StageProfiler()
    >>> with prof.stage("demod", items=n_samples):
    ...     run_demod()
    >>> print(prof.report())

    While a profiler runs, each span it closes is also recorded (see the
    module docstring) with the ``owner`` and ``block`` set when it
    opened: its owner sets them, ``block`` to the number of the block
    (or period) whose work follows, None for work of no block."""

    stages: Dict[str, _Stage] = field(default_factory=dict)
    owner: object = None
    block: Optional[int] = None

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0) -> Iterator[_Open]:
        t0 = time.perf_counter()
        span = _Open(items)
        rec = None
        if _torch_profiler._is_profiler_enabled:
            stack = _stack()
            rec = (next(_ids), stack[-1] if stack else -1, self.owner,
                   self.block, time.time_ns())
            stack.append(rec[0])
        try:
            if _recording:
                with torch.profiler.record_function(name):
                    yield span
            else:
                yield span
        finally:
            if not span.dropped:
                st = self.stages.setdefault(name, _Stage())
                st.calls += 1
                st.seconds += time.perf_counter() - t0
                st.items += span.items
            if rec is not None:
                end = time.time_ns()
                _stack().pop()
                if not span.dropped:
                    i, parent, owner, block, start = rec
                    _write((i, parent, name, owner, block, start, end,
                            span.items))

    def report(self, realtime_rate: float = 2_048_000.0) -> str:
        """Text dashboard; ``realtime_rate`` converts item counts that are
        IQ samples into a realtime factor."""
        lines = [f"{'stage':<16} {'calls':>6} {'total s':>9} "
                 f"{'ms/call':>8} {'items/s':>12} {'x RT':>7}"]
        for name, st in sorted(self.stages.items(),
                               key=lambda kv: -kv[1].seconds):
            per = st.seconds / st.calls * 1e3 if st.calls else 0.0
            rate = st.items / st.seconds if st.seconds > 0 else 0.0
            rt = rate / realtime_rate if realtime_rate else 0.0
            lines.append(f"{name:<16} {st.calls:>6} {st.seconds:>9.3f} "
                         f"{per:>8.2f} {rate:>12.0f} {rt:>7.1f}")
        return "\n".join(lines)


#: the process's spans (:data:`PROCESS_SPANS`) that a profiler times:
#: ``capture``, whose ``calls`` count the CUDA graph captures made in the
#: process, always on
PROCESS = StageProfiler()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body: CPU activity, plus CUDA activity where a card is
    present; yields the profiler and, on exit, writes
    ``logdir/trace_<ns>.json`` (the path is the profiler's ``trace_path``
    attribute).  While the body runs, every :class:`StageProfiler` span
    is also a ``record_function`` range, so each device operation's
    launch lies in the span that issued it, and is recorded in the ring
    (:func:`records`) as under any profiler.

    Unlike dabjax's, which degrades silently to a no-op, a trace that
    cannot start or be written raises, and so does a trace on a card that
    recorded no CUDA activity."""
    global _recording
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    was, _recording = _recording, True
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        _recording = was
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError("device_trace: the profiler recorded no CUDA "
                           "activity")
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
