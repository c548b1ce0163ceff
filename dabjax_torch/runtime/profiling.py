"""Tracing and performance counters (torch port of
:mod:`dabjax.runtime.profiling`).

* :class:`StageProfiler`: cheap wall-time and throughput counters per
  span, always on; renders a text dashboard (``info --watch`` prints it).
  The receiver's and the channel bank's spans are named once, in
  :data:`SPANS`.
* :func:`device_trace` runs the body under ``torch.profiler`` and writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``); inside it
  every span also opens a ``record_function`` range of its name, on the
  trace's clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

import torch

__all__ = ["SPANS", "StageProfiler", "device_trace"]

#: the receiver's spans, in the order a block opens them, then the
#: channel bank's (``MultiReceiver``), in the order a period opens them;
#: a bank period holds its channels' receiver spans
SPANS = (
    "source",        # receiver: the source read into the sample buffer
    "stage_host",    # receiver: row stacking, upload and block-graph issue
    "blockgraph",    # block graph: BlockFn.frames + assemble (in stage_host)
    "msc",           # MSC chain: geometries, decoder key, fused issue
    "pull",          # receiver: the block's one device-to-host copy
    "consume_host",  # receiver: the pulled blob parsed, correctors, FIBs
    "route",         # host plane: frames to handlers (in consume_host)
    "bank_stage",    # entry: every channel's stage(); items channels staged
    "bank_pull",     # entry: the blobs joined on the device and the bank's
                     # one device-to-host copy; items bytes pulled
    "bank_consume",  # host plane: every channel's consume()
)

#: set while a :func:`device_trace` body runs: spans then also open a
#: ``record_function`` range
_recording = False


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
    """

    stages: Dict[str, _Stage] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0) -> Iterator[_Open]:
        t0 = time.perf_counter()
        span = _Open(items)
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


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body: CPU activity, plus CUDA activity where a card is
    present; yields the profiler and, on exit, writes
    ``logdir/trace_<ns>.json`` (the path is the profiler's ``trace_path``
    attribute).  While the body runs, every :class:`StageProfiler` span
    is also a ``record_function`` range, so each device operation's
    launch lies in the span that issued it.

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
