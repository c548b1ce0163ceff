"""Tracing and performance counters (torch port of
:mod:`dabjax.runtime.profiling`).

* :class:`StageProfiler` is dabjax's own (numpy, host wall time).
* :func:`device_trace` runs the body under ``torch.profiler`` and writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from dabjax.runtime.profiling import StageProfiler

__all__ = ["StageProfiler", "device_trace"]


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body: CPU activity, plus CUDA activity where a card is
    present; yields the profiler and, on exit, writes
    ``logdir/trace_<ns>.json`` (the path is the profiler's ``trace_path``
    attribute).

    Unlike dabjax's, which degrades silently to a no-op, a trace that
    cannot start or be written raises, and so does a trace on a card that
    recorded no CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError("device_trace: the profiler recorded no CUDA "
                           "activity")
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
