"""The traced run: the harness's own spans, the profiler's device trace,
and its reduction to intervals that the per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges that the harness
opens around its calls into the port (``window``, ``block``,
``blockgraph``, ``msc``, ``stage_host``, ``consume_host``, ``pull``).
A device operation belongs to the innermost harness span whose host
interval holds its launch (joined by the profiler's correlation id), not
to the span its device time overlaps: blocks overlap on the device.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Spans", "Trace", "parse_chrome_trace", "union_seconds"]

#: device event categories of a Kineto trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """The harness's spans: real ranges under a traced run, nothing
    otherwise (the untraced run pays no instrumentation)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


@dataclass
class Trace:
    """Device events [(name, cat, start_us, dur_us, span)] and harness
    spans [(name, start_us, dur_us)] of one traced window."""
    device: List[Tuple[str, str, float, float, Optional[str]]] = \
        field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self) -> List[Tuple[str, str, float, float, Optional[str]]]:
        return [e for e in self.device if e[1] == "kernel"]

    def in_window(self):
        t0, t1 = self.window
        return [e for e in self.device if e[2] < t1 and e[2] + e[3] > t0]

    def host_to_device(self) -> List[Tuple[float, float]]:
        """(start_us, end_us) of the window's host-to-device copies, on
        any stream, in a graph or not."""
        return [(e[2], e[2] + e[3]) for e in self.in_window()
                if e[1] == "gpu_memcpy" and "HtoD" in e[0]]

    def busy_s(self) -> float:
        t0, t1 = self.window
        return union_seconds([(max(e[2], t0), min(e[2] + e[3], t1))
                              for e in self.in_window()])

    def span_device_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside spans ``name``."""
        return sum(e[3] for e in self.device
                   if e[1] == "kernel" and e[4] == name) * 1e-6

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the device's
        idle time by the harness span the host was in meanwhile."""
        by_op: Dict[str, float] = {}
        for e in self.in_window():
            by_op[e[0]] = by_op.get(e[0], 0.0) + e[3] * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        t0, t1 = self.window
        ivs = sorted((max(e[2], t0), min(e[2] + e[3], t1))
                     for e in self.in_window())
        gaps, cur = [], t0
        for a, b in ivs:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if t1 > cur:
            gaps.append((cur, t1))
        index = _SpanIndex([s for s in self.spans if s[0] != "window"])
        by_span: Dict[str, float] = {}
        for a, b in gaps:
            # split the gap where a host span begins or ends, and give
            # each piece to the span the host was in
            cuts = index.edges(a, b)
            for x, y in zip([a, *cuts], [*cuts, b]):
                label = index((x + y) / 2) or "outside receiver spans"
                by_span[label] = by_span.get(label, 0.0) + (y - x) * 1e-6
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


class _SpanIndex:
    """Innermost-span lookup over one thread's ranges (nested or
    disjoint): the latest span started by ``t``, then up its parents."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]
        self.parent, stack = [], []
        for i, (_, ts, dur) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] + \
                    self.spans[stack[-1]][2] < ts:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self._edges = sorted([s[1] for s in self.spans]
                             + [s[1] + s[2] for s in self.spans])

    def edges(self, a: float, b: float) -> List[float]:
        """Starts and ends of spans strictly inside (a, b), in order."""
        lo = bisect.bisect_right(self._edges, a)
        hi = bisect.bisect_left(self._edges, b)
        return self._edges[lo:hi]

    def __call__(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            name, ts, dur = self.spans[i]
            if ts + dur >= t:
                return name
            i = self.parent[i]
        return None


def union_seconds(ivs: List[Tuple[float, float]]) -> float:
    """Length in seconds of the union of [a, b) intervals in us."""
    total, end = 0.0, None
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


SPAN_NAMES = ("window", "block", "blockgraph", "msc", "stage_host",
              "consume_host", "pull")


def parse_chrome_trace(path: str) -> Trace:
    """A Kineto chrome trace -> :class:`Trace` (the file is removed)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                    for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in SPAN_NAMES),
                   key=lambda s: s[1])
    launch = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    innermost = _SpanIndex([s for s in spans if s[0] != "window"])
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            t = launch.get(e.get("args", {}).get("correlation"))
            span = innermost(t) if t is not None else None
            device.append((e["name"], e["cat"], float(e["ts"]),
                           float(e["dur"]), span))
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    return Trace(device=device, spans=spans,
                 window=(win[0][1], win[0][1] + win[0][2]))
