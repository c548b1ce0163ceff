"""CUDA graphs of a block's device work: the block graph
(``BlockFn.frames`` + ``assemble`` over one shard) and the MSC chain
(``EnsembleDecoder.fused``) each replay as one graph, in place of the
hundred-odd launches and the few hundred aten calls that issuing them
from Python costs a block.

A :class:`BlockGraph` belongs to the object whose work it replays, never
to a cache shared across objects: a replay writes its outputs where the
last replay of the same graph wrote them, so two objects of equal shapes
(two channels of a bank) must not share one.  It follows one key, what
fixes the work's shapes:

* the first call at a key runs the eager code, on a side stream (the
  warm-up: cuFFT's plans, the kernels' library, the tables uploaded once
  and cached are all made there);
* the second captures the work on that stream and replays it;
* later calls replay, as long as their inputs are the tensors the graph
  captured (by address); other input tensors recapture, and a new key
  drops the graph.

The kernel wrappers count their launches in ``_build.LAUNCHES``.  A
capture counts them once and launches nothing, and the replay that
follows it launches them once; each later replay adds the counts its
capture made.  Each capture, through whatever backend, is one
``capture`` span of :data:`dabjax_torch.runtime.profiling.PROCESS`:
its ``calls`` count the process's captures (replays are not counted),
and a profiler records each.

Only CUDA tensors are captured: on any other device :meth:`BlockGraph.
backend` is None and the callers run their eager code, untouched.
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import Callable, Hashable, Optional, Sequence, Tuple

import torch

from dabjax_torch import _build
from dabjax_torch.runtime.profiling import PROCESS

__all__ = ["BlockGraph", "CudaCapture", "layout"]


def layout(t: torch.Tensor) -> Tuple:
    """What of a tensor fixes the work captured on it: shape, strides,
    dtype and device (its address is the graph's input check)."""
    return (tuple(t.shape), t.stride(), t.dtype, t.device)


class CudaCapture:
    """Eager first calls and captures on a side stream of the device,
    ordered after the current stream's work so far and before its work
    from then on; replays on the current stream."""

    def __init__(self):
        self._streams = {}

    def _side(self, device: torch.device):
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        return side, cur

    def eager(self, fn: Callable, device: torch.device):
        side, cur = self._side(device)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def capture(self, fn: Callable, device: torch.device):
        """``(replay, outputs)``: ``fn`` captured, then replayed once.

        The garbage collector is held off while the capture runs: a
        collection there may destroy another object's graph (a closed
        receiver of a bank left in a reference cycle), a call that breaks
        the capture, which then fails in whatever it launches next."""
        side, cur = self._side(device)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    out = fn()
                except BaseException:
                    try:             # end the broken capture, keep fn's error
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        graph.replay()
        return graph.replay, out


class BlockGraph:
    """The one CUDA graph of an object's per-block work (see the module
    docstring).  A call goes::

        if not g.backend(device): eager code
        elif g.step(key, inputs): out = g.replay(fn, device)
        else: out = g.eager(fn, device)
    """

    def __init__(self):
        self._cuda = CudaCapture()
        self._key: Optional[Hashable] = None
        self._inputs: Optional[Tuple[int, ...]] = None
        self._replay: Optional[Callable] = None
        self._out = None
        self._added = Counter()

    def backend(self, device: torch.device):
        """What captures work on ``device``: a :class:`CudaCapture` on a
        CUDA device, None (the eager code) elsewhere."""
        return self._cuda if device.type == "cuda" else None

    def step(self, key: Hashable, inputs: Sequence[torch.Tensor]) -> bool:
        """Take a call at ``key`` on ``inputs``: False for the first call
        at a key (run :meth:`eager`), True when the graph serves it
        (:meth:`replay`).  A new key drops the graph; other input tensors
        than the captured ones drop it too, to be captured again."""
        addrs = tuple(t.data_ptr() for t in inputs)
        if key != self._key:
            self._key, self._inputs = key, addrs
            self._replay = self._out = None
            return False
        if addrs != self._inputs:
            self._inputs = addrs
            self._replay = self._out = None
        return True

    def eager(self, fn: Callable, device: torch.device):
        return self.backend(device).eager(fn, device)

    def replay(self, fn: Callable, device: torch.device):
        """The graph's outputs for this call: ``fn`` captured first if
        this is the key's second call or the inputs moved."""
        if self._replay is None:
            before = _build.LAUNCHES.copy()
            with PROCESS.stage("capture"):
                self._replay, self._out = self.backend(device).capture(
                    fn, device)
            self._added = _build.LAUNCHES - before
            return self._out
        self._replay()
        _build.LAUNCHES.update(self._added)
        return self._out

    @property
    def captured(self) -> bool:
        return self._replay is not None
