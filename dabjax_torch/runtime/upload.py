"""A block's rows from host memory to the device buffer its graph reads,
copied beside the kernels.

The block graph (:class:`dabjax_torch.graphs.BlockGraph`) replays only
on the tensors it captured, so every block's rows must land in one
device buffer, ``rows``.  The host-to-device copy runs on a copy stream
of its own, and the graphs' stream (the current stream) waits on an
event after it, so the copy of the next block's rows can run under the
kernels of the block before it:

* **direct**: when the last block graph that read ``rows`` is done (its
  event has completed: a query, which does not block), the rows are
  copied straight into ``rows``;
* **staged**: while that graph may still read ``rows``, they are copied
  into a second device buffer, ``stage`` (made at the first staged
  upload), and the graphs' stream copies ``stage`` into ``rows`` just
  before the graph, after its wait on the copy.

Which path a block takes follows what the device is doing: a caller
that syncs on each block before it uploads the next (a live receiver,
a bank) always finds ``rows`` free and never holds ``stage``.

Ordering: a copy into ``stage`` waits on the copy stream for the last
copy out of it; a copy into ``rows`` for the last block graph's event.
``uploaded`` is recorded on the copy stream after each host-to-device
copy, and the host waits on it (:meth:`RowsUpload.wait`) before it
writes the host rows again.  Both device buffers are marked as used by
the copy stream, so when a new shape replaces one, its memory is not
handed out again before the copy stream's work on it is done.  Nothing
here runs inside a capture: the receiver uploads before the graph's
call.

The streams, events and copies go through a backend: :class:`CudaCopies`
on a CUDA device; the CPU tests put a stand-in that records the calls
in its place.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

__all__ = ["CudaCopies", "RowsUpload"]


class CudaCopies:
    """The stream and event calls of an upload on a CUDA device: a copy
    stream of its own beside the current stream (the graphs')."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy = torch.cuda.Stream(device)

    def current(self):
        return torch.cuda.current_stream(self.device)

    def event(self):
        return torch.cuda.Event()

    def empty(self, like: torch.Tensor) -> torch.Tensor:
        """A device buffer of ``like``'s shape and dtype, made on the
        current stream and marked as used by the copy stream too."""
        t = torch.empty(like.shape, dtype=like.dtype, device=self.device)
        t.record_stream(self.copy)
        return t

    def copy_on(self, stream, dst: torch.Tensor, src: torch.Tensor) -> None:
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)


def _fits(buf: Optional[torch.Tensor], like: torch.Tensor) -> bool:
    return buf is not None and buf.shape == like.shape \
        and buf.dtype == like.dtype


class RowsUpload:
    """The rows' device buffers, the copy stream and the events of one
    receiver (see the module docstring).  ``counts`` counts the uploads
    by path, ``"direct"`` and ``"staged"``."""

    def __init__(self, device: torch.device, backend=None):
        self.device = device
        self.backend = backend      # made at the first upload if None
        self.rows: Optional[torch.Tensor] = None
        self.stage: Optional[torch.Tensor] = None
        self.uploaded = None        # copy stream, after the last copy in
        self._read = None           # graphs' stream, after the last graph
        self._stage_free = None     # graphs' stream, after copying stage
        self.counts: Counter = Counter()

    def __call__(self, host: torch.Tensor) -> torch.Tensor:
        """``host``'s rows in ``rows``, for the work issued on the
        current stream from here on."""
        b = self.backend
        if b is None:
            b = self.backend = CudaCopies(self.device)
        if self.uploaded is None:
            self.uploaded, self._read, self._stage_free = \
                b.event(), b.event(), b.event()
        if not _fits(self.rows, host):
            self.rows = b.empty(host)
        cur = b.current()
        staged = not self._read.query()
        if staged:
            if not _fits(self.stage, host):
                self.stage = b.empty(host)
            b.copy.wait_event(self._stage_free)
            b.copy_on(b.copy, self.stage, host)
        else:
            b.copy.wait_event(self._read)
            b.copy_on(b.copy, self.rows, host)
        self.uploaded.record(b.copy)
        cur.wait_event(self.uploaded)
        if staged:
            b.copy_on(cur, self.rows, self.stage)
            self._stage_free.record(cur)
        self.counts["staged" if staged else "direct"] += 1
        return self.rows

    def read(self) -> None:
        """Mark the work issued on the current stream so far as the last
        that reads ``rows`` (call it after the block graph's call)."""
        if self._read is not None:
            self._read.record(self.backend.current())

    def wait(self) -> None:
        """Block the host until the last upload's copy from host memory
        is done, so that its source may be written again."""
        if self.uploaded is not None:
            self.uploaded.synchronize()
