"""The decode core of an archive decoder: the core cell's work (the
port's block graph and ``EnsembleDecoder.fused`` back to back, the CIF
history carried from block to block) on rows that live in pinned host
memory and cross to the device through the port's upload every block.

Set-up renders the seed's loop once under two noise draws and cuts each
into a block of rows, as the core driver does, in a pinned host buffer
of its own: a file reader's double buffer, whose read is not timed.  The
window hands the two buffers in turn to the receiver's block graph call
(``Receiver._block``: the rows' one asynchronous copy into the device
buffer the graph was captured on, the CFO fill, ``BlockFn.frames`` and
``assemble``), then to ``fused``, with the merged blob copied out as in
the core.

The two draws differ in every tap, so a block that read stale or
half-copied rows differs from its buffer's first block: each block's blob
is compared with the first of the same buffer, and after the window each
first with the reference (the second's taps with the reference's reading
of its own draw; the frames are the payload's under either draw).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dabbench.check import LIMITS, Checks, parse_blob
from dabbench.common import LoopSource, reference_of
from dabbench.drivers import core
from dabbench.gen.loop import make_loops, period
from dabbench.reference.receiver import Reference, loop_rows

__all__ = ["Driver", "reference_taps"]

#: the reference's per-frame readings that depend on the noise draw
TAPS = ("snr", "fine", "coarse", "t_off", "t_ok", "fib", "fic_ok",
        "spectra", "constel")


class Driver(core.Driver):
    def _inputs(self) -> None:
        from dabjax_torch.runtime.config import ReceiverConfig
        from dabjax_torch.runtime.receiver import Receiver
        self.loop, self.twin = make_loops(self.cfg, self.seed, draws=2)
        pin = self.dev.type == "cuda"
        self.rows = []
        for loop in (self.loop, self.twin):
            rows = self.block_rows(loop.u8)
            buf = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=pin)
            self.rows.append(buf.copy_(rows))
        rc = ReceiverConfig(mode=self.cfg["mode"], frames_per_block=self.F)
        self.rx = Receiver(LoopSource(self.loop.u8), rc, device=self.dev)
        # the receiver keeps the device rows and the coarse CFO itself
        self.block_fn, self.coarse = self.rx._block_fn, None
        self.turn = 0

    def _blockgraph(self):
        rows = self.rows[self.turn % 2]
        self.turn += 1
        return self.rx._block(rows)

    def window(self, seconds: float) -> None:
        self.turn = 0                    # window block k reads buffer k % 2
        self.firsts = [None, None]
        super().window(seconds)

    def _read(self, k: int) -> None:
        if self.events[k % 2] is not None:
            self.events[k % 2].synchronize()
        got = self.pinned[k % 2].numpy()
        if k < 2:
            self.firsts[k] = got.copy()
        elif not np.array_equal(got, self.firsts[k % 2]):
            self.differ += 1

    def end_to_end(self) -> Dict[str, float]:
        """The core's signal seconds a second, under a name of its own:
        the host link's rate drifts from run to run, so the cell needs a
        wider bound than the core's."""
        return {"ensemble_rt.upload": super().end_to_end()["ensemble_rt"]}

    def release(self) -> None:
        super().release()
        self.rx.close()
        del self.rx

    def check(self) -> Checks:
        p = self.p
        buckets = [([g.subch_id for g in geoms], shape)
                   for geoms, shape in self.meta]
        port = [parse_blob(b, self.F, self.n_fib, p.T_u, p.K, buckets)
                for b in self.firsts]
        ref = reference_of(self.loop, self.dev)
        checks = core.judge(port[0], ref, p, self.F, self.differ)
        twin = dict(ref, **reference_taps(self.twin, self.dev))
        return core.judge(port[1], twin, p, self.F, 0, checks)

    def failed(self, checks: Checks) -> int:
        """Blocks that differ from their buffer's first, or, where a first
        is wrong by any number, the blocks equal to it."""
        first_bad = any(v > LIMITS[k] for k, v in checks.values.items()
                        if k != "blocks_differ")
        return self.blocks - self.differ if first_bad else self.differ


def reference_taps(loop, device, chunk: int = 10) -> Dict[str, np.ndarray]:
    """The reference's per-frame taps and FIBs of one period of ``loop``
    (``decode_loop`` without the MSC)."""
    ref = Reference(loop.cfg, device)
    n = period(ref.p).frames
    parts = []
    for f0 in range(0, n, chunk):
        d = ref.demod(loop_rows(loop.u8, ref.p,
                                range(f0, min(f0 + chunk, n))))
        d["fib"], d["fic_ok"] = ref.fic(d["soft"])
        parts.append(d)
    return {k: np.concatenate([d[k] for d in parts]) for k in TAPS}
