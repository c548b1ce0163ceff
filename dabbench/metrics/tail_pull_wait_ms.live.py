"""Mean ms of ``pull_wait`` over the traced window's tail blocks: the
receiver's blocks (their span records grouped by owner and block
number, those with a ``pull_wait``) whose time, from their first
record's start to their last record's end, is at or above the window's
95th percentile.  None on a program that keeps no records, when the
ring overflowed, or with fewer than 10 tail blocks."""

import numpy as np

UNIT = "ms/block"
TAIL_MIN = 10


def tail_blocks(recs):
    """[(block ms, pull_wait ms)] of the tail blocks, or None."""
    blocks = {}
    for r in recs:
        if r.block is None or r.owner == "bank":
            continue
        b = blocks.setdefault((r.owner, r.block),
                              [r.start_ns, r.end_ns, 0, False])
        b[0], b[1] = min(b[0], r.start_ns), max(b[1], r.end_ns)
        if r.name == "pull_wait":
            b[2] += r.end_ns - r.start_ns
            b[3] = True
    times = [((b[1] - b[0]) * 1e-6, b[2] * 1e-6)
             for b in blocks.values() if b[3]]
    if not times:
        return None
    cut = np.percentile([t for t, _ in times], 95)
    tail = [(t, w) for t, w in times if t >= cut]
    return tail if len(tail) >= TAIL_MIN else None


def read(ctx):
    from dabjax_torch.runtime import profiling
    records = getattr(profiling, "records", None)
    if records is None or profiling.overflow():
        return None
    tail = tail_blocks(records())
    if tail is None:
        return None
    return sum(w for _, w in tail) / len(tail)
