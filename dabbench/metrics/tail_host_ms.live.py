"""Mean ms of a tail block less its ``pull_wait``, over the traced
window's tail blocks: the receiver's blocks (their span records grouped
by owner and block number, those with a ``pull_wait``) whose time, from
their first record's start to their last record's end, is at or above
the window's 95th percentile (``tail_pull_wait_ms.live``'s
``tail_blocks``).  None on a program that keeps no records, when the
ring overflowed, or with fewer than 10 tail blocks."""

from dabbench.run import read_layer_metric

UNIT = "ms/block"


def read(ctx):
    from dabjax_torch.runtime import profiling
    records = getattr(profiling, "records", None)
    if records is None or profiling.overflow():
        return None
    tail = read_layer_metric("tail_pull_wait_ms.live").tail_blocks(
        records())
    if tail is None:
        return None
    return sum(t - w for t, w in tail) / len(tail)
