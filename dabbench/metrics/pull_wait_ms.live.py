"""Ms a block the receiver waited for its blocks' device work: the
receiver's ``pull_wait`` span records (``profiling.records``, made while
the traced window's profiler ran), summed, over the window's blocks.
None on a program that keeps no records, when the ring overflowed, or
when it holds no ``pull_wait`` record."""

UNIT = "ms/block"


def read(ctx):
    from dabjax_torch.runtime import profiling
    records = getattr(profiling, "records", None)
    if records is None or profiling.overflow() or not ctx.blocks:
        return None
    waits = [r.end_ns - r.start_ns for r in records()
             if r.name == "pull_wait"]
    if not waits:
        return None
    return sum(waits) * 1e-6 / ctx.blocks
