"""CUDA graph captures in the traced window: the process's ``capture``
span records (``profiling.records``; replays make none).  None on a
program that keeps no records, when the ring overflowed, or when it
holds no record of the receiver's or the bank's spans."""

UNIT = "captures"


def read(ctx):
    from dabjax_torch.runtime import profiling
    records = getattr(profiling, "records", None)
    if records is None or profiling.overflow():
        return None
    recs = records()
    if not any(r.name in profiling.SPANS for r in recs):
        return None
    return sum(1 for r in recs if r.name == "capture")
