"""Ms a bank period of garbage collection in the traced window: the
union of the process's ``gc`` span records (``profiling.records``), over
the window's periods.  None on a program that keeps no records, when the
ring overflowed, or when it holds no record of the bank's spans."""

from dabbench.trace import union_seconds

UNIT = "ms/period"


def read(ctx):
    from dabjax_torch.runtime import profiling
    records = getattr(profiling, "records", None)
    if records is None or profiling.overflow() or not ctx.periods:
        return None
    recs = records()
    if not any(r.name.startswith("bank_") for r in recs):
        return None
    gc = [(r.start_ns * 1e-3, r.end_ns * 1e-3) for r in recs
          if r.name == "gc"]
    return union_seconds(gc) * 1e3 / ctx.periods
