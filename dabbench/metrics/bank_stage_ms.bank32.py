"""Host ms a bank period in the bank's own ``bank_stage`` span
(``MultiReceiver.profiler``): every channel's ``stage()``, that is the
source reads, the rows' uploads and the block and MSC graphs' replays."""

UNIT = "ms/period"


def read(ctx):
    s = ctx.program_spans.get("bank_stage")
    if s is None or not ctx.periods:
        return None
    return s * 1e3 / ctx.periods
