"""Host ms a bank period in the bank's own ``bank_consume`` span
(``MultiReceiver.profiler``): every channel's ``consume()``, that is its
slice of the pulled blob parsed, the correctors, the FIBs and every
logical frame routed."""

UNIT = "ms/period"


def read(ctx):
    s = ctx.program_spans.get("bank_consume")
    if s is None or not ctx.periods:
        return None
    return s * 1e3 / ctx.periods
