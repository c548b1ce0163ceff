"""Host ms a bank period in the bank's own ``bank_pull`` span
(``MultiReceiver.profiler``): the staged blobs joined on the device and
the bank's one device-to-host copy, the wait on the device included."""

UNIT = "ms/period"


def read(ctx):
    s = ctx.program_spans.get("bank_pull")
    if s is None or not ctx.periods:
        return None
    return s * 1e3 / ctx.periods
