"""Share of the traced window in which no kernel, copy or memset ran on
the device (32-channel bank cell)."""

UNIT = "%"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.trace.window_s) if busy > 0 else None
