"""CUDA kernel launches a bank period in the traced window (kernels the
device ran, from the profiler's trace), over all the bank's channels."""

UNIT = "launches/period"


def read(ctx):
    if ctx.trace is None or not ctx.periods:
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.periods if n else None
