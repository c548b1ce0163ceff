"""CUDA kernel launches a block in the traced window (kernels the device
ran, from the profiler's trace)."""

UNIT = "launches/block"


def read(ctx):
    if ctx.trace is None or not ctx.blocks:
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.blocks if n else None
