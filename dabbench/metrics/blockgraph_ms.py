"""Device ms a block of the kernels launched under the harness's
``blockgraph`` span (``BlockFn.frames`` and ``assemble``): the block
graph's device time (core cell)."""

UNIT = "ms/block"


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("blockgraph"):
        return None
    s = ctx.trace.span_device_s("blockgraph")
    return s * 1e3 / ctx.trace.count("blockgraph") if s > 0 else None
