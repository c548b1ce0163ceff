"""Device ms a block of the kernels launched under the harness's ``msc``
span (``EnsembleDecoder.fused``): the MSC chain's device time (core
cell)."""

UNIT = "ms/block"


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("msc"):
        return None
    s = ctx.trace.span_device_s("msc")
    return s * 1e3 / ctx.trace.count("msc") if s > 0 else None
