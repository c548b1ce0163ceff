"""CUDA kernels a block launched inside the receiver's ``msc`` span
(``EnsembleDecoder.fused``), each placed by its launch's correlation id
(the device trace)."""

UNIT = "launches/block"


def read(ctx):
    if ctx.trace is None or not ctx.blocks or not ctx.trace.count("msc"):
        return None
    return sum(1 for e in ctx.trace.kernels() if e[4] == "msc") / ctx.blocks
