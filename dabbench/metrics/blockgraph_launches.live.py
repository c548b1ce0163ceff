"""CUDA kernels a block launched inside the receiver's ``blockgraph``
span (``BlockFn.frames`` + ``assemble``), each placed by its launch's
correlation id (the device trace)."""

UNIT = "launches/block"


def read(ctx):
    if ctx.trace is None or not ctx.blocks \
            or not ctx.trace.count("blockgraph"):
        return None
    return sum(1 for e in ctx.trace.kernels()
               if e[4] == "blockgraph") / ctx.blocks
