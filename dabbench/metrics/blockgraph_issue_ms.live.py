"""Host ms a block in the receiver's own ``blockgraph`` span
(``StageProfiler``, inside ``stage_host``): the rows' upload and the
issue of ``BlockFn.frames`` + ``assemble`` (``Receiver._block``)."""

UNIT = "ms/block"


def read(ctx):
    s = ctx.program_spans.get("blockgraph")
    if s is None or not ctx.blocks:
        return None
    return s * 1e3 / ctx.blocks
