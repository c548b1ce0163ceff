"""Host ms a block in the receiver's own ``source`` span
(``StageProfiler``): the source read into the sample buffer
(``Receiver._ensure``)."""

UNIT = "ms/block"


def read(ctx):
    s = ctx.program_spans.get("source")
    if s is None or not ctx.blocks:
        return None
    return s * 1e3 / ctx.blocks
