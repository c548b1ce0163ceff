"""Host ms a block in the receiver's own ``route`` span
(``StageProfiler``, inside ``consume_host``): the block's logical frames
handed to their data handlers, audio services or pool."""

UNIT = "ms/block"


def read(ctx):
    s = ctx.program_spans.get("route")
    if s is None or not ctx.blocks:
        return None
    return s * 1e3 / ctx.blocks
