"""Host ms a block in the receiver's own ``stage_host`` and
``consume_host`` spans (``StageProfiler``)."""

UNIT = "ms/block"


def read(ctx):
    s = ctx.program_spans.get("stage_host", 0.0) \
        + ctx.program_spans.get("consume_host", 0.0)
    if not s or not ctx.blocks:
        return None
    return s * 1e3 / ctx.blocks
