"""Host ms a block in the receiver's own ``msc`` span
(``StageProfiler``): the geometries, the decoder key and the issue of
``EnsembleDecoder.fused`` in ``Receiver.stage``."""

UNIT = "ms/block"


def read(ctx):
    s = ctx.program_spans.get("msc")
    if s is None or not ctx.blocks:
        return None
    return s * 1e3 / ctx.blocks
