"""Host ms a bank period in the receivers' own ``stage_host`` spans
(``StageProfiler``), summed over the channels: the row stacking and the
block graph's issue.  The source read (``_ensure``) and the MSC issue
(``EnsembleDecoder.fused``) fall outside the span."""

UNIT = "ms/period"


def read(ctx):
    s = ctx.program_spans.get("stage_host")
    if not s or not ctx.periods:
        return None
    return s * 1e3 / ctx.periods
