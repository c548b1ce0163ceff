"""Host ms a bank period in the receivers' own ``consume_host`` spans
(``StageProfiler``), summed over the channels: parsing the pulled blob,
the FIB database and routing every logical frame."""

UNIT = "ms/period"


def read(ctx):
    s = ctx.program_spans.get("consume_host")
    if not s or not ctx.periods:
        return None
    return s * 1e3 / ctx.periods
