"""The rows' upload's share of its roofline: a block's u8 IQ rows at the
host link's peak (``peaks.PCIE_H2D_BYTES_S``) over the device time of
the window's host-to-device copies a block.

The copies are the device trace's ``gpu_memcpy`` events with ``HtoD`` in
their name, wherever the port issues them; the bytes are fixed by the
cell's shapes, so a port that copied less than the block's rows would
read above 100 %.
"""

from dabbench.peaks import PCIE_H2D_BYTES_S

UNIT = "%"


def read(ctx):
    if ctx.trace is None or ctx.blocks <= 0:
        return None
    copy_s = sum(b - a for a, b in ctx.trace.host_to_device()) * 1e-6
    if copy_s <= 0:
        return None
    row_bytes = ctx.shapes["F"] * ctx.shapes["need"] * 2
    return 100.0 * row_bytes / PCIE_H2D_BYTES_S / (copy_s / ctx.blocks)
