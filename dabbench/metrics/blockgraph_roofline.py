"""The block graph's share of its roofline: the least time an H100 SXM
could take for a block's graph over ``blockgraph_ms``.

The bound is fixed from the cell's shapes, whatever implements the
graph: the larger of the bytes it must move at 3.35 TB/s (the u8 IQ
rows read once, the CIF soft block written once at one byte a soft bit,
the FIB bytes written once) and its FFTs' operations (5 N log2 N for
each of the L ``T_u``-point transforms of every frame) at 67 TFLOP/s
(float32, outside the tensor cores).
"""

import math

from dabbench.peaks import FP32_FLOPS, HBM_BYTES_S

UNIT = "%"


def bound_s(shapes) -> float:
    F = shapes["F"]
    cifs = F * shapes["cifs_per_frame"]
    bytes_ = (F * shapes["need"] * 2               # u8 IQ rows
              + cifs * shapes["cif_bits"]          # int8 CIF soft block
              + F * shapes["n_fib"] * 30)          # FIB bytes
    n = shapes["T_u"]
    flops = F * shapes["L"] * 5 * n * math.log2(n)
    return max(bytes_ / HBM_BYTES_S, flops / FP32_FLOPS)


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("blockgraph"):
        return None
    per_block = ctx.trace.span_device_s("blockgraph") \
        / ctx.trace.count("blockgraph")
    if per_block <= 0:
        return None
    return 100.0 * bound_s(ctx.shapes) / per_block
