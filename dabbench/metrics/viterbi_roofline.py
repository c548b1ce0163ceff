"""The Viterbi kernels' share of their roofline: the least time for a
block's codewords (FIC and every subchannel) over the device time of the
forward and traceback kernels in the traced window, a block.

The forward bound is the larger of 3 operations a state a step (64
states, radix 2) at 33.5 T/s and its bytes (int8 soft in, 8 bytes of
decisions a step out) at 3.35 TB/s; the traceback's is its bytes (the
decisions read, the bits written). The kernels are the port's K1/K2
(``forward_acs``, ``traceback``) and K3/K4 (``forward_acs_words``,
``traceback_words``) of ``csrc/viterbi.cu``.
"""

import re

from dabbench.peaks import ACS_OPS_S, HBM_BYTES_S

UNIT = "%"
KERNELS = re.compile(r"\b(forward_acs|traceback|forward_acs_words|"
                     r"traceback_words)\b(?!_)")


def bound_s(shapes) -> float:
    cw = [shapes["codewords"]["fic"], *shapes["codewords"]["msc"]]
    steps = sum(b * (n + 6) for b, n in cw)
    bits = sum(b * n for b, n in cw)
    fwd = max(3 * 64 * steps / ACS_OPS_S, (4 * steps + 8 * steps)
              / HBM_BYTES_S)
    tb = (8 * steps + bits / 8) / HBM_BYTES_S
    return fwd + tb


def read(ctx):
    if ctx.trace is None or not ctx.blocks:
        return None
    ks = [e for e in ctx.trace.kernels() if KERNELS.search(e[0])]
    blocks = ctx.trace.count("block")
    if not ks or not blocks:
        return None
    per_block = sum(e[3] for e in ks) * 1e-6 / blocks
    return 100.0 * bound_s(ctx.shapes) / per_block
