"""The hand-written demod kernels' share of their roofline: the least
time for a block's demod bytes at 3.35 TB/s over the device time of
``guard_corr``, ``mix_windows`` and ``dqpsk_soft`` (``csrc/demod.cu``) in
the traced window, a block.

The bytes are each kernel's input read once and its output written once,
from the cell's mode and frames, whatever implements them: the guards
and their copies (u8 pairs) and the CFOs; the useful samples in and the
complex64 windows out; the K active carriers of each spectrum in, the
float32 soft bits out, and the carrier table.  The core driver's shapes
carry no ``T_g``, so the mode's constants come from the configuration.
"""

import re

from dabbench.gen.constants import get_mode
from dabbench.peaks import HBM_BYTES_S

UNIT = "%"
KERNELS = re.compile(r"\b(guard_corr|mix_windows|dqpsk_soft)\b(?!_)")


def bound_s(F: int, p) -> float:
    """Seconds for the demod bytes of ``F`` frames of mode ``p`` at
    ``HBM_BYTES_S``."""
    guard = F * (p.L - 1) * p.T_g * 2 * 2 + F * 4 * 3
    mix = F * p.L * p.T_u * (2 + 8) + F * 4
    soft = (F * p.L * p.K * 8 + F * (p.L - 1) * 2 * p.K * 4
            + p.K * 4 + F * 4)
    return (guard + mix + soft) / HBM_BYTES_S


def read(ctx):
    if ctx.trace is None or not ctx.blocks:
        return None
    ks = [e for e in ctx.trace.kernels() if KERNELS.search(e[0])]
    blocks = ctx.trace.count("block")
    if not ks or not blocks:
        return None
    per_block = sum(e[3] for e in ks) * 1e-6 / blocks
    p = get_mode(ctx.cfg["mode"])
    return 100.0 * bound_s(ctx.shapes["F"], p) / per_block
