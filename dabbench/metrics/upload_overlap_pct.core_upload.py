"""Share of the window's host-to-device copy time during which a kernel
also ran on the device: how much of the rows' upload hides behind
compute.  The copies are those ``upload_roofline.core_upload`` reads."""

import bisect

from dabbench.trace import union_seconds

UNIT = "%"


def read(ctx):
    if ctx.trace is None:
        return None
    copies = ctx.trace.host_to_device()
    total = sum(b - a for a, b in copies)
    if total <= 0:
        return None
    kernels = sorted((e[2], e[2] + e[3]) for e in ctx.trace.in_window()
                     if e[1] == "kernel")
    ends = []                       # running max of the kernels' ends
    for _, b in kernels:
        ends.append(max(b, ends[-1]) if ends else b)
    under = 0.0
    for a, b in copies:
        # kernels that start before the copy ends and end after it starts
        hi = bisect.bisect_left(kernels, (b,))
        lo = bisect.bisect_right(ends, a)
        under += union_seconds([(max(x, a), min(y, b))
                                for x, y in kernels[lo:hi]]) * 1e6
    return 100.0 * under / total
