"""Elementwise rate by dtype on chains no compiler can fold, on the card
(the port of the ``vpu`` half of ``tools/vpu_probe2.py``).

Two tiles v, w and n / 2 dependent pairs v <- max(v, w); w <- w + v, out
v: the second tile keeps both values live, so no op can be dropped.
Integer adds wrap, bf16 rounds after every op.
:func:`pair_chain_cuda` runs the kernel (``csrc/chains.cu``, one thread
per 32-bit word of each tile), built for the op counts :data:`PAIR_NS`;
:func:`pair_chain_torch` is its plain version.

``main()`` (or ``main(["vpu"])``) prints, for float32, int32, int16 and
bfloat16 on [256, 4480] tiles, the per-op us and Gelem/s from the slope
between n = 16 and 96 ops (the TPU probe's), kernel and plain; the
kernel line adds the slope between n = 512 and 2048 (see
``vpu_probe``: the short chains read mostly the launch).  The probe's
``dot`` half (``make_dots``, the marginal cost of a small matrix product)
is not ported yet: ``dot`` or ``both`` on the command line says so on
stderr and exits 2.

    python -m dabjax_torch.tools.vpu_probe2 [vpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda
from dabjax_torch.tools import vpu_probe

__all__ = ["DTYPES", "PAIR_NS", "SHAPE", "pair_tiles", "pair_chain_cuda",
           "pair_chain_torch", "sass_op_counts", "rates", "reset_launches",
           "main"]

#: the dtypes, in the TPU probe's order
DTYPES = ("float32", "int32", "int16", "bfloat16")
#: the op counts (two per pair) the kernel is built for
PAIR_NS = (16, 96, 512, 2048)
#: the TPU probe's tiles
SHAPE = (256, 4480)
#: launches of the pair-chain kernel since the last reset
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pair_tiles(dtype: str, shape=SHAPE, seed: int = 0):
    """(x, y): integers in [-3, 2] as ``dtype`` of ``shape``, from
    ``seed`` (the TPU probe's inputs)."""
    rng = np.random.default_rng(seed)
    dt = vpu_probe.DTYPES[dtype]
    return tuple(torch.from_numpy(rng.integers(-3, 3, size=shape)).to(dt)
                 for _ in range(2))


def pair_chain_cuda(x: torch.Tensor, y: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The kernel: n / 2 dependent pairs (v, w) <- (max(v, w), w + max(v,
    w)) from (x, y); returns v."""
    global LAUNCHES
    dtype = vpu_probe._dtype_name(x, "pair_chain_cuda")
    words = vpu_probe._words(x, "pair_chain_cuda")
    vpu_probe._words(y, "pair_chain_cuda")
    if dtype not in DTYPES or y.dtype != x.dtype or y.shape != x.shape:
        raise ValueError(f"pair_chain_cuda: need two tiles of one shape in "
                         f"one of {DTYPES}, got {x.dtype} {tuple(x.shape)}, "
                         f"{y.dtype} {tuple(y.shape)}")
    if n not in PAIR_NS:
        raise ValueError(f"pair_chain_cuda: n {n} not in {PAIR_NS}")
    out = torch.empty_like(x)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dabjax_probe_pair_chain(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), words,
            list(vpu_probe.DTYPES).index(dtype), n, 0, stream)
        LAUNCHES += 1
    viterbi_cuda._check(rc, "pair_chain_cuda")
    return out


def pair_chain_torch(x: torch.Tensor, y: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Plain version of :func:`pair_chain_cuda`: the probe's torch ops,
    any n."""
    v, w = x, y
    for _ in range(n // 2):
        v = torch.maximum(v, w)
        w = w + v
    return v


def sass_op_counts(n1: int = 16, n2: int = 96) -> dict:
    """{dtype: SASS instructions per op} of the pair kernel (n2 ops over
    n1 ops, per op)."""
    lengths = vpu_probe._sass_lengths(r"pair_chainILi(\d+)ELi(\d+)E")
    codes = list(vpu_probe.DTYPES)
    return {dtype: (lengths[(codes.index(dtype), n2)]
                    - lengths[(codes.index(dtype), n1)]) / (n2 - n1)
            for dtype in DTYPES}


def rates(x: torch.Tensor, y: torch.Tensor) -> dict:
    """us per op of the pair chain on the CUDA tiles (x, y): the kernel's
    slope from n = 16 to 96 (``us``) and from 512 to 2048 (``long_us``),
    the plain version's from 16 to 96 (``plain_us``)."""
    def kernel(n):
        return pair_chain_cuda(x, y, n)

    def plain(n):
        return pair_chain_torch(x, y, n)

    return dict(us=vpu_probe.per_op(kernel, 16, 96, 100),
                long_us=vpu_probe.per_op(kernel, 512, 2048, 10),
                plain_us=vpu_probe.per_op(plain, 16, 96, 3))


def main(argv=()) -> int:
    which = argv[0] if argv else "vpu"
    if which in ("dot", "both"):
        print("vpu_probe2: the dot half (make_dots in tools/vpu_probe2.py) "
              "is not ported yet; run with `vpu`", file=sys.stderr)
        return 2
    if which != "vpu" or len(argv) > 1:
        print("usage: python -m dabjax_torch.tools.vpu_probe2 [vpu]",
              file=sys.stderr)
        return 2
    if not tools.have_card("vpu_probe2"):
        return 1
    dev = torch.device("cuda", 0)
    elems = SHAPE[0] * SHAPE[1]
    for dtype in DTYPES:
        r = rates(*(t.to(dev) for t in pair_tiles(dtype)))
        print(f"vpu {dtype:9s} kernel: {vpu_probe._rate(elems, r['us'])}  "
              f"(n 512->2048: {vpu_probe._rate(elems, r['long_us'])})",
              flush=True)
        print(f"vpu {dtype:9s} plain : "
              f"{vpu_probe._rate(elems, r['plain_us'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
