"""Elementwise rate by dtype on chains no compiler can fold, and the
marginal cost of a small matrix product, on the card (the port of
``tools/vpu_probe2.py``).

``vpu`` half: two tiles v, w and n / 2 dependent pairs v <- max(v, w);
w <- w + v, out v: the second tile keeps both values live, so no op can
be dropped.  Integer adds wrap, bf16 rounds after every op.
:func:`pair_chain_cuda` runs the kernel (``csrc/chains.cu``, one thread
per 32-bit word of each tile), built for the op counts :data:`PAIR_NS`;
:func:`pair_chain_torch` is its plain version.

``dot`` half (``make_dots``): n chained products acc = W @ X[(i % 8) *
kdim :][:kdim] + acc * 1e-9 (dots i and i + 8 are the same product) for
the TPU probe's shapes :data:`DOT_SHAPES` over 4480 columns, X integers
in [-127, 127] and W in {-1, 0, 1}, as float32.  :func:`dots_cuda` runs
the kernel (``csrc/dots.cu``, FFMA on the CUDA cores, n a multiple of 8;
W stays in registers and every dot reloads its X, so none is folded into
another);
:func:`dots_torch` is its plain version.  The products are exact, and
the two roundings of each step are those of torch's two ops, so the two
agree bit for bit.  :func:`dot_sass_counts` counts the FFMA
and FMUL of one dot.

``main()`` (``main(["vpu" | "dot" | "both"])``, default both, as the TPU
probe) prints, for ``vpu``, for float32, int32, int16 and bfloat16 on
[256, 4480] tiles, the per-op us and Gelem/s from the slope between n =
16 and 96 ops (the TPU probe's), kernel and plain, the kernel line adding
the slope between n = 512 and 2048 (see ``vpu_probe``: the short chains
read mostly the launch); for ``dot``, for each shape the us per dot from
the slope between n = 8 and 40 dots, kernel and plain, the kernel line
adding the slope between 40 and 1000 dots (the device's time: 32 dots of
[32, 8] take less than the host's time to issue a call).

    python -m dabjax_torch.tools.vpu_probe2 [vpu|dot|both]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda
from dabjax_torch.tools import vpu_probe

__all__ = ["DTYPES", "PAIR_NS", "SHAPE", "pair_tiles", "pair_chain_cuda",
           "pair_chain_torch", "sass_op_counts", "rates", "DOT_SHAPES",
           "DOT_NS", "DOT_NS_LONG", "DOT_COLS", "DOT_GROUP", "dot_inputs",
           "dots_cuda", "dots_torch", "dot_sass_counts", "dot_rates",
           "ENTRIES", "main"]

#: the dtypes, in the TPU probe's order
DTYPES = ("float32", "int32", "int16", "bfloat16")
#: the op counts (two per pair) the kernel is built for
PAIR_NS = (16, 96, 512, 2048)
#: the TPU probe's tiles
SHAPE = (256, 4480)
#: the ``dot`` half's (rows of W, depth) and the TPU probe's tags
DOT_SHAPES = ((256, 8, "bm [256,8]"), (128, 32, "blkdiag [128,32]"),
              (32, 8, "uv [32,8]"))
#: the TPU probe's dot counts, and the longer pair whose slope is the
#: device's per-dot time (at the short one the host's issue time hides it)
DOT_NS = (8, 40)
DOT_NS_LONG = (40, 1000)
#: columns of X and of the result
DOT_COLS = 4480
#: columns whose chains a lane of the chained-dot kernel runs together,
#: by rows of W (``csrc/dots.cu`` kG: 3 at 8 rows a lane)
DOT_GROUP = {256: 3, 128: 1, 32: 1}
_vp, _i = ctypes.c_void_p, ctypes.c_int
#: the C entries launched here: their arguments' ctypes types before the
#: stream (``_build.launch``, which counts them as "pair_chain" and
#: "dots_chain")
ENTRIES = {"dabjax_probe_pair_chain": (_vp, _vp, _vp, ctypes.c_longlong, _i,
                                       _i, ctypes.c_uint),
           "dabjax_probe_dots": (_vp, _vp, _vp, _i, _i, _i, _i)}


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
    _build.launch("pair_chain", ENTRIES, "dabjax_probe_pair_chain",
                  x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(), words,
                  list(vpu_probe.DTYPES).index(dtype), n, 0)
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


def dot_inputs(seed: int = 0, cols: int = DOT_COLS) -> list:
    """[(tag, x [8 * kdim, cols], w [rows, kdim])] float32 for each of
    :data:`DOT_SHAPES`: x integers in [-127, 127], w in {-1, 0, 1}, drawn
    in turn from one ``default_rng(seed)`` (the TPU probe's inputs at the
    default ``seed`` and ``cols``)."""
    rng = np.random.default_rng(seed)
    out = []
    for rows_w, kdim, tag in DOT_SHAPES:
        x = rng.integers(-127, 128, size=(8 * kdim, cols))
        w = rng.integers(-1, 2, size=(rows_w, kdim))
        out.append((tag, torch.from_numpy(x.astype(np.float32)),
                    torch.from_numpy(w.astype(np.float32))))
    return out


def _dot_shape(x: torch.Tensor, w: torch.Tensor, name: str) -> tuple:
    if x.dim() != 2 or w.dim() != 2 or x.shape[0] != 8 * w.shape[1]:
        raise ValueError(f"{name}: need x [8 * kdim, cols] and w [rows, "
                         f"kdim], got {tuple(x.shape)}, {tuple(w.shape)}")
    return w.shape[0], w.shape[1], x.shape[1]


def dots_cuda(x: torch.Tensor, w: torch.Tensor, n_dots: int) -> torch.Tensor:
    """The kernel: ``n_dots`` chained products (see the module) -> float32
    [rows, cols]."""
    rows, kdim, cols = _dot_shape(x, w, "dots_cuda")
    for t, name in ((x, "x"), (w, "w")):
        viterbi_cuda._require(t, torch.float32, 2, f"dots_cuda {name}")
    if (rows, kdim) not in [s[:2] for s in DOT_SHAPES] \
            or n_dots < 0 or n_dots % 8 or cols % 16:
        raise ValueError(f"dots_cuda: built for (rows, kdim) in "
                         f"{[s[:2] for s in DOT_SHAPES]}, n a multiple of 8 "
                         f"and cols a multiple of 16; got ({rows}, {kdim}), "
                         f"{n_dots}, {cols}")
    out = torch.empty((rows, cols), dtype=torch.float32, device=x.device)
    _build.launch("dots_chain", ENTRIES, "dabjax_probe_dots", x.device,
                  x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, kdim,
                  n_dots, cols)
    return out


def dots_torch(x: torch.Tensor, w: torch.Tensor, n_dots: int) -> torch.Tensor:
    """Plain version of :func:`dots_cuda`: the probe's torch ops, any n."""
    rows, kdim, cols = _dot_shape(x, w, "dots_torch")
    acc = torch.zeros((rows, cols), dtype=torch.float32, device=x.device)
    for i in range(n_dots):
        xi = x[(i % 8) * kdim: (i % 8) * kdim + kdim]
        acc = w @ xi + acc * 1e-9
    return acc


def dot_sass_counts() -> dict:
    """{tag: FFMA and FMUL instructions of one dot per thread} of the
    chained-dot kernel.  The loops over a warp's columns and over passes
    of 8 dots are not unrolled (n is a run-time argument), so the
    kernel's count over 8 is one dot's of the columns a lane runs
    together (:data:`DOT_GROUP`): rows / 32 x columns x (kdim FFMA + the
    FMUL of acc * 1e-9) (0 would mean the compiler folded the
    products)."""
    lengths = vpu_probe._sass_lengths(r"dots_chainILi(\d+)ELi(\d+)E",
                                      ops=("FFMA", "FMUL"))
    return {tag: lengths.get((rows, kdim), 0) / 8
            for rows, kdim, tag in DOT_SHAPES}


def dot_rates(x: torch.Tensor, w: torch.Tensor) -> dict:
    """us per dot on the CUDA inputs (x, w): the slope from n = 8 to 40
    dots of the kernel (``us``) and of the plain version (``plain_us``),
    and the kernel's from 40 to 1000 (``long_us``)."""
    def kernel(n):
        return dots_cuda(x, w, n)

    return dict(us=vpu_probe.per_op(kernel, *DOT_NS, 100),
                long_us=vpu_probe.per_op(kernel, *DOT_NS_LONG, 10),
                plain_us=vpu_probe.per_op(lambda n: dots_torch(x, w, n),
                                          *DOT_NS, 3))


def main(argv=()) -> int:
    which = argv[0] if argv else "both"
    if which not in ("vpu", "dot", "both") or len(argv) > 1:
        print("usage: python -m dabjax_torch.tools.vpu_probe2 "
              "[vpu|dot|both]", file=sys.stderr)
        return 2
    if not tools.have_card("vpu_probe2"):
        return 1
    dev = torch.device("cuda", 0)
    if which in ("vpu", "both"):
        elems = SHAPE[0] * SHAPE[1]
        for dtype in DTYPES:
            r = rates(*(t.to(dev) for t in pair_tiles(dtype)))
            print(f"vpu {dtype:9s} kernel: {vpu_probe._rate(elems, r['us'])}"
                  f"  (n 512->2048: {vpu_probe._rate(elems, r['long_us'])})",
                  flush=True)
            print(f"vpu {dtype:9s} plain : "
                  f"{vpu_probe._rate(elems, r['plain_us'])}", flush=True)
    if which in ("dot", "both"):
        for tag, x, w in dot_inputs():
            r = dot_rates(x.to(dev), w.to(dev))
            print(f"dot {tag:17s} kernel: {r['us']:7.3f} us/dot  (n 40->1000: "
                  f"{r['long_us']:7.3f} us/dot)", flush=True)
            print(f"dot {tag:17s} plain : {r['plain_us']:7.3f} us/dot",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
