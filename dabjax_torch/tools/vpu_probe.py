"""Elementwise op cost by dtype, on the card (the port of
``tools/vpu_probe.py``).

A chain of n dependent elementwise ops on a resident tile, by dtype
(float32, bfloat16, int32, int16, int8), in one kernel; the slope
between two chain lengths is the per-op cost without the launch and the
tile's one read and one write.  The ops, as the TPU probe's:

* ``add``: v <- v + v;
* ``max``: v <- max(v, v * 1);
* ``mix``: v <- max(v + v, v).

Integer adds wrap mod 2^k (as XLA's and torch's do); bf16 rounds after
every op.  :func:`elementwise_chain_cuda` runs the kernel
(``csrc/chains.cu``: one thread per 32-bit word, so one f32 or int32,
two bf16 or int16, four int8, each op one instruction form issued as
inline PTX so that no compiler folds the chain), built for the chain
lengths :data:`CHAIN_NS`; :func:`elementwise_chain_torch` is its plain
version (the same n torch ops on the tile).  :func:`sass_op_counts`
counts the SASS instructions each op adds in the built library.

``main()`` prints, for each dtype and op on a [512, 4480] tile, the
per-op us and Gelem/s from the slope between n = 8 and 64 (the TPU
probe's), kernel and plain; the kernel line adds the slope between
n = 512 and 2048.  Times are the device's (``tools.device_ms``): at
n <= 64 a call's device work (one read and one write of the tile, a few
microseconds) is shorter than the host's time to issue it through the
wrapper (about 30 us on an H100 host), and back-to-back calls timed
from the host read the host's issue rate, with slopes about 0 of either
sign.  The long chains are bound by the issue rate of the op's pipe.

    python -m dabjax_torch.tools.vpu_probe
"""

from __future__ import annotations

import collections
import ctypes
import re
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools

__all__ = ["DTYPES", "OPS", "CHAIN_NS", "SHAPE", "tile",
           "elementwise_chain_cuda", "elementwise_chain_torch",
           "sass_op_counts", "per_op", "rates", "ENTRIES", "main"]

#: the dtypes, in the kernel's code order
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int16": torch.int16, "int8": torch.int8}
#: the ops, in the kernel's code order
OPS = ("add", "max", "mix")
#: the chain lengths the kernel is built for
CHAIN_NS = (3, 8, 64, 512, 2048)
#: the TPU probe's tile
SHAPE = (512, 4480)
_vp, _i, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
#: the C entry launched here: its arguments' ctypes types before the
#: stream (``_build.launch``, which counts it as "chain")
ENTRIES = {"dabjax_probe_chain": (_vp, _vp, ctypes.c_longlong, _i, _i, _i,
                                  _u, _u)}

#: each dtype's lowest value in every lane of a 32-bit word (max's
#: second operand: max(v, lowest) = v, and ptxas folds max(v, v) away)
_LOWEST = {"float32": 0xFF800000, "bfloat16": 0xFF80FF80,
           "int32": 0x80000000, "int16": 0x80008000, "int8": 0x80808080}


def tile(dtype: str, shape=SHAPE, seed: int = 0) -> torch.Tensor:
    """Integers 1 or 2 as ``dtype`` of ``shape``, from ``seed`` (the TPU
    probe's input)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, 3, size=shape)).to(DTYPES[dtype])


def _dtype_name(x: torch.Tensor, name: str) -> str:
    for key, dt in DTYPES.items():
        if x.dtype == dt:
            return key
    raise ValueError(f"{name}: dtype {x.dtype} is not one of "
                     f"{tuple(DTYPES)}")


def _words(x: torch.Tensor, name: str) -> int:
    """32-bit words of a contiguous CUDA tile."""
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA tensor required, got {x.device}")
    nbytes = x.numel() * x.element_size()
    if (not x.is_contiguous() or nbytes == 0 or nbytes % 4
            or x.data_ptr() % 4):
        raise ValueError(f"{name}: need a contiguous, 4-byte aligned tile "
                         f"of whole 32-bit words, got {tuple(x.shape)} "
                         f"{x.dtype}")
    return nbytes // 4


def elementwise_chain_cuda(x: torch.Tensor, op: str, n: int) -> torch.Tensor:
    """The kernel: ``n`` dependent ``op``s on every element of ``x``."""
    dtype = _dtype_name(x, "elementwise_chain_cuda")
    words = _words(x, "elementwise_chain_cuda")
    if op not in OPS or n not in CHAIN_NS:
        raise ValueError(f"elementwise_chain_cuda: op {op!r} / n {n}: built "
                         f"for {OPS} and n in {CHAIN_NS}")
    out = torch.empty_like(x)
    _build.launch("chain", ENTRIES, "dabjax_probe_chain", x.device,
                  x.data_ptr(), out.data_ptr(), words,
                  list(DTYPES).index(dtype), OPS.index(op), n,
                  _LOWEST[dtype], 0)
    return out


def elementwise_chain_torch(x: torch.Tensor, op: str,
                            n: int) -> torch.Tensor:
    """Plain version of :func:`elementwise_chain_cuda`: the probe's n torch
    ops, any n."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    v = x
    for _ in range(n):
        if op == "add":
            v = v + v
        elif op == "max":
            v = torch.maximum(v, v * 1)
        else:
            v = torch.maximum(v + v, v)
    return v


_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(
    r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _sass_lengths(pattern: str, ops: tuple | None = None) -> dict:
    """{template arguments: SASS instructions (no NOPs)} of each kernel of
    the built library whose mangled name matches ``pattern``; with
    ``ops``, only the instructions whose opcode starts with one of them."""
    key, counts = None, collections.Counter()
    for line in _build.sass().splitlines():
        m = _FUNCTION.search(line)
        if m:
            k = re.search(pattern, m.group(1))
            key = tuple(int(g) for g in k.groups()) if k else None
            continue
        m = _INSTRUCTION.match(line)
        if key is not None and m and m.group(1) != "NOP" and (
                ops is None or m.group(1).startswith(ops)):
            counts[key] += 1
    return dict(counts)


def sass_op_counts(n1: int = 8, n2: int = 64) -> dict:
    """{dtype: {op: SASS instructions per op}}: the instructions the
    chain kernel of n2 ops has over that of n1, per op (0 would mean the
    compiler folded the chain)."""
    lengths = _sass_lengths(r"elementwise_chainILi(\d+)ELi(\d+)ELi(\d+)E")
    return {dtype: {op: (lengths[(d, o, n2)] - lengths[(d, o, n1)])
                    / (n2 - n1) for o, op in enumerate(OPS)}
            for d, dtype in enumerate(DTYPES)}


def per_op(fn, n1: int, n2: int, reps: int) -> float:
    """us per op: the slope of ``fn(n)``'s device time
    (``tools.device_ms``) from n1 to n2 ops."""
    t1 = tools.device_ms(lambda: fn(n1), reps)
    t2 = tools.device_ms(lambda: fn(n2), reps)
    return (t2 - t1) / (n2 - n1) * 1e3


def rates(x: torch.Tensor, op: str) -> dict:
    """us per ``op`` on the CUDA tile ``x``: the kernel's slope from n = 8
    to 64 (``us``) and from 512 to 2048 (``long_us``), the plain
    version's from 8 to 64 (``plain_us``)."""
    def kernel(n):
        return elementwise_chain_cuda(x, op, n)

    def plain(n):
        return elementwise_chain_torch(x, op, n)

    return dict(us=per_op(kernel, 8, 64, 100),
                long_us=per_op(kernel, 512, 2048, 10),
                plain_us=per_op(plain, 8, 64, 3))


def _rate(elems: int, us: float) -> str:
    rate = f"{elems / us / 1e3:9.1f}" if us > 0 else "      n/a"
    return f"{us:8.4f} us/op {rate} Gelem/s"


def main() -> int:
    if not tools.have_card("vpu_probe"):
        return 1
    elems = SHAPE[0] * SHAPE[1]
    for dtype in DTYPES:
        x = tile(dtype).to(torch.device("cuda", 0))
        for op in OPS:
            r = rates(x, op)
            print(f"{dtype:9s} {op} kernel: {_rate(elems, r['us'])}  "
                  f"(n 512->2048: {_rate(elems, r['long_us'])})", flush=True)
            print(f"{dtype:9s} {op} plain : {_rate(elems, r['plain_us'])}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
