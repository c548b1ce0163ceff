"""Copy and decision-plane store bandwidth of device memory, on the card
(the port of ``tools/hbm_probe.py``).

* torch mul: ``x * 1.000001`` over float32 [1160, 16, 4480] (333 MB), the
  probe's own "xla mul" line, and the plain version of the copy kernel;
* copy kernel: :func:`scale_copy_cuda`, the same product by a streaming
  kernel (``csrc/probes.cu``), in place of the probe's ``copy_kernel``;
* decision plane: :func:`decision_plane_cuda`, int8 [1160, 64, 4480]
  (333 MB) where row t holds int8(x[8 * (t // 8), 0, 0]), in place of the
  probe's ``dec_kernel``; :func:`decision_plane_torch` is its plain
  version (an index and an expand).  The cast is XLA's ``astype(int8)``:
  truncated toward zero and saturated to [-128, 127], NaN to 0 (300 ->
  127, -inf -> -128, -0.7 -> 0);
* fill: one ``fill_`` of the same plane with the int of x[0, 0, 0], read
  to the host once beforehand, the plane kernel's yardstick (on an input
  whose 8-step blocks all start with that value it writes the kernel's
  output).

Each line is the mean of 10 calls by CUDA events (``tools.cuda_ms``).
GB/s counts the bytes the Hopper kernel moves: 8 per element for the
product (read and write), 1 per element stored for the plane (its reads
are one float per 4 KB of stores, from cache).  The TPU probe's GB/s
divided a larger ``tot``: it added the harness's own copy of the input
and the block DMA of an input the plane kernel mostly ignores, so its
figures do not compare with these.  Its (C, LB) block-shape sweep is a
TPU tiling and has no counterpart here.

With ``--variants`` it times the plane kernel (through its wrapper)
instead, beside ``fill_`` and ``earlier``, the kernel with the plain
16-byte store it had before its redesign in place of ``st.global.cs``,
built from ``csrc/probes.cu`` by text replacement (:data:`VARIANTS`) and
checked bit for bit against the kernel first: in turns, 9 runs of 10
calls by events and 9 by device time (``tools.device_ms``: behind a
device sleep, so the host's issue of the first call, longer through the
wrapper than for ``fill_``, is left out).  Then 30 readings of the
kernel by events, each beside the host's time to issue its 10 calls,
the GC passes and the device mallocs meanwhile, and each followed by one
by device time, say whether a slow reading by events is the host's.

    python -m dabjax_torch.tools.hbm_probe [--variants]
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda

__all__ = ["SHAPE", "ODD_STARTS", "input_block", "odd_block",
           "scale_copy_cuda", "scale_copy_torch", "decision_plane_cuda",
           "decision_plane_torch", "VARIANTS", "reset_launches", "main"]

#: the soft-input block of the TPU probe: [steps, 16, lanes] float32
SHAPE = (1160, 16, 4480)
#: rows of the decision plane per step, and the steps that share a value
PLANE_ROWS, PLANE_BLOCK = 64, 8
#: block-start values outside int8, where a wrapping cast and XLA's
#: saturating one differ (XLA: 127, -128, 127, -128, 0, 127, -128, 0)
ODD_STARTS = (300.0, -200.5, float("inf"), float("-inf"), float("nan"),
              127.9, -128.9, -0.7)

#: launches of the copy kernel since the last reset
COPY_LAUNCHES = 0
#: launches of the decision-plane kernel since the last reset
PLANE_LAUNCHES = 0


def reset_launches() -> None:
    global COPY_LAUNCHES, PLANE_LAUNCHES
    COPY_LAUNCHES = 0
    PLANE_LAUNCHES = 0


def input_block(shape=SHAPE, seed: int = 0) -> torch.Tensor:
    """Integer values in [-127, 127] as float32 ``shape``, from ``seed``
    (integers, so the plane's float -> int8 cast is defined)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-127, 128, size=shape, dtype=np.int8)
    return torch.from_numpy(v).to(torch.float32)


def odd_block(shape=SHAPE, seed: int = 8) -> torch.Tensor:
    """:func:`input_block` with its 8-step blocks starting, in turn, with
    the values of :data:`ODD_STARTS`."""
    x = input_block(shape, seed)
    starts = x[::PLANE_BLOCK, 0, 0]
    n = starts.numel()
    starts.copy_(torch.tensor(ODD_STARTS * (n // len(ODD_STARTS) + 1))[:n])
    return x


def _require(x: torch.Tensor, name: str) -> None:
    viterbi_cuda._require(x, torch.float32, 3, name)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: input not 16-byte aligned")


def scale_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """The copy kernel: float32 [T, R, L] -> x * 1.000001f, same shape
    (a multiple of 4 elements)."""
    global COPY_LAUNCHES
    _require(x, "scale_copy_cuda")
    if x.numel() % 4:
        raise ValueError(f"scale_copy_cuda: {x.numel()} elements, not a "
                         "multiple of 4")
    out = torch.empty_like(x)
    if x.numel():
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.dabjax_probe_scale_copy(x.data_ptr(), out.data_ptr(),
                                             x.numel() // 4, stream)
            COPY_LAUNCHES += 1
        viterbi_cuda._check(rc, "scale_copy_cuda")
    return out


def scale_copy_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scale_copy_cuda` (a float32 product)."""
    return x * 1.000001


def decision_plane_cuda(x: torch.Tensor) -> torch.Tensor:
    """The plane kernel: float32 [T, R, L] -> int8 [T, PLANE_ROWS, L]
    whose row t is the saturated int8 of x[8 * (t // 8), 0, 0] everywhere
    (8 = PLANE_BLOCK)."""
    global PLANE_LAUNCHES
    rows, block = PLANE_ROWS, PLANE_BLOCK
    if x.dim() == 3:
        T, R, L = x.shape
        if T % block or T > 65535 or R == 0 or (rows * L) % 16:
            raise ValueError(f"decision_plane_cuda: bad shape "
                             f"{tuple(x.shape)}: need T a multiple of "
                             f"{block} up to 65535, R > 0 and {rows} * L a "
                             "multiple of 16")
    _require(x, "decision_plane_cuda")
    T, R, L = x.shape
    out = torch.empty((T, rows, L), dtype=torch.int8, device=x.device)
    if out.numel():
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.dabjax_probe_decision_plane(
                x.data_ptr(), out.data_ptr(), T, R * L, rows * L // 16,
                block, stream)
            PLANE_LAUNCHES += 1
        viterbi_cuda._check(rc, "decision_plane_cuda")
    return out


def _saturate(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int8 as XLA casts: truncated, saturated, NaN to 0."""
    return torch.nan_to_num(v, nan=0.0).trunc().clamp(-128, 127).to(
        torch.int8)


def decision_plane_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decision_plane_cuda`."""
    T, _, L = x.shape
    first = torch.arange(T, device=x.device) // PLANE_BLOCK * PLANE_BLOCK
    v = _saturate(x[first, 0, 0])
    return v[:, None, None].expand(T, PLANE_ROWS, L).contiguous()


#: name -> [(text, replacement)] applied to probes.cu: ``earlier``, the
#: kernel's plain store before its redesign
VARIANTS = {"earlier": [(
    "  __stcs(out + static_cast<size_t>(t) * row16 + i, "
    "make_int4(w, w, w, w));",
    "  out[static_cast<size_t>(t) * row16 + i] = make_int4(w, w, w, w);")]}


def _variants(x: torch.Tensor, plane: torch.Tensor, iv: int) -> None:
    """--variants: each variant built and checked bit for bit against the
    kernel on ``x`` and :func:`odd_block`, then all timed in turns; then
    the kernel's readings by events beside the host's issue."""
    from dabjax_torch.tools.plane_variants import build_variant
    from dabjax_torch.tools.word_variants import variant_source
    src = (_build.CSRC / "probes.cu").read_text()
    jobs = {name: build_variant(f"store_{name}", variant_source(src, edits))
            for name, edits in VARIANTS.items()}
    fns = {"kernel": lambda: decision_plane_cuda(x),
           "fill": lambda: plane.fill_(iv)}
    stream = torch.cuda.current_stream().cuda_stream
    odd = odd_block().to(x.device)
    T, R, L = x.shape
    for name, job in jobs.items():
        _, err = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc store_{name} failed:\n{err[:3000]}")
        lib = ctypes.CDLL(str(_build.BUILD / "variants"
                              / f"plane_store_{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dabjax_probe_decision_plane.argtypes = [vp, vp] + [i] * 4 + [vp]

        def run(a, lib=lib, name=name):
            out = torch.empty((T, PLANE_ROWS, L), dtype=torch.int8,
                              device=a.device)
            rc = lib.dabjax_probe_decision_plane(
                a.data_ptr(), out.data_ptr(), T, R * L,
                PLANE_ROWS * L // 16, PLANE_BLOCK, stream)
            viterbi_cuda._check(rc, f"variant {name}")
            return out
        for a in (x, odd):
            if not torch.equal(run(a), decision_plane_cuda(a)):
                raise AssertionError(f"plane variant {name} differs from "
                                     "the kernel")
        fns[name] = lambda run=run: run(x)
    for timer, label in ((tools.cuda_ms, "events"),
                         (tools.device_ms, "device time")):
        spread = tools.interleaved_ms(fns, 9, 10, timer)
        fill = spread["fill"]["median"]
        for name, v in spread.items():
            print(f"plane {name} by {label}: {v['median']:.5f} ms "
                  f"({v['min']:.5f}-{v['max']:.5f}, median of 9 runs of 10 "
                  f"in turns), {v['median'] / fill:.4f}x fill", flush=True)
    readings, device = [], []
    for _ in range(30):
        host = {}
        readings.append((tools.cuda_ms(fns["kernel"], 10, host), host))
        device.append(tools.device_ms(fns["kernel"], 10))
    ms = [r for r, _ in readings]
    issue = [h["issue_ms"] for _, h in readings]
    mid = statistics.median(ms)
    slow = [(r, h) for r, h in readings if r > 1.1 * mid]
    print(f"plane kernel, 30 readings of 10 calls, each by events then by "
          f"device time: events median {mid:.5f} ms, max {max(ms):.5f}; "
          f"device time median {statistics.median(device):.5f}, max "
          f"{max(device):.5f}; the host's issue of the 10 calls median "
          f"{statistics.median(issue):.3f} ms, its correlation with the "
          f"events reading {statistics.correlation(issue, ms):.3f}; "
          f"{len(slow)} events readings above 1.1x the median"
          + "".join(f"; {r:.5f} ms: issue {h['issue_ms']:.3f} ms, "
                    f"{h['gc']} GC passes, {h['mallocs']} device mallocs"
                    for r, h in slow), flush=True)


def main(argv=()) -> int:
    argv = list(argv)
    if argv not in ([], ["--variants"]):
        print("usage: python -m dabjax_torch.tools.hbm_probe [--variants]",
              file=sys.stderr)
        return 2
    if not tools.have_card("hbm_probe"):
        return 1
    x = input_block().to(torch.device("cuda", 0))
    n = x.numel()
    T, _, L = x.shape
    plane = torch.empty((T, PLANE_ROWS, L), dtype=torch.int8,
                        device=x.device)
    iv = int(_saturate(x[0, 0, 0]))      # read to the host once
    if argv:
        _variants(x, plane, iv)
        return 0
    nplane = plane.numel()
    cases = (
        (f"torch mul f32 {n / 1e6:.0f}M elems", scale_copy_torch, 8 * n),
        (f"copy kernel f32 {n / 1e6:.0f}M elems", scale_copy_cuda, 8 * n),
        (f"torch plane int8 [{T}, {PLANE_ROWS}, {L}]", decision_plane_torch,
         nplane),
        (f"plane kernel int8 [{T}, {PLANE_ROWS}, {L}]", decision_plane_cuda,
         nplane),
        (f"fill_ int8 [{T}, {PLANE_ROWS}, {L}]",
         lambda _: plane.fill_(iv), nplane))
    for name, fn, nbytes in cases:
        ms = tools.cuda_ms(lambda: fn(x), 10)
        print(f"{name}: {ms:8.3f} ms  {nbytes / ms / 1e6:7.1f} GB/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
