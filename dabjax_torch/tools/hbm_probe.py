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

    python -m dabjax_torch.tools.hbm_probe
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda

__all__ = ["SHAPE", "ODD_STARTS", "ENTRIES", "input_block", "odd_block",
           "scale_copy_cuda", "scale_copy_torch", "decision_plane_cuda",
           "decision_plane_torch", "main"]

#: the soft-input block of the TPU probe: [steps, 16, lanes] float32
SHAPE = (1160, 16, 4480)
#: rows of the decision plane per step, and the steps that share a value
PLANE_ROWS, PLANE_BLOCK = 64, 8
#: block-start values outside int8, where a wrapping cast and XLA's
#: saturating one differ (XLA: 127, -128, 127, -128, 0, 127, -128, 0)
ODD_STARTS = (300.0, -200.5, float("inf"), float("-inf"), float("nan"),
              127.9, -128.9, -0.7)

_vp, _i = ctypes.c_void_p, ctypes.c_int
#: the C entries launched here: their arguments' ctypes types before the
#: stream (``_build.launch``, which counts them as "scale_copy" and
#: "decision_plane")
ENTRIES = {"dabjax_probe_scale_copy": (_vp, _vp, ctypes.c_longlong),
           "dabjax_probe_decision_plane": (_vp, _vp, _i, _i, _i, _i)}


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
    _require(x, "scale_copy_cuda")
    if x.numel() % 4:
        raise ValueError(f"scale_copy_cuda: {x.numel()} elements, not a "
                         "multiple of 4")
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("scale_copy", ENTRIES, "dabjax_probe_scale_copy",
                      x.device, x.data_ptr(), out.data_ptr(), x.numel() // 4)
    return out


def scale_copy_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scale_copy_cuda` (a float32 product)."""
    return x * 1.000001


def decision_plane_cuda(x: torch.Tensor) -> torch.Tensor:
    """The plane kernel: float32 [T, R, L] -> int8 [T, PLANE_ROWS, L]
    whose row t is the saturated int8 of x[8 * (t // 8), 0, 0] everywhere
    (8 = PLANE_BLOCK)."""
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
        _build.launch("decision_plane", ENTRIES,
                      "dabjax_probe_decision_plane", x.device, x.data_ptr(),
                      out.data_ptr(), T, R * L, rows * L // 16, block)
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


def main(argv=()) -> int:
    if list(argv):
        print("usage: python -m dabjax_torch.tools.hbm_probe",
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
