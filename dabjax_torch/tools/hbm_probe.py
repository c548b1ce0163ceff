"""Copy and decision-plane store bandwidth of device memory, on the card
(the port of ``tools/hbm_probe.py``).

* torch mul: ``x * 1.000001`` over float32 [1160, 16, 4480] (333 MB), the
  probe's own "xla mul" line, and the plain version of the copy kernel;
* copy kernel: :func:`scale_copy_cuda`, the same product by a streaming
  kernel (``csrc/probes.cu``), in place of the probe's ``copy_kernel``;
* decision plane: :func:`decision_plane_cuda`, int8 [1160, 64, 4480]
  (333 MB) where row t holds int8(x[8 * (t // 8), 0, 0]), in place of the
  probe's ``dec_kernel``; :func:`decision_plane_torch` is its plain
  version (an index and an expand).

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

import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda

__all__ = ["SHAPE", "input_block", "scale_copy_cuda", "scale_copy_torch",
           "decision_plane_cuda", "decision_plane_torch", "reset_launches",
           "main"]

#: the soft-input block of the TPU probe: [steps, 16, lanes] float32
SHAPE = (1160, 16, 4480)
#: rows of the decision plane per step, and the steps that share a value
PLANE_ROWS, PLANE_BLOCK = 64, 8

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
    whose row t is int8(x[8 * (t // 8), 0, 0]) everywhere (8 =
    PLANE_BLOCK)."""
    global PLANE_LAUNCHES
    _require(x, "decision_plane_cuda")
    T, R, L = x.shape
    rows, block = PLANE_ROWS, PLANE_BLOCK
    if T % block or T > 65535 or R == 0 or (rows * L) % 16:
        raise ValueError(f"decision_plane_cuda: bad shape {tuple(x.shape)}:"
                         f" need T a multiple of {block} up to 65535 and "
                         f"{rows} * L a multiple of 16")
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


def decision_plane_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decision_plane_cuda`."""
    T, _, L = x.shape
    first = torch.arange(T, device=x.device) // PLANE_BLOCK * PLANE_BLOCK
    v = x[first, 0, 0].to(torch.int8)
    return v[:, None, None].expand(T, PLANE_ROWS, L).contiguous()


def main() -> int:
    if not tools.have_card("hbm_probe"):
        return 1
    x = input_block().to(torch.device("cuda", 0))
    n = x.numel()
    T, _, L = x.shape
    plane = T * PLANE_ROWS * L
    cases = (
        (f"torch mul f32 {n / 1e6:.0f}M elems", scale_copy_torch, 8 * n),
        (f"copy kernel f32 {n / 1e6:.0f}M elems", scale_copy_cuda, 8 * n),
        (f"torch plane int8 [{T}, {PLANE_ROWS}, {L}]", decision_plane_torch,
         plane),
        (f"plane kernel int8 [{T}, {PLANE_ROWS}, {L}]", decision_plane_cuda,
         plane))
    for name, fn, nbytes in cases:
        ms = tools.cuda_ms(lambda: fn(x), 10)
        print(f"{name}: {ms:8.3f} ms  {nbytes / ms / 1e6:7.1f} GB/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
