"""Issue cost of a loop of small-K matrix products, on the card (the port
of ``tools/vit_dotshapes.py``).

The Viterbi branch metric is a [256, K] @ [K, lanes] product a trellis
step (256 = 4 branches x 64 states, K = 8 or 16 soft values, 80 for a
block-diagonal variant).  The TPU probe timed a loop of STEPS such
products over a state kept on-chip, in three modes, and one batched
product:

* ``dot``: pm += (S @ X[t])[:64].  The kernel keeps all 256 rows live as
  a [256, LB] float32 running sum and returns it whole (a compiler drops
  rows no one reads); its rows ``:64`` are the TPU's pm;
* ``repeat_add``: m = repeat(pm, 4, rows) + X[t, 0]; pm = m[:64] +
  m[64:128] (no product: the add and the row shuffle alone);
* ``dot_acs``: m = repeat(pm, 4, rows) + S @ X[t]; a = max(m[0:64],
  m[128:192]); b = max(m[64:128], m[192:256]); pm = where(b > a, b, a)
  (ties keep a); returns pm [64, LB];
* batched: one [256, K] @ [K, STEPS * LB] product, float32 out, returned
  whole.

:func:`dot_steps_cuda` and :func:`dot_batched_cuda` run the kernels
(``csrc/dots.cu``: f32 on the CUDA cores as FFMA, bf16 on the tensor
cores with f32 accumulation through ``wgmma``, X brought by TMA: in the
step loop many steps ahead of the products through a ring in shared
memory, in the batched product tile by tile, its output drained by TMA);
:func:`dot_steps_torch` and :func:`dot_batched_torch` are their plain
versions.  Inputs are the TPU probe's: ``default_rng(0)``, S then X,
standard normal (float32, then the dtype).  :func:`sass_counts` counts
the FFMA instructions of each f32 step, the HGMMA of one ring stage of
the bf16 step loop and of one tile of the batched bf16 product, in the
built library.  :func:`step_tiles` is the f32 step kernel's map of
threads to the rows and columns they own, :func:`bf16_step_strips` the
bf16 step kernel's columns by block.

``main()`` prints, for LB 4480 and 512, the TPU probe's cases: us per
step from the slope between two step counts (8 and 32 at LB 4480, 32 and
256 at LB 512), TF/s, and the fixed us per call, for the kernel and the
plain version, the kernel line adding the slope between 32 and 256 steps
(256 and 2048 at LB 512), the device's time; then the batched product
at K 16, LB 4480, 32 steps, in f32 and bf16, us per step of the one call
(the TPU script defines ``probe_batched`` but its ``main()`` does not
run it).

    python -m dabjax_torch.tools.vit_dotshapes
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.tools import vpu_probe

__all__ = ["MODES", "DTYPES", "KS", "CASES", "LBS", "F32_TIMED",
           "BATCHED_CASES", "ROWS", "STEP_WARPS", "WIDE_COLS",
           "BF16_STAGE_STEPS", "BF16_UNITS", "STEPS_PAST_L2", "DOT_TOL",
           "steps_for",
           "steps_long", "probe_inputs", "batched_inputs", "step_cols",
           "step_tiles", "bf16_step_strips",
           "dot_steps_cuda", "dot_steps_torch", "dot_batched_cuda",
           "dot_batched_torch", "probe", "probe_batched", "probe2",
           "sass_counts", "ENTRIES", "main"]

#: the probe's modes, in the kernel's code order
MODES = ("dot", "repeat_add", "dot_acs")
#: the dtypes of S and X, in the kernel's code order
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the contraction depths the f32 kernel is built for (bf16: 16)
KS = (8, 16, 80)
#: rows of S: 4 branches x 64 states
ROWS = 256
#: the TPU probe's cases (main()): name, K, mode, dtype
CASES = (("loop dot f32", 16, "dot", "float32"),
         ("loop dot f32 K=8", 8, "dot", "float32"),
         ("loop dot bf16", 16, "dot", "bfloat16"),
         ("loop dot f32 K=80", 80, "dot", "float32"),
         ("repeat_add only", 16, "repeat_add", "float32"),
         ("loop dot+acs f32", 16, "dot_acs", "float32"))
#: the TPU probe's lane counts
LBS = (4480, 512)
#: the f32 step kernel's timed cases (``chip_smoke.py`` phase 10): name,
#: K, mode, LB; the first is the gated one
F32_TIMED = (("dot K=16", 16, "dot", 4480), ("dot K=8", 8, "dot", 4480),
             ("dot K=80", 80, "dot", 4480),
             ("repeat_add", 16, "repeat_add", 4480),
             ("dot_acs K=16", 16, "dot_acs", 4480),
             ("dot K=16", 16, "dot", 512))
#: the batched product's cases (main(): K 16, LB 4480, 32 steps)
BATCHED_CASES = (("batched dot f32", "float32"),
                 ("batched dot bf16", "bfloat16"))
#: the f32 step kernel's warps a block (one a scheduler) and its columns
#: a warp above 4 warps an SM (``csrc/dots.cu``: kStepWarps, kWideCols)
STEP_WARPS = 4
WIDE_COLS = 9
#: the bf16 step kernel's steps of X a ring stage and its most 8-column
#: units a block (``csrc/dots.cu``: kD2Steps, kD2Units)
BF16_STAGE_STEPS = 8
BF16_UNITS = 5
#: the bf16 step loop's step counts past the L2 (50 MB) at LB 4480: X of
#: 73 and 294 MB, read from device memory by every call
STEPS_PAST_L2 = (512, 2048)
#: the kernels' tolerance on the TPU probe's standard-normal inputs,
#: |kernel - plain| over max |plain|: float32 sums of the same products in
#: another order (FMA chains or tensor-core sums on the card, blocked
#: products in torch)
DOT_TOL = 1e-5
_vp, _i = ctypes.c_void_p, ctypes.c_int
#: the C entries launched here: their arguments' ctypes types before the
#: stream (``_build.launch``, which counts the step loops as "dot_steps"
#: (f32, D1) and "dot_steps_bf16" (D2), the batched products as
#: "dot_batched" (f32, D3) and "dot_batched_bf16" (D4))
ENTRIES = {"dabjax_probe_dot_steps": (_vp, _vp, _vp, _i, _i, _i, _i, _i),
           "dabjax_probe_dot_batched": (_vp, _vp, _vp, _i, _i,
                                        ctypes.c_longlong)}


def steps_for(lb: int) -> tuple[int, int]:
    """The two step counts the per-step slope is taken between (the TPU
    probe's)."""
    return (8, 32) if lb > 2048 else (32, 256)


def steps_long(lb: int) -> tuple[int, int]:
    """A longer pair, whose slope is the device's per-step time: at the
    TPU probe's, a cheap call takes less than the host's time to issue
    it, and the slope reads the host."""
    return (32, 256) if lb > 2048 else (256, 2048)


def probe_inputs(k: int, lb: int, steps: int, dtype: str = "float32",
                 seed: int = 0):
    """(S [256, k], X [steps, k, lb]): standard normal from
    ``default_rng(seed)``, S drawn first, as float32 then ``dtype``."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.standard_normal((ROWS, k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((steps, k, lb))
                         .astype(np.float32))
    return s.to(DTYPES[dtype]), x.to(DTYPES[dtype])


def batched_inputs(k: int, lb: int, steps: int, dtype: str = "float32",
                   seed: int = 0):
    """(S [256, k], X [k, steps * lb]) as :func:`probe_inputs` draws
    them for ``probe_batched``."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.standard_normal((ROWS, k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((k, steps * lb))
                         .astype(np.float32))
    return s.to(DTYPES[dtype]), x.to(DTYPES[dtype])


def step_cols(lb: int, sms: int = 132) -> int:
    """Columns a warp of the f32 step kernel owns: one while LB columns
    fill at most one warp a scheduler (LB up to 4 x ``sms``), else
    :data:`WIDE_COLS`."""
    return 1 if lb <= STEP_WARPS * sms else WIDE_COLS


def step_tiles(lb: int, mode: str = "dot", sms: int = 132):
    """The f32 step kernel's map, thread by thread: yields (block, warp,
    lane, rows, columns) of the output each thread stores, as
    ``csrc/dots.cu`` computes them.  Warp w of block b owns columns
    (4b + w) kC + c, c < kC (those below LB); in ``dot`` lane (j, h) =
    (lane & 15, lane >> 4) holds the running sums of rows e*64 + 4j + q,
    e in {h, h + 2}, q < 4 (the four rows e*64 + 4j + q of one state row
    4j + q sit in lanes (j, 0) and (j, 1)); the state [64, LB] of
    ``repeat_add`` and ``dot_acs`` is stored from the warp's shared copy,
    rows lane and lane + 32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    kc = step_cols(lb, sms)
    warps = -(-lb // kc)
    for gw in range(warps):
        cols = [gw * kc + c for c in range(kc) if gw * kc + c < lb]
        for lane in range(32):
            j, h = lane & 15, lane >> 4
            if mode == "dot":
                rows = [(h + 2 * ei) * 64 + 4 * j + q for ei in range(2)
                        for q in range(4)]
            else:
                rows = [lane, lane + 32]
            yield gw // STEP_WARPS, gw % STEP_WARPS, lane, rows, cols


def bf16_step_strips(lb: int, sms: int = 132) -> list:
    """The bf16 step kernel's columns, block by block: [(first column,
    columns)], as ``csrc/dots.cu`` computes them.  Columns go in 8-column
    units: blocks of 4 units while there are SMs for them, else one block
    an SM (4 or 5 units each: 132 blocks of 32 or 40 columns at LB 4480),
    never more than :data:`BF16_UNITS`; block b owns units b * units //
    blocks up to (b + 1) * units // blocks."""
    units = lb // 8
    blocks = max(min(sms, -(-units // 4)), -(-units // BF16_UNITS))
    starts = [b * units // blocks for b in range(blocks + 1)]
    return [(8 * u0, 8 * (u1 - u0)) for u0, u1 in zip(starts, starts[1:])]


def _dtype(s: torch.Tensor, x: torch.Tensor, name: str) -> str:
    for key, dt in DTYPES.items():
        if s.dtype == dt and x.dtype == dt:
            return key
    raise ValueError(f"{name}: S and X must both be one of {tuple(DTYPES)},"
                     f" got {s.dtype} and {x.dtype}")


def _steps_out(s: torch.Tensor, x: torch.Tensor, mode: str) -> tuple:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if s.dim() != 2 or s.shape[0] != ROWS or x.dim() != 3 \
            or x.shape[1] != s.shape[1]:
        raise ValueError(f"need S [256, K] and X [steps, K, LB], got "
                         f"{tuple(s.shape)} and {tuple(x.shape)}")
    return (ROWS if mode == "dot" else 64, x.shape[2])


def dot_steps_cuda(s: torch.Tensor, x: torch.Tensor,
                   mode: str = "dot") -> torch.Tensor:
    """The kernel: X.shape[0] steps of ``mode`` (see the module) from a
    zero state -> float32 [256, LB] (dot) or [64, LB]."""
    dtype = _dtype(s, x, "dot_steps_cuda")
    shape = _steps_out(s, x, mode)
    steps, k, lb = x.shape
    for t, name in ((s, "S"), (x, "X")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"dot_steps_cuda: {name} must be a contiguous "
                             f"CUDA tensor, got {t.device}")
    if lb % 16 or (dtype == "float32" and k not in KS) or (
            dtype == "bfloat16" and (k != 16 or mode != "dot")):
        raise ValueError(f"dot_steps_cuda: built for LB a multiple of 16, "
                         f"f32 K in {KS}, bf16 K 16 in mode dot; got LB "
                         f"{lb}, K {k}, {dtype} {mode}")
    if dtype == "bfloat16" and x.data_ptr() % 16:
        raise ValueError("dot_steps_cuda: bf16 X must be 16-byte aligned "
                         "(its TMA tensor map)")
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    _build.launch("dot_steps" if dtype == "float32" else "dot_steps_bf16",
                  ENTRIES, "dabjax_probe_dot_steps", x.device, s.data_ptr(),
                  x.data_ptr(), out.data_ptr(), MODES.index(mode),
                  list(DTYPES).index(dtype), k, steps, lb)
    return out


def dot_steps_torch(s: torch.Tensor, x: torch.Tensor,
                    mode: str = "dot") -> torch.Tensor:
    """Plain version of :func:`dot_steps_cuda`: the TPU probe's ops a
    step, in float32 (bf16 inputs are widened exactly)."""
    _steps_out(s, x, mode)
    sf, xf = s.float(), x.float()
    if mode == "dot":
        acc = torch.zeros((ROWS, x.shape[2]), dtype=torch.float32,
                          device=x.device)
        for t in range(x.shape[0]):
            acc = acc + sf @ xf[t]
        return acc
    pm = torch.zeros((64, x.shape[2]), dtype=torch.float32, device=x.device)
    for t in range(x.shape[0]):
        if mode == "repeat_add":
            m = pm.repeat_interleave(4, dim=0) + xf[t, :1]
            pm = m[:64] + m[64:128]
            continue
        m = pm.repeat_interleave(4, dim=0) + sf @ xf[t]
        a = torch.maximum(m[0:64], m[128:192])
        b = torch.maximum(m[64:128], m[192:256])
        pm = torch.where(b > a, b, a)
    return pm


def dot_batched_cuda(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel: S [256, K] @ X [K, N] -> float32 [256, N] (f32 K 8 or
    16, bf16 K 16; N a multiple of 8)."""
    dtype = _dtype(s, x, "dot_batched_cuda")
    if s.dim() != 2 or s.shape[0] != ROWS or x.dim() != 2 \
            or x.shape[0] != s.shape[1]:
        raise ValueError(f"dot_batched_cuda: need S [256, K] and X [K, N], "
                         f"got {tuple(s.shape)} and {tuple(x.shape)}")
    for t, name in ((s, "S"), (x, "X")):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"dot_batched_cuda: {name} must be a "
                             f"contiguous CUDA tensor, got {t.device}")
    k, n = x.shape
    if n % 8 or k not in ((8, 16) if dtype == "float32" else (16,)):
        raise ValueError(f"dot_batched_cuda: built for N a multiple of 8, "
                         f"f32 K 8 or 16, bf16 K 16; got N {n}, K {k}, "
                         f"{dtype}")
    if dtype == "bfloat16" and x.data_ptr() % 16:
        raise ValueError("dot_batched_cuda: bf16 X must be 16-byte aligned "
                         "(its TMA tensor map)")
    out = torch.empty((ROWS, n), dtype=torch.float32, device=x.device)
    _build.launch("dot_batched" if dtype == "float32"
                  else "dot_batched_bf16", ENTRIES,
                  "dabjax_probe_dot_batched", x.device, s.data_ptr(),
                  x.data_ptr(), out.data_ptr(), list(DTYPES).index(dtype),
                  k, n)
    return out


def dot_batched_torch(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dot_batched_cuda` (float32 product)."""
    return s.float() @ x.float()


@functools.lru_cache(maxsize=4)
def _device_inputs(k: int, lb: int, steps: int, dtype: str):
    """:func:`probe_inputs` on the first card (the two step counts of a
    case, reused by the kernel and the plain version)."""
    return tuple(t.to(torch.device("cuda", 0))
                 for t in probe_inputs(k, lb, steps, dtype))


def probe(name: str, k: int, lb: int, steps: int, mode: str = "dot",
          dtype: str = "float32", impl: str = "kernel",
          reps: int = 20) -> float:
    """ms of one call of ``steps`` steps on the TPU probe's inputs, on the
    first card: the kernel's device time, or the plain version's (``impl``)
    by events alone (its two launches a step, ``reps`` calls over, would
    fill the launch queue behind a device sleep; it is host-bound)."""
    s, x = _device_inputs(k, lb, steps, dtype)
    if impl == "kernel":
        return tools.device_ms(lambda: dot_steps_cuda(s, x, mode), reps)
    return tools.cuda_ms(lambda: dot_steps_torch(s, x, mode), reps)


def probe_batched(name: str, k: int, lb: int, steps: int,
                  dtype: str = "float32", impl: str = "kernel",
                  reps: int = 10) -> float:
    """us per step of the one batched product over ``steps`` steps;
    prints the line."""
    s, x = (t.to(torch.device("cuda", 0))
            for t in batched_inputs(k, lb, steps, dtype))
    fn = dot_batched_cuda if impl == "kernel" else dot_batched_torch
    per = tools.device_ms(lambda: fn(s, x), reps) * 1e3 / steps
    print(f"{name:28s} K={k:3d} LB={lb:5d} {impl:6s}: {per:7.3f} us/step "
          f"{_tflops(k, lb, 'dot', per):6.1f} TF/s", flush=True)
    return per


def _tflops(k: int, lb: int, mode: str, per_us: float) -> float:
    return (ROWS * k * lb * 2 / per_us / 1e6
            if mode != "repeat_add" and per_us > 0 else 0.0)


def probe2(name: str, k: int, lb: int, mode: str = "dot",
           dtype: str = "float32") -> dict:
    """us per step from the slope between the two step counts, TF/s, and
    the fixed us per call, kernel and plain; the kernel's also between
    :func:`steps_long`; prints a line of each."""
    out = {}
    for impl, reps in (("kernel", 20), ("plain", 3)):
        s1, s2 = steps_for(lb)
        t1 = probe(name, k, lb, s1, mode, dtype, impl, reps)
        t2 = probe(name, k, lb, s2, mode, dtype, impl, reps)
        per = (t2 - t1) / (s2 - s1) * 1e3
        fixed = t1 * 1e3 - per * s1
        line = (f"{name:28s} K={k:3d} LB={lb:5d} {impl:6s}: {per:7.3f} "
                f"us/step {_tflops(k, lb, mode, per):6.1f} TF/s  (fixed "
                f"{fixed:6.1f} us/call)")
        out[impl] = dict(us=per, fixed_us=fixed)
        if impl == "kernel":
            l1, l2 = steps_long(lb)
            t1, t2 = (probe(name, k, lb, n, mode, dtype, impl, 10)
                      for n in (l1, l2))
            long_us = (t2 - t1) / (l2 - l1) * 1e3
            line += (f"  (steps {l1}->{l2}: {long_us:7.3f} us/step "
                     f"{_tflops(k, lb, mode, long_us):6.1f} TF/s)")
            out[impl]["long_us"] = long_us
        print(line, flush=True)
    return out


def sass_counts() -> dict:
    """{case: instructions of one step} in the built library: FFMA and
    FMUL of the f32 step kernel per mode and K (FADD for repeat_add), in
    its :data:`WIDE_COLS` build (a thread's step: 8 rows x 9 columns x K
    FFMA); "dot bf16 K=16": the HGMMA (wgmma) of the bf16 step kernel, one
    ring stage of each of its two paths (m64n40k16 for a strip of 5
    units, m64n32k16 for fewer: 2 x :data:`BF16_STAGE_STEPS` steps x 4
    slabs); and "batched bf16 K=16": the HGMMA of the batched bf16
    product, one a 64-row slab of a tile.  The step, stage and tile loops
    are not unrolled, so a kernel's count is one step's, stage's or
    tile's (0 would mean the work was folded away, or that a bf16 product
    does not run on wgmma)."""
    wide = rf"dot_steps_f32ILi(\d+)ELi(\d+)ELi{WIDE_COLS}E"
    f32 = vpu_probe._sass_lengths(wide, ops=("FFMA", "FMUL"))
    adds = vpu_probe._sass_lengths(wide, ops=("FADD",))
    out = {f"{mode} f32 K={k}": f32.get((MODES.index(mode), k), 0)
           for mode in ("dot", "dot_acs") for k in KS}
    out["repeat_add f32"] = adds.get((MODES.index("repeat_add"), 1), 0)
    for case, kernel in (("dot bf16 K=16", "dot_steps_bf16"),
                         ("batched bf16 K=16", "dot_batched_bf16")):
        out[case] = vpu_probe._sass_lengths(rf"{kernel}E",
                                            ops=("HGMMA",)).get((), 0)
    return out


def main() -> int:
    if not tools.have_card("vit_dotshapes"):
        return 1
    for lb in LBS:
        for name, k, mode, dtype in CASES:
            probe2(name, k, lb, mode, dtype)
        print(flush=True)
    _device_inputs.cache_clear()
    for name, dtype in BATCHED_CASES:
        for impl in ("kernel", "plain"):
            probe_batched(name, 16, 4480, 32, dtype, impl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
