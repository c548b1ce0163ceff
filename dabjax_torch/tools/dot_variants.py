"""Variants of the small-K dot probes (D1 ``dot_steps_f32``, D2
``dot_steps_bf16``, D5 ``dots_chain`` in ``csrc/dots.cu``), each built
from the source by text replacement and timed against the kernel as it
is, in turns:

* ``earlier``: the designs D1, D2 and D5 had before their redesign (kept
  here as text, inserted beside the kernels and called by the same entry
  points): D1 and D5, a block of 128 threads owns 16 columns, a thread 16
  rows x 2 columns with S and X from shared memory (D1: X prefetched into
  registers and stored to a second buffer, one ``__syncthreads`` a step;
  D5: W and X by volatile shared loads every dot); D2, a block of 4 warps
  owns 16 columns, each warp 64 rows of S as ``mma.sync`` A fragments in
  registers, X read from device memory by 2-byte loads one step ahead,
  8 ``mma.sync.m16n8k16`` a warp a step;
* ``tile_earlier_grid``: the new tiles on the old grid (D1 ``kWideCols``,
  D5 ``kDotCols`` 4, D5's 4 columns run together: 16 columns a block of 4
  warps, 280 blocks at 4480 columns, 3 warps on the busiest schedulers
  against 2.12 on average), so ``earlier`` -> ``tile_earlier_grid`` is
  the tile's gain alone and ``tile_earlier_grid`` -> ``kernel`` (9
  columns a warp, 498 warps on the 528 schedulers) the balanced grid's;
* ``ring_3`` (D1): a ring of 3 steps of X a warp at 9 columns, in place
  of 2;
* ``k_unroll_16`` (D1): the depth loop unrolled 16 at a time, not whole
  (at K 80 the whole step is 5760 FFMA, about 92 KB of code);
* ``s_shared`` (D1): S read from shared memory at one column a warp too
  (LB 512), not held in registers;
* ``d5_one_warp_a_scheduler`` (D5): columns a warp set for one warp a
  scheduler at every shape (the [32, 8] shape, one row a lane, then runs
  9 columns a warp, not 2 with 8 warps a scheduler);
* ``d5_one_column`` (D5): one column's chain at a time at 8 rows a lane,
  not three together;
* ``strips_32`` (D2): blocks of at most 4 units, 32 columns (140 blocks at
  LB 4480, so 8 SMs take two), in place of 4 or 5 (132 blocks of 32 or
  40 columns);
* ``stage_16`` (D2): 16 steps a stage, not 8 (half the barrier waits and
  commit groups a step);
* ``mma_sync`` (D2): the other route, the same ring read by
  ``ldmatrix.trans`` into ``mma.sync.m16n8k16`` B fragments (a warp's 4
  row tiles x the strip's units a step) in place of ``wgmma``; a stage's
  buffer goes back to the producer as soon as it is read.

D1 and D5's variants must give the kernel's output bit for bit (the same
FMA chains from the running value in the same order); D2's bit for bit
on integer inputs and within ``vit_dotshapes.DOT_TOL`` on the TPU
probe's (the tensor cores may add a step's products in another order).
Times are device times (``tools.device_ms``), the median of 4 runs of 20
calls taken in turns, per step (D1, D2) or per dot (D5) from the slope
between two lengths: D1 in the cases ``vit_dotshapes.F32_TIMED``, D2 (K
16, bf16) at LB 4480 and 512, both between
:func:`vit_dotshapes.steps_long` step counts, and at LB 4480 past the L2
(``vit_dotshapes.STEPS_PAST_L2``, X of 73 and 294 MB), D5 at its three
shapes between 40 and 1000 dots.  Each variant is one ``nvcc`` of ``dots.cu``
alone into ``dabjax_torch/build/variants/``, all started together, and
is timed on the probes whose code it changes (:data:`PROBES`).

    python -m dabjax_torch.tools.dot_variants
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.tools import vit_dotshapes as vd
from dabjax_torch.tools import vpu_probe2

__all__ = ["VARIANTS", "PROBES", "variant_source", "main"]

#: the earlier designs of D1, D2 and D5, their launchers and their
#: constants (D2's: the mma.sync ``dot_steps_bf16`` before its ring)
_EARLIER = r"""
constexpr int kEarlierThreads = 128;   // 16 row groups x 8 column pairs
constexpr int kEarlierCols = 16;       // columns of a block
constexpr int kPmStride = 17;       // padded row of the shared state

// D1: STEPS steps of [256, K] @ [K, 16 columns] on the CUDA cores.
// s [256][K], x [steps][xk][lb] (xk = K except for repeat_add, which reads
// row 0 only), out dot: [256][lb], else [64][lb].
template <int kMode, int K>
__global__ void __launch_bounds__(kEarlierThreads)
dot_steps_earlier(const float* __restrict__ s, const float* __restrict__ x,
              float* __restrict__ out, int steps, int xk, int lb) {
  constexpr int kSRows = kMode == kRepeatAdd ? 0 : K;
  constexpr int kXRows = kMode == kRepeatAdd ? 1 : K;
  constexpr int kTile = kXRows * kEarlierCols;
  constexpr int kPf = (kTile + kEarlierThreads - 1) / kEarlierThreads;
  constexpr int kPm = kStates * kPmStride;
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // [kSRows][256]
  float* xs = st + kSRows * kRows;               // [2][kTile]
  float* pms = xs + 2 * kTile;                   // [2][64][kPmStride]
  const int tid = threadIdx.x;
  const int j = tid & 15;
  const int g = tid >> 4;
  const int c0 = blockIdx.x * kEarlierCols;
  const size_t step_stride = static_cast<size_t>(xk) * lb;

  for (int i = tid; i < kSRows * kRows; i += kEarlierThreads)
    st[(i % K) * kRows + i / K] = s[i];
  for (int i = tid; i < kTile; i += kEarlierThreads)
    xs[i] = x[(i / kEarlierCols) * static_cast<size_t>(lb) + c0
              + i % kEarlierCols];
  if constexpr (kMode != kDot)
    for (int i = tid; i < kPm; i += kEarlierThreads) pms[i] = 0.f;
  float acc[4][4][2];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[e][q][0] = acc[e][q][1] = 0.f;
  __syncthreads();

#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < steps;
    float pf[kPf];
    if (more) {
      const float* xt = x + (t + 1) * step_stride + c0;
#pragma unroll
      for (int p = 0; p < kPf; ++p) {
        const int i = tid + p * kEarlierThreads;
        if (i < kTile) pf[p] = xt[(i / kEarlierCols) * static_cast<size_t>(lb)
                                  + i % kEarlierCols];
      }
    }
    const float* xc = xs + cur * kTile;
    const float* pc = pms + cur * kPm;
    float* pn = pms + (cur ^ 1) * kPm;
    if constexpr (kMode == kRepeatAdd) {
      // m = repeat(pm, 4) + x[0]; pm = m[:64] + m[64:128]
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 2 * g + n;
        const float xv = xc[c];
        const float v = (pc[j * kPmStride + c] + xv)
                        + (pc[(16 + j) * kPmStride + c] + xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) pn[(4 * j + q) * kPmStride + c] = v;
      }
    } else {
      if constexpr (kMode == kDotAcs) {
        // m = repeat(pm, 4) + S @ x: m-row e*64 + 4j + q starts at state
        // row 16e + j
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float p = pc[(16 * e + j) * kPmStride + 2 * g + n];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[e][q][n] = p;
          }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 xv = *reinterpret_cast<const float2*>(
            xc + k * kEarlierCols + 2 * g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 sv = *reinterpret_cast<const float4*>(
              st + k * kRows + e * 64 + 4 * j);
          const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[e][q][0] = fmaf(sq[q], xv.x, acc[e][q][0]);
            acc[e][q][1] = fmaf(sq[q], xv.y, acc[e][q][1]);
          }
        }
      }
      if constexpr (kMode == kDotAcs) {
        // a = max(m[0:64], m[128:192]); b = max(m[64:128], m[192:256]);
        // pm = where(b > a, b, a)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float a = fmaxf(acc[0][q][n], acc[2][q][n]);
            const float b = fmaxf(acc[1][q][n], acc[3][q][n]);
            pn[(4 * j + q) * kPmStride + 2 * g + n] = b > a ? b : a;
          }
      }
    }
    if (more) {
      float* xn = xs + (cur ^ 1) * kTile;
#pragma unroll
      for (int p = 0; p < kPf; ++p) {
        const int i = tid + p * kEarlierThreads;
        if (i < kTile) xn[i] = pf[p];
      }
    }
    __syncthreads();
  }

  if constexpr (kMode == kDot) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(
            out + static_cast<size_t>(e * 64 + 4 * j + q) * lb + c0 + 2 * g) =
            make_float2(acc[e][q][0], acc[e][q][1]);
  } else {
    const float* fin = pms + (steps & 1) * kPm;
    for (int i = tid; i < kStates * kEarlierCols; i += kEarlierThreads)
      out[static_cast<size_t>(i / kEarlierCols) * lb + c0 + i % kEarlierCols] =
          fin[(i / kEarlierCols) * kPmStride + i % kEarlierCols];
  }
}

__device__ __forceinline__ float2 lds_volatile2_earlier(const float* p) {
  float2 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

// D5: ndots (a multiple of 8) chained products acc = W @ X[(i % 8)
// kKdim :][: kKdim] + acc * 1e-9 over 16 columns a block; thread (rg, g)
// owns rows i * 16 + rg (i < kRowsW / 16) of columns 2g, 2g + 1.  The 8
// dots of one pass over X's slices are unrolled (their loads overlap the
// previous dot's multiply-adds); the passes are not.
template <int kRowsW, int kKdim>
__global__ void __launch_bounds__(kEarlierThreads)
dots_chain_earlier(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, int ndots, int cols) {
  constexpr int kTm = kRowsW / 16;
  constexpr int kWs = kKdim + 4;            // padded row: no bank conflicts
  constexpr int kXRows = 8 * kKdim;
  __shared__ float4 ws4[kRowsW * kWs / 4];
  __shared__ float4 xs4[kXRows * kEarlierCols / 4];
  float* ws = reinterpret_cast<float*>(ws4);
  float* xs = reinterpret_cast<float*>(xs4);
  const int tid = threadIdx.x;
  const int rg = tid & 15;
  const int g = tid >> 4;
  const int c0 = blockIdx.x * kEarlierCols;
  for (int i = tid; i < kRowsW * kKdim; i += kEarlierThreads)
    ws[(i / kKdim) * kWs + i % kKdim] = w[i];
  for (int i = tid; i < kXRows * kEarlierCols; i += kEarlierThreads)
    xs[i] = x[static_cast<size_t>(i / kEarlierCols) * cols + c0
              + i % kEarlierCols];
  __syncthreads();
  float acc[kTm][2];
#pragma unroll
  for (int i = 0; i < kTm; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 1
  for (int pass = 0; pass < ndots / 8; ++pass) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const float* xd = xs + d * kKdim * kEarlierCols + 2 * g;
      float v[kTm][2];
#pragma unroll
      for (int i = 0; i < kTm; ++i) v[i][0] = v[i][1] = 0.f;
#pragma unroll
      for (int k = 0; k < kKdim; k += 4) {
        float2 xv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          xv[kk] = lds_volatile2_earlier(xd + (k + kk) * kEarlierCols);
#pragma unroll
        for (int i = 0; i < kTm; ++i) {
          const float4 wv = lds_volatile4(ws + (i * 16 + rg) * kWs + k);
          const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            v[i][0] = fmaf(wk[kk], xv[kk].x, v[i][0]);
            v[i][1] = fmaf(wk[kk], xv[kk].y, v[i][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          acc[i][n] = __fadd_rn(v[i][n], __fmul_rn(acc[i][n], 1e-9f));
    }
  }
#pragma unroll
  for (int i = 0; i < kTm; ++i)
    *reinterpret_cast<float2*>(out + static_cast<size_t>(i * 16 + rg) * cols +
                               c0 + 2 * g) = make_float2(acc[i][0],
                                                         acc[i][1]);
}

template <int kMode, int K>
int launch_steps_earlier(const float* s, const float* x, float* out, int steps,
                 int xk, int lb, cudaStream_t st) {
  constexpr int kSRows = kMode == kRepeatAdd ? 0 : K;
  constexpr int kXRows = kMode == kRepeatAdd ? 1 : K;
  const size_t smem = sizeof(float) * (kSRows * kRows
                                       + 2 * kXRows * kEarlierCols
                                       + 2 * kStates * kPmStride);
  auto kernel = dot_steps_earlier<kMode, K>;
  const int rc = launch_smem(kernel, smem);
  if (rc) return rc;
  kernel<<<lb / kEarlierCols, kEarlierThreads, smem, st>>>(s, x, out, steps,
                                                          xk, lb);
  return 0;
}

template <int kMode>
int launch_steps_k_earlier(int k, const float* s, const float* x, float* out,
                   int steps, int lb, cudaStream_t st) {
  switch (k) {
    case 8:
      return launch_steps_earlier<kMode, 8>(s, x, out, steps, k, lb, st);
    case 16:
      return launch_steps_earlier<kMode, 16>(s, x, out, steps, k, lb, st);
    case 80:
      return launch_steps_earlier<kMode, 80>(s, x, out, steps, k, lb, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kRowsW, int kKdim>
int launch_dots_earlier(int ndots, const float* x, const float* w, float* out,
                int cols, cudaStream_t st) {
  dots_chain_earlier<kRowsW, kKdim>
      <<<cols / kEarlierCols, kEarlierThreads, 0, st>>>(x, w, out, ndots,
                                                        cols);
  return 0;
}

// bf16 pairs for the mma fragments: the lower k in the low half
__device__ __forceinline__ uint32_t pack2_earlier(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mma_bf16_earlier(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of column col of X [16][ld] (k-major): k pairs
// (lane % 4) * 2 and + 8.
__device__ __forceinline__ void load_b_earlier(uint32_t& b0, uint32_t& b1,
                                       const unsigned short* x, size_t ld,
                                       size_t col, int lane) {
  const int k = (lane % 4) * 2;
  b0 = pack2_earlier(x[k * ld + col], x[(k + 1) * ld + col]);
  b1 = pack2_earlier(x[(k + 8) * ld + col], x[(k + 9) * ld + col]);
}

// D2: STEPS steps of [256, 16] @ [16, 16 columns] in bf16 on the tensor
// cores, f32 running sum [256][lb].
__global__ void __launch_bounds__(kStepThreads)
dot_steps_bf16_earlier(const unsigned short* __restrict__ s,
               const unsigned short* __restrict__ x, float* __restrict__ out,
               int steps, int lb) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const size_t c0 = static_cast<size_t>(blockIdx.x) * kStepCols;
  const size_t step_stride = static_cast<size_t>(16) * lb;
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) load_a(a[i], s, 4 * w + i, lane);
  float d[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[i][ct][v] = 0.f;
  uint32_t b[2][2];
#pragma unroll
  for (int ct = 0; ct < 2; ++ct)
    if (steps > 0) load_b_earlier(b[ct][0], b[ct][1], x, lb,
                                  c0 + 8 * ct + lane / 4,
                          lane);
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    uint32_t nb[2][2];
    if (t + 1 < steps) {
      const unsigned short* xt = x + (t + 1) * step_stride;
#pragma unroll
      for (int ct = 0; ct < 2; ++ct)
        load_b_earlier(nb[ct][0], nb[ct][1], xt, lb, c0 + 8 * ct + lane / 4,
                       lane);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) mma_bf16_earlier(d[i][ct], a[i], b[ct][0],
                                              b[ct][1]);
    if (t + 1 < steps) {
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        b[ct][0] = nb[ct][0];
        b[ct][1] = nb[ct][1];
      }
    }
  }
  // the C fragment: rows lane / 4 and + 8, columns (lane % 4) * 2, + 1
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      const size_t r = 16 * (4 * w + i) + lane / 4;
      const size_t c = c0 + 8 * ct + (lane % 4) * 2;
      *reinterpret_cast<float2*>(out + r * lb + c) =
          make_float2(d[i][ct][0], d[i][ct][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * lb + c) =
          make_float2(d[i][ct][2], d[i][ct][3]);
    }
}

int launch_steps_bf16_earlier(const void* s, const void* x, float* out,
                              int steps, int lb, cudaStream_t st) {
  dot_steps_bf16_earlier<<<lb / kStepCols, kStepThreads, 0, st>>>(
      static_cast<const unsigned short*>(s),
      static_cast<const unsigned short*>(x), out, steps, lb);
  return 0;
}

"""

_LAST_ERROR = "int last_error(int rc) {"
#: the entry points' calls of the kernels' launchers, and the same calls
#: of the earlier designs
_EARLIER_CALLS = [
    ("rc = launch_steps_k<kDot>(k, sf, xf, o, steps, lb, st);",
     "rc = launch_steps_k_earlier<kDot>(k, sf, xf, o, steps, lb, st);"),
    ("rc = launch_steps_c<kRepeatAdd, 1>(sf, xf, o, steps, k, lb,",
     "rc = launch_steps_earlier<kRepeatAdd, 1>(sf, xf, o, steps, k, lb,"),
    ("rc = launch_steps_k<kDotAcs>(k, sf, xf, o, steps, lb, st);",
     "rc = launch_steps_k_earlier<kDotAcs>(k, sf, xf, o, steps, lb, st);"),
] + [(f"rc = launch_dots<{r}, {k}>(", f"rc = launch_dots_earlier<{r}, {k}>(")
     for r, k, _ in vpu_probe2.DOT_SHAPES] + [
    ("last_error(launch_steps_bf16(s, x,",
     "last_error(launch_steps_bf16_earlier(s, x,")]

#: D2's step body on wgmma, and the same step on mma.sync from the ring:
#: a warp's B fragments of a step by ldmatrix.trans from the [128, 64]
#: tile (16-byte chunk c of row r at c ^ (r & 7)), its slabs' row tiles x
#: the strip's units, the stage's buffer released once read
_D2_WGMMA = """    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int t = 0; t < kD2Steps; ++t) {
      const uint64_t b = x_desc(buf + t * 2048);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_acc<N>(d[j], a[j], b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % kD2Stages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");"""
_D2_MMA_SYNC = """    const int ln = threadIdx.x & 31;
#pragma unroll
    for (int t = 0; t < kD2Steps; ++t) {
      uint32_t b[N / 8][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // matrix m = ln / 8: unit 2p + m / 2, k rows 8 (m & 1) + ln % 8
        const int r = 16 * t + 8 * ((ln >> 3) & 1) + (ln & 7);
        const int c = 2 * p + (ln >> 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];"
            : "=r"(b[2 * p][0]), "=r"(b[2 * p][1]), "=r"(b[2 * p + 1][0]),
              "=r"(b[2 * p + 1][1])
            : "r"(buf + r * 128 + ((c ^ (r & 7)) << 4)) : "memory");
      }
      if constexpr (N == 40) {
        const int r = 16 * t + (ln & 15);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
            : "=r"(b[4][0]), "=r"(b[4][1])
            : "r"(buf + r * 128 + ((4 ^ (r & 7)) << 4)) : "memory");
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < N / 8; ++u)
          mma_ring(d[j] + 4 * u, a[j], b[u][0], b[u][1]);
    }
    mbar_arrive(empty + st * 8);
  }"""
_MMA_RING = """// d[0..3] += A @ B for one 16-row tile and 8 columns (mma.sync)
__device__ __forceinline__ void mma_ring(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

"""
_D2_CONSUMER = "// D2's consumer warpgroup over every stage:"

#: D1's depth loop
_DEPTH_LOOP = "#pragma unroll\n      for (int k = 0; k < K; ++k) {"

#: name -> [(text, replacement), ...] applied to dots.cu in order
VARIANTS = {
    "earlier": [(_LAST_ERROR, _EARLIER + "\n" + _LAST_ERROR), *_EARLIER_CALLS],
    "tile_earlier_grid": [("constexpr int kWideCols = 9;",
                        "constexpr int kWideCols = 4;"),
                       ("constexpr int kDotCols = 9;",
                        "constexpr int kDotCols = 4;"),
                       ("constexpr int kG = kR >= 8 ? 3 : 1;",
                        "constexpr int kG = kR >= 8 ? 4 : 1;")],
    "ring_3": [("constexpr int kXStages = kC == 1 ? 3 : 2;",
                "constexpr int kXStages = 3;")],
    "k_unroll_16": [(_DEPTH_LOOP, _DEPTH_LOOP.replace("unroll", "unroll 16"))],
    "s_shared": [("  static constexpr bool kSRegs = kMode != kRepeatAdd && kC "
                  "== 1 && K <= 16;",
                  "  static constexpr bool kSRegs = false;")],
    "d5_one_warp_a_scheduler": [
        ("const int chains = kRowsW >= 128 ? 1 : kRows / kRowsW;",
         "const int chains = 1;")],
    "d5_one_column": [("constexpr int kG = kR >= 8 ? 3 : 1;",
                       "constexpr int kG = 1;")],
    "strips_32": [("constexpr int kD2Units = 5;",
                   "constexpr int kD2Units = 4;")],
    "stage_16": [("constexpr int kD2Steps = 8;",
                  "constexpr int kD2Steps = 16;")],
    "mma_sync": [(_D2_CONSUMER, _MMA_RING + _D2_CONSUMER),
                 (_D2_WGMMA, _D2_MMA_SYNC)],
}

#: the probes whose code each variant changes, where it is timed
PROBES = {"earlier": ("D1", "D2", "D5"), "tile_earlier_grid": ("D1", "D5"),
          "ring_3": ("D1",), "k_unroll_16": ("D1",), "s_shared": ("D1",),
          "d5_one_warp_a_scheduler": ("D5",), "d5_one_column": ("D5",),
          "strips_32": ("D2",), "stage_16": ("D2",), "mma_sync": ("D2",)}


def variant_source(src: str, edits) -> str:
    """``src`` with each (text, replacement) of ``edits`` applied in
    order; each text must be found exactly once in the text as it stands
    then."""
    for old, new in edits:
        n = src.count(old)
        if n != 1:
            raise ValueError(f"variant text found {n} times, not once: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_variant(name: str, text: str) -> subprocess.Popen:
    """Start nvcc of ``text`` (a dots.cu) alone into
    build/variants/dots_<name>.so."""
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"dots_{name}.cu"
    cu.write_text(text)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             "-o", str(out / f"dots_{name}.so"), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.BUILD / "variants" / f"dots_{name}.so"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dabjax_probe_dot_steps.argtypes = [vp] * 3 + [i] * 5 + [vp]
    lib.dabjax_probe_dots.argtypes = [vp] * 3 + [i] * 4 + [vp]
    return lib


def _in_turns(fns: dict) -> dict:
    """{key: median device ms} (``tools.device_ms``) of 4 runs of 20 calls
    of each ``fns[key]()``, in turns."""
    spread = tools.interleaved_ms(fns, 4, 20, tools.device_ms)
    return {key: v["median"] for key, v in spread.items()}


def _slopes(fns: dict, n1: int, n2: int) -> dict:
    """{name: us per unit}: the slope of each ``fns[name](n)``'s device
    time from n1 to n2, the lengths and names timed in turns."""
    med = _in_turns({(name, n): (lambda fn=fn, n=n: fn(n))
                     for name, fn in fns.items() for n in (n1, n2)})
    return {name: (med[(name, n2)] - med[(name, n1)]) / (n2 - n1) * 1e3
            for name in fns}


def _line(label: str, unit: str, per: dict) -> str:
    return f"{label}: " + ", ".join(f"{name} {us:.4f}" for name, us in
                                    per.items()) + f" {unit}"


def _d2_holds(got_int, want_int, got, want, what: str) -> None:
    """D2's rule: bit for bit on integers, within DOT_TOL on normals."""
    rel = float((got - want).abs().max()) / float(want.abs().max())
    if not torch.equal(got_int, want_int) or rel > vd.DOT_TOL:
        raise AssertionError(f"{what} differs from the kernel (integers "
                             f"equal: {torch.equal(got_int, want_int)}, "
                             f"{rel:.2e} of max |kernel|)")


def main() -> int:
    if not tools.have_card("dot_variants"):
        return 1
    dev = torch.device("cuda", 0)
    src = (_build.CSRC / "dots.cu").read_text()
    jobs = {name: _build_variant(name, variant_source(src, edits))
            for name, edits in VARIANTS.items()}
    for name, job in jobs.items():
        _, err = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc dots_{name} failed:\n{err[:3000]}")
    libs = {name: _load(name) for name in VARIANTS}
    stream = torch.cuda.current_stream().cuda_stream

    def of(probe):
        return {name: lib for name, lib in libs.items()
                if probe in PROBES[name]}

    def steps_fn(lib, name, s, x, rows, k, mode, lb):
        """The variant's step loop on X[:n], as dot_steps_cuda calls it."""
        out = torch.empty((rows, lb), dtype=torch.float32, device=dev)
        dtype = 0 if x.dtype == torch.float32 else 1

        def run(n):
            rc = lib.dabjax_probe_dot_steps(
                s.data_ptr(), x.data_ptr(), out.data_ptr(),
                vd.MODES.index(mode), dtype, k, n, lb, stream)
            if rc:
                raise RuntimeError(f"variant {name}: CUDA error {rc}")
            return out
        return run

    for label, k, mode, lb in vd.F32_TIMED:
        n1, n2 = vd.steps_long(lb)
        s, x = (t.to(dev) for t in vd.probe_inputs(k, lb, n2))
        rows = vd.ROWS if mode == "dot" else 64
        fns = {"kernel": lambda n: vd.dot_steps_cuda(s, x[:n], mode)}
        for name, lib in of("D1").items():
            run = steps_fn(lib, name, s, x, rows, k, mode, lb)
            if not torch.equal(run(n1), vd.dot_steps_cuda(s, x[:n1], mode)):
                raise AssertionError(f"D1 variant {name} ({label}) differs")
            fns[name] = run
        print(_line(f"D1 {label} LB={lb}", "us/step", _slopes(fns, n1, n2)),
              flush=True)

    for lb in vd.LBS:
        n1, n2 = vd.steps_long(lb)
        s, x = (t.to(dev) for t in vd.probe_inputs(16, lb, n2, "bfloat16"))
        si, xi = (t.to(dev) for t in _ints(lb, n1))
        fns = {"kernel": lambda n: vd.dot_steps_cuda(s, x[:n])}
        for name, lib in of("D2").items():
            run = steps_fn(lib, name, s, x, vd.ROWS, 16, "dot", lb)
            run_int = steps_fn(lib, name, si, xi, vd.ROWS, 16, "dot", lb)
            _d2_holds(run_int(n1), vd.dot_steps_cuda(si, xi), run(n1),
                      vd.dot_steps_cuda(s, x[:n1]), f"D2 variant {name}")
            fns[name] = run
        print(_line(f"D2 bf16 dot K=16 LB={lb}", "us/step",
                    _slopes(fns, n1, n2)), flush=True)
    # D2 past the L2 at LB 4480: X made on the device, too large to stay in
    # the L2 between calls
    n1, n2 = vd.STEPS_PAST_L2
    gen = torch.Generator(device=dev).manual_seed(12)
    s = torch.randn((vd.ROWS, 16), generator=gen, device=dev).to(
        torch.bfloat16)
    x = torch.randn((n2, 16, 4480), generator=gen, device=dev).to(
        torch.bfloat16)
    fns = {"kernel": lambda n: vd.dot_steps_cuda(s, x[:n])}
    for name, lib in of("D2").items():
        fns[name] = steps_fn(lib, name, s, x, vd.ROWS, 16, "dot", 4480)
    print(_line("D2 bf16 dot K=16 LB=4480 past the L2", "us/step",
                _slopes(fns, n1, n2)), flush=True)
    del x

    n1, n2 = vpu_probe2.DOT_NS_LONG
    for (rows, kdim, tag), (_, x, w) in zip(vpu_probe2.DOT_SHAPES,
                                            vpu_probe2.dot_inputs()):
        x, w = x.to(dev), w.to(dev)
        cols = x.shape[1]
        fns = {"kernel": lambda n: vpu_probe2.dots_cuda(x, w, n)}
        for name, lib in of("D5").items():
            out = torch.empty((rows, cols), dtype=torch.float32, device=dev)

            def run(n, lib=lib, out=out, name=name):
                rc = lib.dabjax_probe_dots(x.data_ptr(), w.data_ptr(),
                                           out.data_ptr(), rows, kdim, n,
                                           cols, stream)
                if rc:
                    raise RuntimeError(f"D5 variant {name}: CUDA error {rc}")
                return out
            if not torch.equal(run(n1), vpu_probe2.dots_cuda(x, w, n1)):
                raise AssertionError(f"D5 variant {name} ({tag}) differs")
            fns[name] = run
        print(_line(f"D5 {tag}", "us/dot", _slopes(fns, n1, n2)), flush=True)
    return 0


def _ints(lb: int, steps: int):
    """bf16 S [256, 16] and X [steps, 16, lb] in -1 .. 1: every sum exact
    in float32."""
    rng = np.random.default_rng(lb)
    return (torch.from_numpy(rng.integers(-1, 2, shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((vd.ROWS, 16), (steps, 16, lb)))


if __name__ == "__main__":
    sys.exit(main())
