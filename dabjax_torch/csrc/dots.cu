// Small-K matrix products issued in a loop: the Hopper probes of
// tools/vit_dotshapes.py (probe, probe_batched) and tools/vpu_probe2.py
// (make_dots, its `dot` half), which timed the TPU's matrix unit on the
// branch-metric shapes of the Viterbi kernels ([256, K] @ [K, lanes] with
// K = 8, 16 or 80).  Plain C interface, loaded with ctypes by
// dabjax_torch/tools/vit_dotshapes.py and vpu_probe2.py; every entry point
// launches on the caller's stream and returns the first CUDA error of its
// launch (0 when none).
//
// What bounds them on the card.  f32 has no tensor-core product on Hopper
// (TF32 would round the inputs), so f32 runs as FFMA on the CUDA cores:
// a [256, 16] @ [16, 4480] step is 18.4 M FMAs, 0.55 us at the 67 TFLOP/s
// of the FP32 lanes, against 0.09 us to read its 287 KB of X, so the loop
// is bound by operations.  bf16 runs on the tensor cores (wgmma) with f32
// accumulation: a step is 0.037 us of tensor-core work against 0.043 us
// to read its 143 KB of X, so the bf16 loop is bound by bytes, and only
// if X arrives many steps ahead of the products (one global load round
// trip, about 1200 SM clocks, is 0.6 us a step).  The batched
// product writes a [256, STEPS * LB] f32 result (147 MB at K 16, LB 4480,
// 32 steps): it is bound by that store (44 us at 3.35 TB/s), not by its
// 1.2 GFLOP.  So D4 (bf16) is built around the store: its tensor-core
// work is 1.2 us of the 44.
//
// Designs.
//   D1 dot_steps_f32 (probe, f32): a warp owns all 256 rows of kC
//     columns (kWideCols = 9, or 1 where LB is at most 4 warps an SM), a
//     block is 4 warps, one a scheduler: at LB 4480, 498 warps on the 528
//     schedulers of 132 SMs (the 16-column blocks before gave 280 blocks,
//     3 warps on the busiest schedulers against 2.12 on average; at LB
//     512, 512 warps of one column).  Lane (j, h) = (lane & 15, lane >> 4)
//     owns rows e*64 + 4j + q, e in {h, h + 2}, q < 4: a tile of 8 rows x
//     kC columns, kC running sums a row.  A depth k costs two LDS.128 of S
//     (transposed in shared memory, [K][256], one block copy) and kC
//     broadcast values of X (every lane reads the same address) for 8 kC
//     FFMA: 72 at kC 9 against 32 FFMA for 5 loads before.  Each warp
//     brings its [K, kC] tiles of X through its own ring (kXStages: 3
//     steps at kC 1, 2 at 9) by 4-byte cp.async (rows padded to 16
//     bytes, so a row reads as two LDS.128 and one LDS.32), so the step
//     loop has no block barrier, only __syncwarp.  At kC 1 and K <= 16,
//     S sits in registers (its 8 rows x K), so a depth costs one
//     broadcast load for 8 FFMA.  dot_acs: the rows of one state row 4j
//     + q are split over lanes (j, 0) (e = 0, 2: a = max) and (j, 1) (e =
//     1, 3: b = max), one __shfl_xor a value joins them, and the warp's
//     [kC][64] state in shared memory gives each m-row its start, state
//     row 16e + j: the state of a column never leaves its warp.  dot
//     keeps all 256 rows live as a running sum (a compiler would drop
//     rows no one reads); repeat_add and dot_acs keep the TPU's [64, LB]
//     state.  Sums are FMA chains from the running value (the TPU adds a
//     finished dot to it): exact on integers, within rounding on the
//     TPU's normal inputs.  vit_dotshapes.step_tiles() is the thread ->
//     (rows, columns) map.  The depth loop is unrolled whole, so a K 80
//     step at 9 columns is 5760 FFMA of code (about 92 KB): it runs 2.1x
//     slower than the same loop unrolled 16 at a time (a variant timed
//     on the card, PERF_HISTORY.md), which the SASS count of one step
//     would no longer see.
//   D2 dot_steps_bf16 (probe, bf16, dot): the step loop as a GEMM K-loop,
//     sum_t S @ X_t = [S ... S] @ X.view(16 steps, LB), whose f32
//     accumulators stay in registers from the first step to the last (no
//     split-K; one store at the end).  X_t does not depend on the sum, so
//     it streams ahead of the tensor cores: a producer warp brings stages
//     of kD2Steps steps by TMA, one [128 rows, 64 columns] box a stage
//     from the block's first column (128-byte swizzle, D4's layout), into
//     a ring of kD2Stages stages with full / empty mbarriers: 32 steps, 64
//     KB, ahead of the products.  The consumer warpgroup holds S as wgmma
//     A fragments in registers and issues, each step, one wgmma.m64n40k16
//     a 64-row slab (m64n32k16 for a strip of at most 4 units) into the
//     same accumulators; a stage's products are one commit group, waited
//     on one stage later (wait_group 1), so successive steps pipeline as a
//     GEMM main loop's do, and its buffer then goes back to the producer.
//     Two costs set its time, not the bytes in flight (a deeper ring was
//     no faster): the wgmma a step (a separate m64n8k16 for a fifth unit
//     ran slower) and the TMA's requests, one a box row (unswizzled [rows,
//     8] boxes, one a unit, ran slower; PERF.md section 6).  Columns go
//     in 8-column units, 4 or 5 a block
//     (vit_dotshapes.bf16_step_strips): at LB 4480, 132 blocks of 32 or
//     40 columns, one an SM, where 140 strips of 32 would give 8 SMs two;
//     at LB 512, 16 blocks of 32.  Rows past the last step and
//     columns past LB arrive as zeros from the TMA (they add nothing); a
//     block stores its own units only.  X must be 16-byte aligned (the
//     tensor map); out takes plain stores.
//   D3 dot_batched_f32: one thread per output column, X's column in
//     registers, S broadcast from shared memory, rows stored in order (a
//     warp writes 128 contiguous bytes per row).
//   D4 dot_batched_bf16 (wgmma and TMA): a persistent grid, one block of
//     five warps per SM, walks 64-column tiles.  The producer warp brings
//     each X tile [16, 64] by TMA (128-byte swizzle, zero-filled past N)
//     into a ring of kD4Stages buffers with full / empty mbarriers.  The
//     consumer warpgroup holds S as wgmma A fragments in registers (16 a
//     thread) and issues one wgmma.m64n64k16 per 64-row slab, four a tile,
//     into f32 accumulators.  The epilogue writes them to a staged
//     [256, 64] f32 tile in shared memory in the TMA's 128-byte-swizzled
//     layout (no bank conflicts) and leaves by two TMA stores of [256, 32]
//     boxes: whole 128-byte lines, clipped at N, evict-first in L2.  The
//     staged tile is double-buffered (cp.async.bulk.wait_group.read before
//     reuse), so one tile drains while the next computes.  The tensor
//     maps come from the driver's cuTensorMapEncodeTiled, looked up in the
//     already loaded libcuda (no -lcuda at link).
//   D5 dots_chain (make_dots): n_dots chained products
//     acc = W @ X[(i % 8) * kdim :][:kdim] + acc * 1e-9.  A warp owns all
//     rows of ncw columns, lane l rows 32 i + l, their W in registers (8 x
//     8, 4 x 32 or 1 x 8 values).  ncw is the fewest columns (at most
//     kDotCols = 9) that need no more than one warp a scheduler where a
//     lane has 4 or 8 rows (9 at 4480 columns: 498 warps), 8 warps a
//     scheduler at one row a lane ([32, 8]: 2 columns, 2240 warps; its dot
//     is one chain of 8 FFMA a lane, which one warp cannot keep the pipe
//     busy with).  The warp copies its columns of X transposed ([c][8
//     kdim]) into shared memory once, then runs the columns' whole chains
//     kG at a time (3 at 8 rows a lane: one load latency a dot for three
//     columns' 192 FFMA; one at a time they ran 1.4x slower): each dot
//     reads a column's kdim values by broadcast LDS.128.  Dots i and i + 8
//     are the same product, so an unrolled loop would invite the compiler
//     to compute each distinct product once (ptxas folded the dependent
//     chains of chains.cu): the passes over X's 8 slices run in a loop
//     that is not unrolled (n_dots is a run-time argument), and every dot
//     loads X with volatile shared loads, which ptxas must keep and
//     cannot prove equal (nor hoist out of the loop), so each dot keeps
//     its loads and multiply-adds.  acc * 1e-9 and the add are rounded
//     separately (__fmul_rn, __fadd_rn), as torch's two ops are: each
//     output costs kdim + 2 FP32 instructions a dot against the bound's
//     kdim FMA.
// vit_dotshapes.sass_counts() and vpu_probe2.dot_sass_counts() count the
// FFMA / HGMMA of one step, stage or tile and the FFMA of one dot in the
// built library: the step, stage, tile, pass and column loops are not
// unrolled, so a kernel's count is one step's (D1: of the kC = 9 kernel, 8
// x 9 x K), one stage's of each of D2's two paths (n40 and n32: 2 x 4
// slabs x kD2Steps), one tile's (D4: 4) or one pass's of 8 dots of one
// column.

#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

enum DotMode { kDot = 0, kRepeatAdd = 1, kDotAcs = 2 };
enum DotType { kF32 = 0, kBF16 = 1 };

constexpr int kRows = 256;          // rows of S (4 branches x 64 states)
constexpr int kStates = 64;
constexpr int kStepCols = 16;       // D1/D2/D5: LB and cols are multiples
                                    // of it
constexpr int kStepWarps = 4;       // D1/D5: warps of a block, one a scheduler
constexpr int kStepThreads = 32 * kStepWarps;
constexpr int kWideCols = 9;        // D1: columns of a warp above 4 warps an SM
constexpr int kMaxStaticSmem = 48 * 1024;
// D1: steps of X in a warp's ring: 3 at one column a warp, 2 at kWideCols
// (there 2 ran faster than 3: PERF_HISTORY.md)
template <int kC>
constexpr int kXStages = kC == 1 ? 3 : 2;

// D1's shared memory, in floats: S transposed [K][256] (unless S sits in
// registers: one column a warp, K <= 16), then each warp's ring of X
// slots [kXRows][kXs] (rows padded to 16 bytes) and its state [kC][64]
template <int kMode, int K, int kC>
struct StepLayout {
  static constexpr bool kSRegs = kMode != kRepeatAdd && kC == 1 && K <= 16;
  static constexpr int kS = kMode != kRepeatAdd && !kSRegs ? K * kRows : 0;
  static constexpr int kXRows = kMode == kRepeatAdd ? 1 : K;
  static constexpr int kXs = (kC + 3) & ~3;
  static constexpr int kStages = kXStages<kC>;
  static constexpr int kSlot = kXRows * kXs;
  static constexpr int kPm = kMode == kDot ? 0 : kC * kStates;
  static constexpr int kWarp = kStages * kSlot + kPm;
  static constexpr int kFloats = kS + kStepWarps * kWarp;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 4-byte cp.async, or 4 zero bytes when !valid (src must still be a
// valid address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// kC values of one row of an X slot (16-byte aligned), broadcast to the
// warp: LDS.128 by four, then LDS.32
template <int kC>
__device__ __forceinline__ void load_x(const float* p, float (&v)[kC]) {
#pragma unroll
  for (int c = 0; c + 4 <= kC; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + c);
    v[c] = f.x;
    v[c + 1] = f.y;
    v[c + 2] = f.z;
    v[c + 3] = f.w;
  }
#pragma unroll
  for (int c = kC / 4 * 4; c < kC; ++c) v[c] = p[c];
}

// D1: STEPS steps of [256, K] @ [K, kC columns] a warp on the CUDA cores.
// s [256][K], x [steps][xk][lb] (xk = K except for repeat_add, which reads
// row 0 only), out dot: [256][lb], else [64][lb].  Lane (j, h) = (lane &
// 15, lane >> 4) owns rows e*64 + 4j + q, e in {h, h + 2}, q < 4, of the
// warp's kC columns c0 + c (see the design note at the top).
template <int kMode, int K, int kC>
__global__ void __launch_bounds__(kStepThreads, 1)
dot_steps_f32(const float* __restrict__ s, const float* __restrict__ x,
              float* __restrict__ out, int steps, int xk, int lb) {
  using L = StepLayout<kMode, K, kC>;
  constexpr bool kSRegs = L::kSRegs;
  constexpr int kXRows = L::kXRows, kXs = L::kXs, kSlot = L::kSlot;
  constexpr int kStages = L::kStages;
  constexpr int kCopies = (kXRows * kC + 31) / 32;
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ring = st + L::kS + warp * L::kWarp;
  float* pm = ring + kStages * kSlot;            // the warp's state
  const int j = lane & 15, h = lane >> 4;
  const int c0 = (blockIdx.x * kStepWarps + warp) * kC;

  if constexpr (L::kS > 0) {
    for (int i = threadIdx.x; i < kRows * K; i += kStepThreads)
      st[(i % K) * kRows + i / K] = s[i];
    __syncthreads();
  }
  if (c0 >= lb) return;
  float4 sr[kSRegs ? K : 1][2];
  if constexpr (kSRegs) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int ei = 0; ei < 2; ++ei) {
        const float* r = s + ((h + 2 * ei) * 64 + 4 * j) * K + k;
        sr[k][ei] = make_float4(r[0], r[K], r[2 * K], r[3 * K]);
      }
  }
  // rows e*64 + 4j .. + 3 of S at depth k, e = h + 2 ei
  auto srow = [&](int k, int ei) -> float4 {
    if constexpr (kSRegs)
      return sr[k][ei];
    else
      return *reinterpret_cast<const float4*>(st + k * kRows
                                              + (h + 2 * ei) * 64 + 4 * j);
  };

  // step t's [kXRows, kC] tile of X into its slot: one copy group,
  // empty past the last step; columns past lb are zeros
  const size_t step_stride = static_cast<size_t>(xk) * lb;
  const uint32_t ring_s = smem_u32(ring);
  auto fetch = [&](int t) {
    if (t < steps) {
      const float* xt = x + t * step_stride + c0;
      const uint32_t slot = ring_s + (t % kStages) * kSlot * 4;
#pragma unroll
      for (int p = 0; p < kCopies; ++p) {
        const int i = lane + 32 * p;
        const int k = i / kC, c = i % kC;
        const bool valid = i < kXRows * kC && c0 + c < lb;
        if (i < kXRows * kC)
          cp_async4(slot + (k * kXs + c) * 4,
                    valid ? xt + static_cast<size_t>(k) * lb + c : x, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  if constexpr (L::kPm > 0) {
    for (int i = lane; i < L::kPm; i += 32) pm[i] = 0.f;
  }
  float acc[2][4][kC];
#pragma unroll
  for (int ei = 0; ei < 2; ++ei)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[ei][q][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    fetch(t + kStages - 1);
    cp_async_wait<kStages - 1>();               // step t has landed
    __syncwarp();
    const float* xs = ring + (t % kStages) * kSlot;
    if constexpr (kMode == kRepeatAdd) {
      // m = repeat(pm, 4) + x[0]; pm = m[:64] + m[64:128]: state rows
      // 4j + q take (pm[j] + x) + (pm[16 + j] + x)
      float v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float xv = xs[c];
        v[c] = (pm[c * kStates + j] + xv) + (pm[c * kStates + 16 + j] + xv);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if ((c & 1) == h)
          *reinterpret_cast<float4*>(pm + c * kStates + 4 * j) =
              make_float4(v[c], v[c], v[c], v[c]);
    } else {
      if constexpr (kMode == kDotAcs) {
        // m = repeat(pm, 4) + S @ x: m-row e*64 + 4j + q starts at state
        // row 16e + j
#pragma unroll
        for (int ei = 0; ei < 2; ++ei)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float p = pm[c * kStates + 16 * (h + 2 * ei) + j];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[ei][q][c] = p;
          }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float xv[kC];
        load_x<kC>(xs + k * kXs, xv);
#pragma unroll
        for (int ei = 0; ei < 2; ++ei) {
          const float4 sv = srow(k, ei);
          const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < kC; ++c)
              acc[ei][q][c] = fmaf(sq[q], xv[c], acc[ei][q][c]);
        }
      }
      if constexpr (kMode == kDotAcs) {
        // a = max(m[0:64], m[128:192]) in lane h = 0, b = max(m[64:128],
        // m[192:256]) in lane h = 1; pm = where(b > a, b, a)
        float pn[4][kC];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float mine = fmaxf(acc[0][q][c], acc[1][q][c]);
            const float other = __shfl_xor_sync(0xffffffffu, mine, 16);
            const float a = h ? other : mine, b = h ? mine : other;
            pn[q][c] = b > a ? b : a;
          }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if ((c & 1) == h)
            *reinterpret_cast<float4*>(pm + c * kStates + 4 * j) =
                make_float4(pn[0][c], pn[1][c], pn[2][c], pn[3][c]);
      }
    }
    __syncwarp();           // slot t % kStages read, pm written
  }

  if constexpr (kMode == kDot) {
#pragma unroll
    for (int ei = 0; ei < 2; ++ei)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (c0 + c < lb)
            out[static_cast<size_t>((h + 2 * ei) * 64 + 4 * j + q) * lb + c0
                + c] = acc[ei][q][c];
  } else {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c0 + c < lb) {
        out[static_cast<size_t>(lane) * lb + c0 + c] = pm[c * kStates + lane];
        out[static_cast<size_t>(lane + 32) * lb + c0 + c] =
            pm[c * kStates + lane + 32];
      }
  }
}

// The A fragment of rows 16 rt .. 16 rt + 15 of S [256][16] (row-major):
// rows lane / 4 and + 8, k pairs (lane % 4) * 2 and + 8.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const unsigned short* s, int rt,
                                       int lane) {
  const int r = 16 * rt + lane / 4, k = (lane % 4) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(s + r * 16 + k);
  a[1] = *reinterpret_cast<const uint32_t*>(s + (r + 8) * 16 + k);
  a[2] = *reinterpret_cast<const uint32_t*>(s + r * 16 + k + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(s + (r + 8) * 16 + k + 8);
}

constexpr int kBatchThreads = 256;

// Volatile shared-memory loads: ptxas must issue every one and cannot
// prove two of them equal, so no product built from them is shared.
__device__ __forceinline__ float4 lds_volatile4(const float* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// D3: [256, K] @ [K, n] in f32, one thread per column.
template <int K>
__global__ void __launch_bounds__(kBatchThreads)
dot_batched_f32(const float* __restrict__ s, const float* __restrict__ x,
                float* __restrict__ out, long long n) {
  __shared__ float4 ss4[kRows * K / 4];
  const float* ss = reinterpret_cast<const float*>(ss4);
  for (int i = threadIdx.x; i < kRows * K / 4; i += kBatchThreads)
    ss4[i] = reinterpret_cast<const float4*>(s)[i];
  __syncthreads();
  const long long c =
      static_cast<long long>(blockIdx.x) * kBatchThreads + threadIdx.x;
  if (c >= n) return;
  float xr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) xr[k] = x[k * n + c];
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(ss + r * K + k);
      v = fmaf(sv.x, xr[k], v);
      v = fmaf(sv.y, xr[k + 1], v);
      v = fmaf(sv.z, xr[k + 2], v);
      v = fmaf(sv.w, xr[k + 3], v);
    }
    out[r * n + c] = v;
  }
}

// D4: [256, 16] @ [16, n] in bf16 on the tensor cores (wgmma), f32 out,
// in 64-column tiles; see the design note at the top.
constexpr int kD4Cols = 64;                       // columns of a tile
constexpr int kD4Stages = 3;                      // X tiles in flight
constexpr int kD4XBytes = 16 * kD4Cols * 2;       // an X tile, bf16
constexpr int kD4Box = kRows * 32 * 4;            // a [256, 32] f32 box
constexpr int kD4OutBytes = 2 * kD4Box;           // a staged output tile
constexpr int kD4OutBufs = 2;                     // staged tiles
constexpr int kD4Threads = 160;                   // 4 consumer warps + 1
constexpr int kD4Smem = kD4OutBufs * kD4OutBytes + kD4Stages * kD4XBytes
                        + 2 * kD4Stages * 8 + 1024;  // + 1 KB to align

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// TMA: box at (column c0, row c1) of the map -> shared dst, completion
// counted on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1) : "memory");
}

// TMA: shared src -> box at (column c0, row c1), clipped at the edges.
// The lines are marked evict-first in L2: nothing reads the output back,
// and without the hint the stores ran no faster than torch.mm's, well
// below the copy rate.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      ".L2::cache_hint [%0, {%2, %3}], [%1], pol;\n}"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// The wgmma descriptor of an X tile, B MN-major ([16 k][n] bf16, a k row
// of n columns contiguous): a k row of 128 bytes (64 columns), 128-byte
// swizzle (layout 1), whose atom is 8 k rows (1024 bytes).  The stride
// byte offset steps to the next 8 k rows; the leading one to the next 64
// columns, which a product of N <= 64 never reads, so it is set to the
// same 1024.  D4 (N 64) and D2 (N 32 or 40) read this layout.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4)
         | static_cast<uint64_t>(1024 >> 4) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

// d = A @ B for one 64-row slab: A (rows of S) from registers, B from the
// X tile (MN-major: imm-trans-b 1), d not read (scale-d 0)
__device__ __forceinline__ void wgmma_slab(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(0));
}

// the accumulators are written by the asynchronous product: their uses
// must follow the wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__global__ void __launch_bounds__(kD4Threads, 1)
dot_batched_bf16(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap omap,
                 const unsigned short* __restrict__ s, int tiles,
                 long long n) {
  extern __shared__ __align__(1024) unsigned char d4_smem[];
  // 1024-byte alignment for the swizzle atoms: [staged tiles][X ring]
  // [full barriers][empty barriers]
  const uint32_t raw = smem_u32(d4_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = d4_smem + (base - raw);
  const uint32_t xs = base + kD4OutBufs * kD4OutBytes;
  const uint32_t full = xs + kD4Stages * kD4XBytes;
  const uint32_t empty = full + 8 * kD4Stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kD4Stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                                // producer
    if (lane == 0) {
      for (int i = 0, tile = blockIdx.x; tile < tiles;
           ++i, tile += gridDim.x) {
        const int st = i % kD4Stages;
        mbar_wait(empty + 8 * st, ((i / kD4Stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, kD4XBytes);
        tma_load_2d(xs + st * kD4XBytes, &xmap, full + 8 * st,
                    tile * kD4Cols, 0);
      }
    }
    return;
  }

  // consumer warpgroup: warp w holds rows 16w .. 16w + 15 of each slab
  uint32_t a[4][4];
#pragma unroll
  for (int slab = 0; slab < 4; ++slab) load_a(a[slab], s, 4 * slab + warp,
                                              lane);
  float d[4][32];
#pragma unroll
  for (int slab = 0; slab < 4; ++slab)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[slab][i] = 0.f;
  const int q = lane & 3;
  for (int i = 0, tile = blockIdx.x; tile < tiles; ++i, tile += gridDim.x) {
    const int st = i % kD4Stages;
    mbar_wait(full + 8 * st, (i / kD4Stages) & 1);
    const uint64_t bdesc = x_desc(xs + st * kD4XBytes);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int slab = 0; slab < 4; ++slab) wgmma_slab(d[slab], a[slab], bdesc);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int slab = 0; slab < 4; ++slab) fence_acc(d[slab]);
    mbar_arrive(empty + 8 * st);                  // X tile consumed

    // the staged buffer's last store (tile i - kD4OutBufs) must have read it
    const int buf = i % kD4OutBufs;
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;"
                   :: "n"(kD4OutBufs - 1) : "memory");
    asm volatile("bar.sync 1, 128;" ::: "memory");
    // C fragment: d[4j + e] at row 16 warp + lane / 4 (+ 8 for e >= 2),
    // column 8j + 2q (+ 1 for odd e); the [256, 32] box of column half
    // j / 4 keeps 16-byte chunk c of row r at chunk c ^ (r & 7)
    unsigned char* out = sm + buf * kD4OutBytes;
#pragma unroll
    for (int slab = 0; slab < 4; ++slab) {
      const int row = 64 * slab + 16 * warp + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int chunk = 2 * (j & 3) + (q >> 1);
        unsigned char* p = out + (j >> 2) * kD4Box + row * 128
                           + ((chunk ^ (row & 7)) << 4) + (q & 1) * 8;
        *reinterpret_cast<float2*>(p) =
            make_float2(d[slab][4 * j], d[slab][4 * j + 1]);
        *reinterpret_cast<float2*>(p + 8 * 128) =
            make_float2(d[slab][4 * j + 2], d[slab][4 * j + 3]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (threadIdx.x == 0) {
      const int c0 = tile * kD4Cols;
      const uint32_t src = base + buf * kD4OutBytes;
      tma_store_2d(&omap, src, c0, 0);
      if (c0 + 32 < n) tma_store_2d(&omap, src + kD4Box, c0 + 32, 0);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// D2: STEPS steps of [256, 16] @ [16, LB] in bf16 on the tensor cores
// (wgmma), the f32 running sum [256][lb] in registers throughout; see the
// design note at the top.  Block b owns the 8-column units b * units /
// blocks .. (b + 1) * units / blocks - 1 (rounded down), at most kD2Units.
constexpr int kD2Steps = 8;                       // steps of X a stage
constexpr int kD2Stages = 4;                      // stages in the ring
constexpr int kD2Units = 5;                       // most units of a block
constexpr int kD2Rows = 16 * kD2Steps;            // X rows of a stage
constexpr int kD2Stage = kD2Rows * 128;           // a [128, 64] bf16 box
constexpr int kD2Threads = 128 + 32;              // + the producer warp
constexpr int kD2Smem = kD2Stages * kD2Stage + 2 * kD2Stages * 8 + 1024;

// d += A @ B for one 64-row slab over N = 32 or 40 columns (m64nNk16): A
// (rows of S) from registers, B from the X ring (MN-major: imm-trans-b 1),
// d read (scale-d 1)
template <int N>
__device__ __forceinline__ void wgmma_acc(float (&d)[N / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t bdesc) {
  static_assert(N == 32 || N == 40, "D2 issues m64n32k16 or m64n40k16");
  if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// D2's consumer warpgroup over every stage: the 4 64-row slabs x N
// columns of the block's strip (N = 40 with a fifth unit, else 32; the
// columns past its w_units units hold another block's data or none, and
// are not stored).  A stage's buffer goes back to the producer once the
// products of the next stage are issued and its own are done (wait_group
// 1).  Warp w holds rows 16w .. 16w + 15 of each slab.
template <int N>
__device__ __forceinline__ void d2_consume(const unsigned short* s,
                                           uint32_t ring, uint32_t full,
                                           uint32_t empty, int stages,
                                           float* __restrict__ out, int lb,
                                           int c0, int w_units) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t a[4][4];
  float d[4][N / 2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    load_a(a[i], s, 4 * i + warp, lane);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) d[i][j] = 0.f;
  }
#pragma unroll 1
  for (int i = 0; i < stages; ++i) {
    const int st = i % kD2Stages;
    const uint32_t buf = ring + st * kD2Stage;
    mbar_wait(full + 8 * st, (i / kD2Stages) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_acc(d[j]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
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
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int j = 0; j < 4; ++j) fence_acc(d[j]);
  // C fragment: d[4u + e] at row 16 warp + lane / 4 (+ 8 for e >= 2),
  // column 8u + 2q (+ 1 for odd e) of the strip
  const size_t r8 = static_cast<size_t>(8) * lb;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t row = 64 * j + 16 * warp + (lane >> 2);
    float* o = out + row * lb + c0 + 2 * (lane & 3);
#pragma unroll
    for (int u = 0; u < N / 8; ++u)
      if (u < w_units) {
        *reinterpret_cast<float2*>(o + 8 * u) =
            make_float2(d[j][4 * u], d[j][4 * u + 1]);
        *reinterpret_cast<float2*>(o + r8 + 8 * u) =
            make_float2(d[j][4 * u + 2], d[j][4 * u + 3]);
      }
  }
}

__global__ void __launch_bounds__(kD2Threads, 1)
dot_steps_bf16(const __grid_constant__ CUtensorMap xmap,
               const unsigned short* __restrict__ s, float* __restrict__ out,
               int stages, int units, int lb) {
  extern __shared__ __align__(1024) unsigned char d2_smem[];
  // 1024-byte alignment for the swizzle atoms: [ring][full][empty]
  const uint32_t ring = (smem_u32(d2_smem) + 1023) & ~1023u;
  const uint32_t full = ring + kD2Stages * kD2Stage;
  const uint32_t empty = full + 8 * kD2Stages;
  const long long blocks = gridDim.x;
  const int u0 = static_cast<int>(blockIdx.x * static_cast<long long>(units)
                                  / blocks);
  const int w_units = static_cast<int>((blockIdx.x + 1LL) * units / blocks)
                      - u0;
  const int c0 = 8 * u0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kD2Stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                       // producer
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < stages; ++i) {
        const int st = i % kD2Stages;
        const uint32_t buf = ring + st * kD2Stage;
        mbar_wait(empty + 8 * st, ((i / kD2Stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, kD2Stage);
        tma_load_2d(buf, &xmap, full + 8 * st, c0, i * kD2Rows);
      }
    }
    return;
  }
  if (w_units > 4)
    d2_consume<40>(s, ring, full, empty, stages, out, lb, c0, w_units);
  else
    d2_consume<32>(s, ring, full, empty, stages, out, lb, c0, w_units);
}

// D5: ndots (a multiple of 8) chained products acc = W @ X[(i % 8)
// kKdim :][: kKdim] + acc * 1e-9 over ncw columns a warp; lane l owns
// rows 32 i + l (i < kRowsW / 32), W's in registers, and walks the warp's
// columns one chain at a time.  The 8 dots of one pass over X's slices
// are unrolled; the passes and the columns are not.
constexpr int kDotCols = 9;                   // most columns of a warp

template <int kRowsW, int kKdim>
__global__ void __launch_bounds__(kStepThreads)
dots_chain(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, int ndots, int cols, int ncw) {
  constexpr int kR = kRowsW / 32;
  // columns whose chains run together (a load latency a dot for kG of
  // them): 3 at 8 rows a lane, where one column's 64 FFMA a dot left the
  // warp waiting on its loads
  constexpr int kG = kR >= 8 ? 3 : 1;
  constexpr int kXc = 8 * kKdim;              // X's values of a column
  // a warp's columns of X, in whole groups (the last group's columns
  // past ncw are read, never stored)
  constexpr int kSpan = (kDotCols + kG - 1) / kG * kG;
  __shared__ float4 xs4[kStepWarps * kSpan * kXc / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = reinterpret_cast<float*>(xs4) + warp * kSpan * kXc;
  const int c0 = (blockIdx.x * kStepWarps + warp) * ncw;
  if (c0 >= cols) return;
  const int nc = min(ncw, cols - c0);
  // the warp's columns of X, transposed: [c][8 * kdim]
  for (int i = lane; i < kXc * nc; i += 32) {
    const int r = i / nc, c = i % nc;
    xs[c * kXc + r] = x[static_cast<size_t>(r) * cols + c0 + c];
  }
  float wr[kR][kKdim];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int k = 0; k < kKdim; ++k) wr[i][k] = w[(i * 32 + lane) * kKdim + k];
  __syncwarp();
#pragma unroll 1
  for (int c = 0; c < nc; c += kG) {
    float acc[kG][kR];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[g][i] = 0.f;
#pragma unroll 1
    for (int pass = 0; pass < ndots / 8; ++pass) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float xv[kG][kKdim];
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int k = 0; k < kKdim; k += 4) {
            const float4 v = lds_volatile4(xs + (c + g) * kXc + d * kKdim + k);
            xv[g][k] = v.x;
            xv[g][k + 1] = v.y;
            xv[g][k + 2] = v.z;
            xv[g][k + 3] = v.w;
          }
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            float v = 0.f;
#pragma unroll
            for (int k = 0; k < kKdim; ++k) v = fmaf(wr[i][k], xv[g][k], v);
            acc[g][i] = __fadd_rn(v, __fmul_rn(acc[g][i], 1e-9f));
          }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (c + g < nc)
#pragma unroll
        for (int i = 0; i < kR; ++i)
          out[static_cast<size_t>(i * 32 + lane) * cols + c0 + c + g] =
              acc[g][i];
  }
}

template <typename Kernel>
int launch_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxStaticSmem)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

// the current device's SM count
int sm_count(int* sms) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        sms, cudaDevAttrMultiProcessorCount, dev));
  return rc;
}

template <int kMode, int K, int kC>
int launch_steps(const float* s, const float* x, float* out, int steps,
                 int xk, int lb, cudaStream_t st) {
  const size_t smem = sizeof(float) * StepLayout<kMode, K, kC>::kFloats;
  auto kernel = dot_steps_f32<kMode, K, kC>;
  const int rc = launch_smem(kernel, smem);
  if (rc) return rc;
  const int warps = (lb + kC - 1) / kC;
  kernel<<<(warps + kStepWarps - 1) / kStepWarps, kStepThreads, smem, st>>>(
      s, x, out, steps, xk, lb);
  return 0;
}

// one column a warp while that fills at most one warp a scheduler (LB up
// to 4 x SMs), else kWideCols
template <int kMode, int K>
int launch_steps_c(const float* s, const float* x, float* out, int steps,
                   int xk, int lb, cudaStream_t st) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  return lb <= kStepWarps * sms
             ? launch_steps<kMode, K, 1>(s, x, out, steps, xk, lb, st)
             : launch_steps<kMode, K, kWideCols>(s, x, out, steps, xk, lb,
                                                 st);
}

template <int kMode>
int launch_steps_k(int k, const float* s, const float* x, float* out,
                   int steps, int lb, cudaStream_t st) {
  switch (k) {
    case 8:
      return launch_steps_c<kMode, 8>(s, x, out, steps, k, lb, st);
    case 16:
      return launch_steps_c<kMode, 16>(s, x, out, steps, k, lb, st);
    case 80:
      return launch_steps_c<kMode, 80>(s, x, out, steps, k, lb, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ncw columns a warp: the fewest (at most kDotCols) that need no more
// warps than `chains` a scheduler: one where a lane's 4 or 8 rows feed
// the FFMA pipe, 8 at one row a lane ([32, 8]: a dot is one chain of 8
// FFMA a lane)
template <int kRowsW, int kKdim>
int launch_dots(int ndots, const float* x, const float* w, float* out,
                int cols, cudaStream_t st) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  const int chains = kRowsW >= 128 ? 1 : kRows / kRowsW;
  const int warps_max = kStepWarps * sms * chains;
  const int per = (cols + warps_max - 1) / warps_max;
  const int ncw = per < 1 ? 1 : per > kDotCols ? kDotCols : per;
  const int warps = (cols + ncw - 1) / ncw;
  dots_chain<kRowsW, kKdim><<<(warps + kStepWarps - 1) / kStepWarps,
                              kStepThreads, 0, st>>>(x, w, out, ndots, cols,
                                                     ncw);
  return 0;
}

int last_error(int rc) {
  const int err = static_cast<int>(cudaGetLastError());
  return rc ? rc : err;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda the CUDA runtime
// has loaded (the library links no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `esize`-byte elements, boxes of
// [box_rows, box_cols], 128-byte swizzle.  Returns 0, or
// cudaErrorSharedObjectSymbolNotFound without the driver entry point, or
// kEncodeFailed + the driver's CUresult.
constexpr int kEncodeFailed = 10000;

int tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
                  const void* ptr, long long cols, int rows, int box_cols,
                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

int launch_batched_bf16(const void* s, const void* x, float* out,
                        long long n, cudaStream_t st) {
  alignas(64) CUtensorMap xmap, omap;
  int rc = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, n,
                         16, kD4Cols, 16);
  if (rc == 0)
    rc = tensor_map_2d(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, n,
                       kRows, 32, kRows);
  int sms = 0;
  if (rc == 0) rc = sm_count(&sms);
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        dot_batched_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kD4Smem));
  if (rc) return rc;
  const long long tiles = (n + kD4Cols - 1) / kD4Cols;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  dot_batched_bf16<<<grid, kD4Threads, kD4Smem, st>>>(
      xmap, omap, static_cast<const unsigned short*>(s),
      static_cast<int>(tiles), n);
  return 0;
}

// D2's grid: blocks of 4 units while the card has an SM for each, else
// one block an SM (4 or 5 units), and never more than kD2Units a block
int d2_blocks(int units, int sms) {
  const int by4 = (units + 3) / 4;
  const int least = (units + kD2Units - 1) / kD2Units;
  const int blocks = by4 < sms ? by4 : sms;
  return blocks > least ? blocks : least;
}

// X [steps][16][lb] read as the 2-D [16 steps, lb], one [kD2Rows, 64] box
// a stage from the strip's first column; at 0 steps nothing is read and
// the map stays empty
int launch_steps_bf16(const void* s, const void* x, float* out, int steps,
                      int lb, cudaStream_t st) {
  if (steps > 0x7fffffff / 16) return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap xmap = {};
  const int stages = (steps + kD2Steps - 1) / kD2Steps;
  int rc = 0;
  if (stages > 0)
    rc = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, lb,
                       16 * steps, 64, kD2Rows);
  int sms = 0;
  if (rc == 0) rc = sm_count(&sms);
  if (rc == 0) rc = launch_smem(dot_steps_bf16, kD2Smem);
  if (rc) return rc;
  const int units = lb / 8;
  dot_steps_bf16<<<d2_blocks(units, sms), kD2Threads, kD2Smem, st>>>(
      xmap, static_cast<const unsigned short*>(s), out, stages, units, lb);
  return 0;
}

}  // namespace

extern "C" {

// s [256][k], x [steps][k][lb], out [256][lb] (mode 0, dot) or [64][lb]
// (1 repeat_add, 2 dot_acs), all row-major; dtype 0 f32 (k 8, 16 or 80),
// 1 bf16 (mode dot, k 16; x 16-byte aligned, as the tensor maps need); lb a
// multiple of 16
int dabjax_probe_dot_steps(const void* s, const void* x, void* out, int mode,
                           int dtype, int k, int steps, int lb,
                           void* stream) {
  if (lb <= 0 || lb % kStepCols || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (mode != kDot || k != 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return last_error(launch_steps_bf16(s, x, static_cast<float*>(out), steps,
                                        lb, st));
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const float* sf = static_cast<const float*>(s);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  int rc;
  switch (mode) {
    case kDot:
      rc = launch_steps_k<kDot>(k, sf, xf, o, steps, lb, st);
      break;
    case kRepeatAdd:
      rc = launch_steps_c<kRepeatAdd, 1>(sf, xf, o, steps, k, lb,
                                         st);
      break;
    case kDotAcs:
      rc = launch_steps_k<kDotAcs>(k, sf, xf, o, steps, lb, st);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  return last_error(rc);
}

// s [256][k], x [k][n], out [256][n] f32; dtype 0 f32 (k 8 or 16), 1 bf16
// (k 16; x and out 16-byte aligned, as the tensor maps need); n a
// multiple of 8
int dabjax_probe_dot_batched(const void* s, const void* x, void* out,
                             int dtype, int k, long long n, void* stream) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16) {
    if (k != 16 || n > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    return last_error(launch_batched_bf16(s, x, o, n, st));
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBatchThreads - 1) / kBatchThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* sf = static_cast<const float*>(s);
  const float* xf = static_cast<const float*>(x);
  switch (k) {
    case 8:
      dot_batched_f32<8><<<static_cast<unsigned>(blocks), kBatchThreads, 0,
                           st>>>(sf, xf, o, n);
      break;
    case 16:
      dot_batched_f32<16><<<static_cast<unsigned>(blocks), kBatchThreads, 0,
                            st>>>(sf, xf, o, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return last_error(0);
}

// x [8 * kdim][cols], w [rows][kdim], out [rows][cols], f32;
// (rows, kdim) one of (256, 8), (128, 32), (32, 8); ndots a multiple of 8;
// cols a multiple of 16
int dabjax_probe_dots(const void* x, const void* w, void* out, int rows,
                      int kdim, int ndots, int cols, void* stream) {
  if (cols <= 0 || cols % kStepCols || ndots < 0 || ndots % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  int rc;
  if (rows == 256 && kdim == 8)
    rc = launch_dots<256, 8>(ndots, xf, wf, o, cols, st);
  else if (rows == 128 && kdim == 32)
    rc = launch_dots<128, 32>(ndots, xf, wf, o, cols, st);
  else if (rows == 32 && kdim == 8)
    rc = launch_dots<32, 8>(ndots, xf, wf, o, cols, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  return last_error(rc);
}

}  // extern "C"
