// Hopper probes of the TPU measurement harnesses in tools/: each kernel
// measures on the card the quantity its TPU probe measured there.  Plain
// C interface, loaded with ctypes by the modules of dabjax_torch/tools/;
// every entry point launches on the caller's stream and returns
// cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

// stages of tools/vit_variants2.py (its `mode`)
enum Stage { kDotStore = 0, kRepAdd = 1, kMaxTree = 2, kFullAcs = 3 };

// P1: the radix-4 word forward with stages stripped.  Replaces
// make_kernel in tools/vit_variants2.py, which strips dabjax's
// _forward_kernel (SOFT_FMT "i8": int8 stream, float metrics from
// 0 / -1e9) stage by stage to find what each part of a pair step costs.
// With m[r] = pm[r >> 2] + bm[r] (one round-to-nearest float add) over
// the rows r = e*64 + n:
//   dot_store: bit j of word n = bm[n] > 0; pm is never updated;
//   repadd:    pm[n] <- m[n]; bit j = m[64 + n] > 0;
//   maxtree:   a = max(m00, m10), b = max(m01, m11); pm <- max(a, b);
//              bit j = a > b;
//   full:      K3's selection, e at bits 2j..2j+1, with no mask: every
//              one of the Tp2 pair steps of the zero-padded input counts.
//
// What bounds it on the card: K3's chain of dependent pair steps per
// codeword; each stage adds its own instructions (the branch metrics'
// dp4a, the predecessor shuffles, the float adds and the max tree), which
// is what the probe is for.  Design: K3's, so that the stages cost what they cost
// inside K3: one warp per codeword, lane l holds states l and l + 32,
// predecessors by warp shuffle (8 per pair step for maxtree and full, the
// 4 of the low states for repadd, none for dot_store), soft read 32 pair
// steps at a time, one coalesced 256-byte store per word.  What a stage
// does not need is not computed (the compiler drops dead branch metrics),
// as the TPU probe's stages skip the work after their `continue`.
template <int kStage>
__global__ void __launch_bounds__(128)
forward_words_stage(const int2* __restrict__ soft,   // [B, Tp2] int8x8
                    const int2* __restrict__ signs,  // [256] int8x8
                    int32_t* __restrict__ dec,       // [B, W, 64]
                    int B, int Tp2) {
  const int cw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cw >= B) return;  // whole warps exit together
  const int W = Tp2 / kPairsPerWord;
  const int2* s = soft + static_cast<size_t>(cw) * Tp2;
  int32_t* d = dec + static_cast<size_t>(cw) * W * 64;

  // branch rows e*64 + n: sg[e] for state lane, sg[4 + e] for lane + 32
  int2 sg[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sg[e] = signs[e * 64 + lane];
    sg[4 + e] = signs[e * 64 + 32 + lane];
  }
  float pm_lo = (lane == 0) ? 0.f : -1e9f;  // metric of state lane
  float pm_hi = -1e9f;                      // metric of state lane + 32
  const int q = lane >> 2;
  const int src_a = q, src_b = 16 + q, src_c = 8 + q, src_d = 24 + q;
  constexpr int kWidth = (kStage == kFullAcs) ? 2 : 1;  // bits per slot
  unsigned acc_lo = 0, acc_hi = 0;

  for (int t0 = 0; t0 < Tp2; t0 += 32) {
    const int n = min(32, Tp2 - t0);
    const int2 w = (lane < n) ? s[t0 + lane] : StreamI8::zero();
    for (int j = 0; j < n; ++j) {
      const int2 x = StreamI8::shfl(w, j);
      unsigned v_lo, v_hi;
      if constexpr (kStage == kDotStore) {
        v_lo = StreamI8::bm(x, sg[0]) > 0;
        v_hi = StreamI8::bm(x, sg[4]) > 0;
      } else if constexpr (kStage == kRepAdd) {
        // rows < 128 have predecessors < 32: the low metrics only
        const float a = __shfl_sync(kFull, pm_lo, src_a);
        const float b = __shfl_sync(kFull, pm_lo, src_b);
        const float c = __shfl_sync(kFull, pm_lo, src_c);
        const float dd = __shfl_sync(kFull, pm_lo, src_d);
        v_lo = cand(b, StreamI8::bm(x, sg[1])) > 0.f;
        v_hi = cand(dd, StreamI8::bm(x, sg[5])) > 0.f;
        pm_lo = cand(a, StreamI8::bm(x, sg[0]));
        pm_hi = cand(c, StreamI8::bm(x, sg[4]));
      } else {
        const float a_lo = __shfl_sync(kFull, pm_lo, src_a);
        const float a_hi = __shfl_sync(kFull, pm_hi, src_a);
        const float b_lo = __shfl_sync(kFull, pm_lo, src_b);
        const float b_hi = __shfl_sync(kFull, pm_hi, src_b);
        const float c_lo = __shfl_sync(kFull, pm_lo, src_c);
        const float c_hi = __shfl_sync(kFull, pm_hi, src_c);
        const float d_lo = __shfl_sync(kFull, pm_lo, src_d);
        const float d_hi = __shfl_sync(kFull, pm_hi, src_d);
        const float l00 = cand(a_lo, StreamI8::bm(x, sg[0]));
        const float l01 = cand(b_lo, StreamI8::bm(x, sg[1]));
        const float l10 = cand(a_hi, StreamI8::bm(x, sg[2]));
        const float l11 = cand(b_hi, StreamI8::bm(x, sg[3]));
        const float h00 = cand(c_lo, StreamI8::bm(x, sg[4]));
        const float h01 = cand(d_lo, StreamI8::bm(x, sg[5]));
        const float h10 = cand(c_hi, StreamI8::bm(x, sg[6]));
        const float h11 = cand(d_hi, StreamI8::bm(x, sg[7]));
        if constexpr (kStage == kMaxTree) {
          const float al = fmaxf(l00, l10), bl = fmaxf(l01, l11);
          const float ah = fmaxf(h00, h10), bh = fmaxf(h01, h11);
          pm_lo = fmaxf(al, bl);
          pm_hi = fmaxf(ah, bh);
          v_lo = al > bl;
          v_hi = ah > bh;
        } else {
          bool da_lo, da_hi;
          v_lo = select4(l00, l01, l10, l11, pm_lo, da_lo);
          v_hi = select4(h00, h01, h10, h11, pm_hi, da_hi);
        }
      }
      const int slot = (t0 + j) & (kPairsPerWord - 1);
      acc_lo |= v_lo << (kWidth * slot);
      acc_hi |= v_hi << (kWidth * slot);
      if (slot == kPairsPerWord - 1) {  // Tp2 is whole words
        int32_t* row = d + ((t0 + j) / kPairsPerWord) * 64;
        row[lane] = static_cast<int32_t>(acc_lo);
        row[32 + lane] = static_cast<int32_t>(acc_hi);
        acc_lo = 0;
        acc_hi = 0;
      }
    }
  }
}

// modes of tools/vit_variants.py (its `mode`)
enum PlaneMode { kPlaneFull = 0, kPlaneDotOnly = 1, kPlaneNoAcs = 2 };

// float -> int8 as XLA's astype: truncated toward zero, saturated (a C++
// cast of an out-of-range float is undefined; cvt.rzi saturates to int32)
__device__ __forceinline__ int saturate_i8(float v) {
  return max(-128, min(127, __float2int_rz(v)));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// P4: the per-step-plane forward.  Replaces make_kernel in
// tools/vit_variants.py (modes full, dot_only, no_acs) and make_fwd in
// tools/vit_split.py (full, with its chunk loop unrolled or not): the
// forward of the old float soft format, which stored each pair step's
// branch of every state as one int8 of a [Tp2, 64, Bp] plane instead of
// packing 16 pair steps per word.  With x the pair step's K float soft
// values (K = 16 with ksplit: the 8 of hi = round(s / 256) * 256, then
// the 8 of lo = s - hi, and S4's signs over both halves; else K = 8),
// bm[r] = S4[r] . x and m[r] = pm[r >> 2] + bm[r] (one round-to-nearest
// float add) over the rows r = e*64 + n, the byte of state n at step t
// is:
//   full:     K3's branch e = (d0 << 1) | d1, or 0 for t >= T2; pm from
//             0 / -1e9, carried over every step;
//   dot_only: bm[n] > 0; pm is never updated;
//   no_acs:   m[64 + n] cast to int8 as XLA casts (truncated toward zero,
//             saturated to [-128, 127]); pm[n] <- m[n].
//
// What bounds it on the card: in full, K3's chain of dependent pair steps
// per codeword (8 shuffles, 8 candidates of 8 float multiply-adds, two
// 4-way selections), and now 64 bytes of plane per pair step where K3
// stores 16 bits per state per word: input and plane are 329 MB each at
// the main-path shape (4428 codewords x 1160 steps, K = 16), so dot_only,
// with no chain through pm, is a read and a write of device memory.
// Design: K3's (one warp per codeword, lane l holds states l and l + 32,
// predecessors by warp shuffle, candidates by __fadd_rn, K3's select4).
// The soft values are integers (the probe's input), so hi + lo and every
// partial sum of a branch metric are exact floats: with ksplit the two
// halves are added first (8 adds a step, not 64 more multiply-adds),
// which is the K = 16 dot to the bit.  Per chunk of kC steps the warp
// loads the chunk's kC * K floats, one coalesced float4 a lane, into
// shared memory, reads each step's values from there (a broadcast),
// writes its bytes into a [kC, 64] tile in shared memory and stores the
// tile as coalesced 16-byte runs: kC * 64 contiguous bytes of the
// [B, Tp2, 64] plane, whose [Tp2, 64, B] view the wrapper returns.
// kUnroll unrolls the kC steps of a chunk (the TPU probe's Python loop
// against its fori_loop).
template <int kMode, int kK, int kC, bool kUnroll>
__global__ void __launch_bounds__(128)
forward_plane(const float4* __restrict__ soft,   // [B, Tp2, kK]
              const Float8* __restrict__ signs,  // [256] rows of S4
              int4* __restrict__ plane,          // [B, Tp2, 64] int8
              int B, int Tp2, int T2) {
  constexpr int kWarps = 4;
  constexpr int kIn4 = kC * kK / 4;   // float4s of soft per chunk
  constexpr int kOut16 = kC * 4;      // 16-byte runs of plane per chunk
  __shared__ float4 s_in[kWarps][kIn4];
  __shared__ int4 s_out[kWarps][kOut16];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kWarps + warp;
  if (cw >= B) return;  // whole warps exit together
  const float4* s = soft + static_cast<size_t>(cw) * Tp2 * (kK / 4);
  int4* d = plane + static_cast<size_t>(cw) * Tp2 * 4;
  const float4* xin = s_in[warp];
  int8_t* tile = reinterpret_cast<int8_t*>(s_out[warp]);

  // branch rows e*64 + n: sg[e] for state lane, sg[4 + e] for lane + 32
  Float8 sg[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sg[e] = signs[e * 64 + lane];
    sg[4 + e] = signs[e * 64 + 32 + lane];
  }
  float pm_lo = (lane == 0) ? 0.f : -1e9f;  // metric of state lane
  float pm_hi = -1e9f;                      // metric of state lane + 32
  const int q = lane >> 2;
  const int src_a = q, src_b = 16 + q, src_c = 8 + q, src_d = 24 + q;

  auto step = [&](int t0, int j) {  // pair step t0 + j, row j of the chunk
    const float4* xs = xin + j * (kK / 4);
    Float8 x;
    x.lo = xs[0];
    x.hi = xs[1];
    if constexpr (kK == 16) {  // hi + lo
      x.lo = add4(x.lo, xs[2]);
      x.hi = add4(x.hi, xs[3]);
    }
    int v_lo, v_hi;
    if constexpr (kMode == kPlaneDotOnly) {
      v_lo = StreamF32::bm(x, sg[0]) > 0.f;
      v_hi = StreamF32::bm(x, sg[4]) > 0.f;
    } else if constexpr (kMode == kPlaneNoAcs) {
      // rows < 128 have predecessors < 32: the low metrics only
      const float a = __shfl_sync(kFull, pm_lo, src_a);
      const float b = __shfl_sync(kFull, pm_lo, src_b);
      const float c = __shfl_sync(kFull, pm_lo, src_c);
      const float dd = __shfl_sync(kFull, pm_lo, src_d);
      v_lo = saturate_i8(cand(b, StreamF32::bm(x, sg[1])));
      v_hi = saturate_i8(cand(dd, StreamF32::bm(x, sg[5])));
      pm_lo = cand(a, StreamF32::bm(x, sg[0]));
      pm_hi = cand(c, StreamF32::bm(x, sg[4]));
    } else {
      const float a_lo = __shfl_sync(kFull, pm_lo, src_a);
      const float a_hi = __shfl_sync(kFull, pm_hi, src_a);
      const float b_lo = __shfl_sync(kFull, pm_lo, src_b);
      const float b_hi = __shfl_sync(kFull, pm_hi, src_b);
      const float c_lo = __shfl_sync(kFull, pm_lo, src_c);
      const float c_hi = __shfl_sync(kFull, pm_hi, src_c);
      const float d_lo = __shfl_sync(kFull, pm_lo, src_d);
      const float d_hi = __shfl_sync(kFull, pm_hi, src_d);
      bool da_lo, da_hi;
      const unsigned e_lo = select4(
          cand(a_lo, StreamF32::bm(x, sg[0])),
          cand(b_lo, StreamF32::bm(x, sg[1])),
          cand(a_hi, StreamF32::bm(x, sg[2])),
          cand(b_hi, StreamF32::bm(x, sg[3])), pm_lo, da_lo);
      const unsigned e_hi = select4(
          cand(c_lo, StreamF32::bm(x, sg[4])),
          cand(d_lo, StreamF32::bm(x, sg[5])),
          cand(c_hi, StreamF32::bm(x, sg[6])),
          cand(d_hi, StreamF32::bm(x, sg[7])), pm_hi, da_hi);
      const bool valid = t0 + j < T2;
      v_lo = valid ? static_cast<int>(e_lo) : 0;
      v_hi = valid ? static_cast<int>(e_hi) : 0;
    }
    tile[j * 64 + lane] = static_cast<int8_t>(v_lo);
    tile[j * 64 + 32 + lane] = static_cast<int8_t>(v_hi);
  };

  for (int t0 = 0; t0 < Tp2; t0 += kC) {
    const float4* src = s + static_cast<size_t>(t0) * (kK / 4);
    for (int i = lane; i < kIn4; i += 32) s_in[warp][i] = src[i];
    __syncwarp();
    if constexpr (kUnroll) {
#pragma unroll
      for (int j = 0; j < kC; ++j) step(t0, j);
    } else {
#pragma unroll 1
      for (int j = 0; j < kC; ++j) step(t0, j);
    }
    __syncwarp();
    int4* dst = d + static_cast<size_t>(t0) * 4;
    for (int i = lane; i < kOut16; i += 32) dst[i] = s_out[warp][i];
  }
}

template <int kMode, int kK, int kC>
void launch_plane_unroll(bool unroll, int blocks, cudaStream_t st,
                         const float4* s, const Float8* sg, int4* p, int B,
                         int Tp2, int T2) {
  if (unroll)
    forward_plane<kMode, kK, kC, true><<<blocks, 128, 0, st>>>(s, sg, p, B,
                                                              Tp2, T2);
  else
    forward_plane<kMode, kK, kC, false><<<blocks, 128, 0, st>>>(s, sg, p, B,
                                                               Tp2, T2);
}

template <int kMode, int kK>
void launch_plane_chunk(int chunk, bool unroll, int blocks, cudaStream_t st,
                        const float4* s, const Float8* sg, int4* p, int B,
                        int Tp2, int T2) {
  if (chunk == 8)
    launch_plane_unroll<kMode, kK, 8>(unroll, blocks, st, s, sg, p, B, Tp2,
                                      T2);
  else
    launch_plane_unroll<kMode, kK, 16>(unroll, blocks, st, s, sg, p, B, Tp2,
                                       T2);
}

template <int kMode>
void launch_plane_k(int K, int chunk, bool unroll, int blocks,
                    cudaStream_t st, const float4* s, const Float8* sg,
                    int4* p, int B, int Tp2, int T2) {
  if (K == 8)
    launch_plane_chunk<kMode, 8>(chunk, unroll, blocks, st, s, sg, p, B, Tp2,
                                 T2);
  else
    launch_plane_chunk<kMode, 16>(chunk, unroll, blocks, st, s, sg, p, B,
                                  Tp2, T2);
}

// P2: streaming copy o = x * 1.000001f.  Replaces copy_kernel in
// tools/hbm_probe.py (the copy bandwidth of device memory, in the block
// shape of the Viterbi soft input).
//
// What bounds it on the card: device-memory bandwidth, 8 bytes moved per
// float and one multiply; nothing is read twice and nothing reads the
// output back, so every line a cache keeps is a line wasted.  Design: one
// float4 a thread and nothing else (no loop, no second load in flight in
// the thread: with 20,300 warps' worth of blocks queued, the parallelism
// that hides the memory latency comes from the 2048 resident threads an
// SM, as in the launch shape of torch's own product), neighbouring threads
// on neighbouring float4s; the load is ld.global.nc with
// L1::no_allocate and the store st.global.cs (streaming, evicted first).
// Measured at the probe's shape on an NVIDIA H100 80GB HBM3 at 700 W,
// on a fixed output buffer: 0.2230 ms a call against 0.2243 for torch.mul
// and 0.2267 for the earlier design (4 float4s a thread, plain loads and
// stores, 16 KB a block), medians of 7 runs in turns; through the Python
// wrapper, which allocates its output as torch.mul does, the two are
// within 1 % of each other.  Tried and slower: L2 evict-first
// cache-hint policies on either side (0.2251-0.2260), 2 to 8 float4s a
// thread (0.2238-0.2317), and a bulk-copy pipeline (cp.async.bulk into
// shared memory, the product there, cp.async.bulk out with an evict-first
// hint; 2 to 8 stages of 8 to 32 KB, 1 to 4 blocks an SM: 0.2350-0.2489).
constexpr int kCopyThreads = 256;

__device__ __forceinline__ float4 scale(float4 v) {
  return make_float4(v.x * 1.000001f, v.y * 1.000001f, v.z * 1.000001f,
                     v.w * 1.000001f);
}

__global__ void __launch_bounds__(kCopyThreads)
scale_copy(const float4* __restrict__ x, float4* __restrict__ o,
           size_t n4) {
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kCopyThreads + threadIdx.x;
  if (i >= n4) return;
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(x + i));
  __stcs(o + i, scale(v));
}

// P3: fill of a decision plane.  Replaces dec_kernel in
// tools/hbm_probe.py: every out row t (an int8 plane of `row16` 16-byte
// chunks) holds int8(x[c * (t / c), 0, 0]), the first value of its
// c-row block of x, as the TPU kernel writes each [c, 64, LB] output
// block from its input block's first element (the cost of storing an
// int8 decision plane of the Viterbi shape).
//
// What bounds it on the card: device-memory write bandwidth; the reads
// are one float per block, from cache.  Design: a 2-D grid, blockIdx.y
// the row and blockIdx.x a 4 KB stretch of it, one 16-byte store per
// thread, neighbouring threads on neighbouring chunks; no division on
// the store path.
__global__ void __launch_bounds__(256)
decision_plane(const float* __restrict__ x, int4* __restrict__ out,
               int row_in, int row16, int c) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row16) return;
  const int8_t v = static_cast<int8_t>(
      static_cast<int>(x[static_cast<size_t>(t / c) * c * row_in]));
  const int b = static_cast<int>(static_cast<uint8_t>(v) * 0x01010101u);
  out[static_cast<size_t>(t) * row16 + i] = make_int4(b, b, b, b);
}

}  // namespace

extern "C" {

// stage: 0 dot_store, 1 repadd, 2 maxtree, 3 full; Tp2 a multiple of 16
int dabjax_probe_forward_words_stage(const void* soft, const void* signs,
                                     void* dec, int B, int Tp2, int stage,
                                     void* stream) {
  if (Tp2 % kPairsPerWord != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;                       // 4 codewords per block
  const int blocks = (B + 3) / 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* s = static_cast<const int2*>(soft);
  const int2* sg = static_cast<const int2*>(signs);
  int32_t* d = static_cast<int32_t*>(dec);
  switch (stage) {
    case kDotStore:
      forward_words_stage<kDotStore><<<blocks, threads, 0, st>>>(
          s, sg, d, B, Tp2);
      break;
    case kRepAdd:
      forward_words_stage<kRepAdd><<<blocks, threads, 0, st>>>(
          s, sg, d, B, Tp2);
      break;
    case kMaxTree:
      forward_words_stage<kMaxTree><<<blocks, threads, 0, st>>>(
          s, sg, d, B, Tp2);
      break;
    case kFullAcs:
      forward_words_stage<kFullAcs><<<blocks, threads, 0, st>>>(
          s, sg, d, B, Tp2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// soft: [B, Tp2, K] float (K 8 or 16); signs: [256, 8] float; plane:
// [B, Tp2, 64] int8; mode 0 full, 1 dot_only, 2 no_acs; chunk 8 or 16,
// Tp2 a multiple of it; unroll 0 or 1
int dabjax_probe_forward_plane(const void* soft, const void* signs,
                               void* plane, int B, int Tp2, int T2, int mode,
                               int K, int chunk, int unroll, void* stream) {
  if ((K != 8 && K != 16) || (chunk != 8 && chunk != 16) ||
      Tp2 % chunk != 0 || mode < kPlaneFull || mode > kPlaneNoAcs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + 3) / 4;                // 4 codewords per block
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* s = static_cast<const float4*>(soft);
  const Float8* sg = static_cast<const Float8*>(signs);
  int4* p = static_cast<int4*>(plane);
  const bool u = unroll != 0;
  switch (mode) {
    case kPlaneFull:
      launch_plane_k<kPlaneFull>(K, chunk, u, blocks, st, s, sg, p, B, Tp2,
                                 T2);
      break;
    case kPlaneDotOnly:
      launch_plane_k<kPlaneDotOnly>(K, chunk, u, blocks, st, s, sg, p, B,
                                    Tp2, T2);
      break;
    default:
      launch_plane_k<kPlaneNoAcs>(K, chunk, u, blocks, st, s, sg, p, B, Tp2,
                                  T2);
  }
  return static_cast<int>(cudaGetLastError());
}

// n4: float4s in x and o (both 16-byte aligned)
int dabjax_probe_scale_copy(const void* x, void* o, long long n4,
                            void* stream) {
  const long long per_block = kCopyThreads;
  const long long blocks = (n4 + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0)
    scale_copy<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(o),
        static_cast<size_t>(n4));
  return static_cast<int>(cudaGetLastError());
}

// x: [T, row_in] float; out: [T, 16 * row16] int8 (16-byte aligned);
// T <= 65535, T a multiple of c
int dabjax_probe_decision_plane(const void* x, void* out, int T, int row_in,
                                int row16, int c, void* stream) {
  const int threads = 256;
  const dim3 grid((row16 + threads - 1) / threads, T);
  decision_plane<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int4*>(out), row_in, row16,
      c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
