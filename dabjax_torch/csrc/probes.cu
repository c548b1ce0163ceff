// Hopper probes of the TPU measurement harnesses in tools/: each kernel
// measures on the card the quantity its TPU probe measured there.  Plain
// C interface, loaded with ctypes by the modules of dabjax_torch/tools/;
// every entry point launches on the caller's stream and returns
// cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

// stages of tools/vit_variants2.py (its `mode`) that this kernel runs;
// its fourth, full, is K3 "i8" (viterbi.cu), which the wrapper launches
enum Stage { kDotStore = 0, kRepAdd = 1, kMaxTree = 2 };

// P1: the radix-4 word forward with stages stripped.  Replaces
// make_kernel in tools/vit_variants2.py, which strips dabjax's
// _forward_kernel (SOFT_FMT "i8": int8 stream, float metrics from
// 0 / -1e9) stage by stage to find what each part of a pair step costs.
// With m[r] = pm[r >> 2] + bm[r] (one round-to-nearest float add) over
// the rows r = e*64 + n:
//   dot_store: bit j of word n = bm[n] > 0; pm is never updated;
//   repadd:    pm[n] <- m[n]; bit j = m[64 + n] > 0;
//   maxtree:   a = max(m00, m10), b = max(m01, m11); pm <- max(a, b);
//              bit j = a > b.
// The probe's fourth stage, full (K3's selection with no T2 mask), is
// K3 "i8" itself on the zero-padded input (T2 = Tp2): the wrapper
// launches K3 (viterbi.cu).
//
// What bounds it on the card: a chain of dependent pair steps per
// codeword, one warp a codeword (4428 at the main-path shape, one wave of
// 33 warps an SM), so the instructions a step takes; each stage adds its
// own, which is what the probe is for.  The first design ran K3's
// old float step in every stage, broadcast each pair step's soft by two
// shuffles and placed each bit at a run-time slot.  Design, on K3's
// structure, in tiles of one word (16 pair steps):
//  * Input by cp.async, one 16-byte copy by each of 8 lanes a tile, into
//    a ring of kWsStages tiles in shared memory, kWsStages - 1 tiles
//    ahead; a pair step's 8 soft bytes come back as one broadcast load.
//  * Each stage keeps its float arithmetic (repadd and maxtree carry the
//    -1e9 start), its 16 steps a tile unrolled, so every bit goes to a
//    compile-time slot.
//  * The words of a tile are in the lanes of their states: lanes store
//    states lane and lane + 32 as two 128-byte runs, evict-first.
// Measured at the probe's shape (chip_smoke.py phase 10; NVIDIA H100
// 80GB HBM3, 700 W): dot_store 0.066 ms from 0.147, repadd 0.150 from
// 0.219, maxtree 0.370 from 0.417.
constexpr int kWsWarps = 4;                    // warps (codewords) of a block
constexpr int kWsStages = 4;                   // words of input in the ring

template <int kStage>
__global__ void __launch_bounds__(32 * kWsWarps, 9)
forward_words_stage(const int2* __restrict__ soft,   // [B, Tp2] int8x8
                    const int2* __restrict__ signs,  // [256] int8x8
                    int32_t* __restrict__ dec,       // [B, W, 64]
                    int B, int Tp2) {
  __shared__ __align__(16) int2 ring[kWsWarps][kWsStages][kPairsPerWord];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kWsWarps + warp;
  if (cw >= B) return;  // whole warps exit together
  const int W = Tp2 / kPairsPerWord;
  const int2* s = soft + static_cast<size_t>(cw) * Tp2;
  int32_t* d = dec + static_cast<size_t>(cw) * W * 64;
  const uint32_t ring0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring[warp]));

  // word k of the input into ring slot k % kWsStages (nothing past the
  // last word; the group is committed all the same)
  auto issue = [&](int k) {
    if (k < W && lane < 8)
      cp_async_zfill<16>(ring0 + (k % kWsStages) * 128 + lane * 16,
                         s + k * kPairsPerWord + 2 * lane, true);
    cp_async_commit();
  };
  // word k has landed (every lane's copies) and every lane is done with
  // word k - 1; start word k + kWsStages - 1
  auto begin_word = [&](int k) {
    cp_async_wait<kWsStages - 2>();
    __syncwarp();
    issue(k + kWsStages - 1);
    return ring[warp][k % kWsStages];
  };
  auto store = [&](int k, unsigned a, unsigned b) {
    __stcs(d + k * 64 + lane, static_cast<int32_t>(a));
    __stcs(d + k * 64 + 32 + lane, static_cast<int32_t>(b));
  };

#pragma unroll
  for (int k = 0; k < kWsStages - 1; ++k) issue(k);
  const int q = lane >> 2;
  const int src_a = q, src_b = 16 + q, src_c = 8 + q, src_d = 24 + q;

  // branch rows e*64 + n: sg[e] for state lane, sg[4 + e] for lane + 32
  int2 sg[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sg[e] = signs[e * 64 + lane];
    sg[4 + e] = signs[e * 64 + 32 + lane];
  }
  float pm_lo = (lane == 0) ? 0.f : -1e9f;  // metric of state lane
  float pm_hi = -1e9f;                      // metric of state lane + 32
  for (int k = 0; k < W; ++k) {
    const int2* tile = begin_word(k);
    unsigned acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < kPairsPerWord; ++j) {
      const int2 x = tile[j];                  // broadcast
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
        const float al = fmaxf(l00, l10), bl = fmaxf(l01, l11);
        const float ah = fmaxf(h00, h10), bh = fmaxf(h01, h11);
        pm_lo = fmaxf(al, bl);
        pm_hi = fmaxf(ah, bh);
        v_lo = al > bl;
        v_hi = ah > bh;
      }
      acc_lo |= v_lo << j;
      acc_hi |= v_hi << j;
    }
    store(k, acc_lo, acc_hi);
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
// What bounds it on the card: input and plane are 329 MB each at the
// main-path shape (4428 codewords x 1160 pair steps, K = 16), 0.196 ms
// at 3.35 TB/s; in full also the chain of dependent steps per codeword,
// which on K3's core (one warp a codeword, about 12 instructions a
// trellis step) takes about as long.  The first design (K3's old
// float radix-4 step, 8 shuffles and two 4-way selections a pair step,
// each chunk's input loaded before its steps ran) took 0.99 ms.
// Design, per warp and codeword, in tiles of 16 pair steps (one tile of
// K1's core, kFwTile trellis steps):
//  * Input by cp.async into a ring of kPlStages tiles in shared memory
//    (16-byte copies, zero-filled past Tp2), kPlStages - 1 tiles ahead
//    of the steps, so the next tile is in flight while a tile runs (a
//    ring of 3 or 4 measured no faster: PERF_HISTORY.md).
//  * Output staged: each pair step's 64 bytes go into a [16, 64] tile in
//    shared memory, stored after the tile as whole 16-byte runs with
//    st.global.cs (the plane is written once and never read back); a
//    tile is 1024 contiguous bytes of the [B, Tp2, 64] plane, whose
//    [Tp2, 64, B] view the wrapper returns.  Pair steps >= T2 of full
//    are zeroed there.
//  * full runs K3 "i8"'s arithmetic, exact under the precondition the
//    probe's input meets: every soft value (hi + lo with ksplit) is an
//    integer in [-127, 127] (plane_soft of int8-valued soft bits has
//    hi = 0).  Once a tile, lane j converts trellis step j's four values
//    to int8x4 in shared memory.  Tile 0 (pair steps 0-15) is K3's word
//    0 (k3_word0, acs.cuh): dabjax's radix-4 recursion in float from
//    0 / -1e9, whose rounded start decides the first steps, on int8
//    branch metrics (exact integers, as the float dot of the plain
//    version), into words that the lanes unpack into the tile's bytes.
//    From tile 1 on, K1's in-place core (U16Core, acs.cuh, the code K1
//    and K3 run) on u16x2 metrics relative to state 0 (one exchange
//    shuffle, a DPX maximum and two votes a trellis step), started from
//    tile 0's metrics as K3 starts it: a
//    radix-4 decision is two radix-2 ones once the metrics are exact
//    integers (K3, viterbi.cu).  A pair's two votes become each state's
//    byte as K3's pack makes its word bits (plane_pack_pair): d1 and d0
//    fetched from their rotated positions by funnel rotations, to bits
//    0 and 1.
//  * dot_only and no_acs keep float arithmetic (no_acs's float chain of
//    4 shuffles a pair step, its cast as XLA casts) on the same ring and
//    staging.  Once a tile, lane j writes the 16 signed sums of trellis
//    step j's four values (hi + lo with ksplit) into a table in shared
//    memory; a row's branch metric is then two table loads at the row's
//    sign patterns and one add, where a dot of 8 took 8 multiply-adds
//    and every lane read and added the step's 16 floats.  The sums are
//    exact on integer-valued input, as the plain version's.
// Measured at the main-path shape (chip_smoke.py phase 10, variants in
// PERF_HISTORY.md; NVIDIA H100 80GB HBM3, 700 W): full 0.352 ms
// from 0.993, 0.276 without the byte pack; dot_only 0.269 from 0.328,
// 1.37x its byte bound: its reads alone take 0.200 ms and its writes
// alone 0.227, neither stream near the copy's 2.9 TB/s with one tile in
// flight a warp (a deeper ring does not fit beside the table at nine
// blocks an SM; an L2 bulk prefetch of later tiles was slower); no_acs
// 0.337 from 0.462.
// Knobs: the tile is 16 pair steps whatever `chunk` (Tp2, a multiple of
// the chunk, is what the chunk still sets); kUnroll unrolls the pair-step
// loop of a tile in dot_only and no_acs, and changes nothing in full
// (K1's core is always unrolled, its lane rotation known at compile
// time; word 0 is K3's rolled loop).
constexpr int kPlWarps = 4;                    // warps (codewords) of a block
constexpr int kPlPairs = kFwTile / 2;          // pair steps of a tile
constexpr int kPlStages = 2;                   // tiles of input in the ring

// four integer-valued floats as int8x4 (byte k = value k)
__device__ __forceinline__ int pack_i8x4(float4 v) {
  const int a = __float2int_rn(v.x), b = __float2int_rn(v.y);
  const int c = __float2int_rn(v.z), d = __float2int_rn(v.w);
  return static_cast<int>(
      __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                  0x5410));
}

// The bytes e = (d0 << 1) | d1 of states lane (e_a) and lane + 32 (e_b)
// at pair jp of a tile from its two vote words (w1: step 2jp + 1, word
// lane & 1; w0: step 2jp, word (lane >> 1) & 1): k3_pack_pair's fetch
// (acs.cuh) with d1 rotated to bit 0 and d0 to bit 1 in place of bits
// 2jp and 2jp + 1.
__device__ __forceinline__ void plane_pack_pair(unsigned w1, unsigned w0,
                                                int jp,
                                                const int (&p1)[kFwPhases],
                                                const int (&p0)[kFwPhases],
                                                unsigned& e_a,
                                                unsigned& e_b) {
  const int ph1 = (2 * jp + 1) % kFwPhases, ph0 = (2 * jp) % kFwPhases;
  const int c = 4 - ph0;                           // d1's bit in q >> 1
  const int s1 = 16 >> ph1;                        // rotr5(16, ph1)
  const int s0 = rotl5(8, -ph0);                   // rotr5(8, ph0)
  const unsigned ta = rotr32(w1, p1[ph1]);         // d1 of lane at bit 0
  const unsigned tb = rotr32(ta, s1);              // of lane + 32
  const unsigned ya = rotr32(w0, ((ta & 1u) << c) + p0[ph0] - 1);
  const unsigned yb = rotr32(w0, ((tb & 1u) << c) + p0[ph0] + s0 - 1);
  e_a = (ta & 1u) | (ya & 2u);
  e_b = (tb & 1u) | (yb & 2u);
}

template <int kMode, int kK, bool kUnroll>
__global__ void __launch_bounds__(32 * kPlWarps, 9)
forward_plane(const float4* __restrict__ soft,     // [B, Tp2, kK]
              const int2* __restrict__ signs,      // [256] int8x8 rows of S4
              const int32_t* __restrict__ bsigns,  // [32] K1's butterfly
              int4* __restrict__ plane,            // [B, Tp2, 64] int8
              int B, int Tp2, int T2) {
  constexpr int kRow4 = kK / 4;                 // float4s of a pair step
  constexpr int kTile4 = kPlPairs * kRow4;      // float4s of a tile
  constexpr bool kIsFull = kMode == kPlaneFull;
  // the tile's trellis steps once prepared by lane: full, int8x4 words
  // (and word 0's 64 words); dot_only and no_acs, the table of each
  // step's 16 signed sums (rows of 17 floats: no bank conflicts)
  constexpr int kPrep = kIsFull ? kFwTile + 64 : kFwTile * 17;
  __shared__ __align__(16) float4 ring[kPlWarps][kPlStages][kTile4];
  __shared__ __align__(16) int4 stage[kPlWarps][kPlPairs * 4];
  __shared__ __align__(16) int32_t prep[kPlWarps][kPrep];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kPlWarps + warp;
  if (cw >= B) return;  // whole warps exit together
  const float4* s = soft + static_cast<size_t>(cw) * Tp2 * kRow4;
  int4* d = plane + static_cast<size_t>(cw) * Tp2 * 4;
  const int tiles = (Tp2 + kPlPairs - 1) / kPlPairs;
  const uint32_t ring0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring[warp]));
  int8_t* out = reinterpret_cast<int8_t*>(stage[warp]);

  // tile k of the input into ring slot k % kPlStages (nothing past the
  // last tile; the group is committed all the same)
  auto issue = [&](int k) {
    if (k < tiles) {
      const uint32_t slot = ring0 + (k % kPlStages) * kTile4 * 16;
#pragma unroll
      for (int i = lane; i < kTile4; i += 32) {
        const bool valid = k * kPlPairs + i / kRow4 < Tp2;
        const float4* src = s + static_cast<size_t>(k) * kTile4 + i;
        cp_async_zfill<16>(slot + i * 16, valid ? src : s, valid);
      }
    }
    cp_async_commit();
  };
  // tile k has landed (every lane's copies), every lane is done with
  // tile k - 1 and its staged bytes; start tile k + kPlStages - 1
  auto begin_tile = [&](int k) {
    cp_async_wait<kPlStages - 2>();
    __syncwarp();
    issue(k + kPlStages - 1);
    return ring[warp][k % kPlStages];
  };
  // lane j's trellis step j of a tile: its four values (hi + lo with
  // ksplit: exact for integer values)
  auto step_soft = [&](const float4* tile) {
    const float4* r = tile + (lane >> 1) * kRow4 + (lane & 1);
    return kK == 16 ? add4(r[0], r[2]) : r[0];
  };
  // the staged bytes of tile k: rows below Tp2 stored, full's rows at
  // or past T2 as 0
  auto end_tile = [&](int k) {
    __syncwarp();
    const int rows = min(kPlPairs, Tp2 - k * kPlPairs);
    const int live = kIsFull ? T2 - k * kPlPairs : kPlPairs;
    int4* dst = d + static_cast<size_t>(k) * kPlPairs * 4;
#pragma unroll
    for (int i = lane; i < kPlPairs * 4; i += 32) {
      const int row = i >> 2;
      if (row < rows)
        __stcs(dst + i, row < live ? stage[warp][i] : make_int4(0, 0, 0, 0));
    }
  };

#pragma unroll
  for (int k = 0; k < kPlStages - 1; ++k) issue(k);

  if constexpr (!kIsFull) {
    // a row's branch metric from its sign patterns (pa, pb: bit k set
    // where sign k of the pair's first or second trellis step is -1) as
    // the sum of two entries of a table of each trellis step's 16 signed
    // sums of its four values; rows lane and lane + 32 (dot_only), lane,
    // 64 + lane and 96 + lane (no_acs; state lane + 32 is no predecessor
    // of a row < 128)
    auto pattern = [](int w) {
      return ((w >> 7) & 1) | ((w >> 14) & 2) | ((w >> 21) & 4) |
             ((w >> 28) & 8);
    };
    constexpr int kRows = kMode == kPlaneDotOnly ? 2 : 3;
    int pa[kRows], pb[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = i == 0 ? 0 : kMode == kPlaneDotOnly ? 32 : 32 + 32 * i;
      const int2 v = signs[row + lane];
      pa[i] = pattern(v.x);
      pb[i] = pattern(v.y);
    }
    float(*tb)[17] = reinterpret_cast<float(*)[17]>(prep[warp]);
    const int q = lane >> 2;
    float pm_lo = (lane == 0) ? 0.f : -1e9f;  // metric of state lane
    for (int k = 0; k < tiles; ++k) {
      {  // lane j: the 16 signed sums of trellis step j (exact integers)
        const float4 x = step_soft(begin_tile(k));
        const float s01[4] = {x.x + x.y, x.y - x.x, x.x - x.y, -x.x - x.y};
        const float s23[4] = {x.z + x.w, x.w - x.z, x.z - x.w, -x.z - x.w};
#pragma unroll
        for (int p = 0; p < 16; ++p) tb[lane][p] = s01[p & 3] + s23[p >> 2];
      }
      __syncwarp();
      auto step = [&](int j) {
        auto bm = [&](int i) { return tb[2 * j][pa[i]] + tb[2 * j + 1][pb[i]]; };
        int v_lo, v_hi;
        if constexpr (kMode == kPlaneDotOnly) {
          v_lo = bm(0) > 0.f;
          v_hi = bm(1) > 0.f;
        } else {
          // rows < 128 have predecessors < 32: the low metrics only
          const float a = __shfl_sync(kFull, pm_lo, q);
          const float b = __shfl_sync(kFull, pm_lo, 16 + q);
          const float dd = __shfl_sync(kFull, pm_lo, 24 + q);
          v_lo = saturate_i8(cand(b, bm(1)));
          v_hi = saturate_i8(cand(dd, bm(2)));
          pm_lo = cand(a, bm(0));
        }
        out[j * 64 + lane] = static_cast<int8_t>(v_lo);
        out[j * 64 + 32 + lane] = static_cast<int8_t>(v_hi);
      };
      if constexpr (kUnroll) {
#pragma unroll
        for (int j = 0; j < kPlPairs; ++j) step(j);
      } else {
#pragma unroll 1
        for (int j = 0; j < kPlPairs; ++j) step(j);
      }
      end_tile(k);
    }
  } else {
    int32_t* xs = prep[warp];                 // the tile's int8x4 steps
    int32_t* words0 = prep[warp] + kFwTile;   // word 0's 64 words
    // tile 0: K3 "i8"'s word 0, dabjax's radix-4 recursion in float from
    // 0 / -1e9 on int8 branch metrics (k3_word0, acs.cuh), into words,
    // then unpacked to the tile's bytes
    float pm_lo, pm_hi;
    {
      xs[lane] = pack_i8x4(step_soft(begin_tile(0)));
      __syncwarp();
      bool da0;
      k3_word0<float, StreamI8>(reinterpret_cast<const int2*>(xs), signs,
                                words0, kPlPairs, -1e9f, lane, pm_lo,
                                pm_hi, da0);
      const unsigned a = words0[lane], b = words0[32 + lane];
#pragma unroll
      for (int j = 0; j < kPlPairs; ++j) {
        out[j * 64 + lane] = static_cast<int8_t>((a >> (2 * j)) & 3u);
        out[j * 64 + 32 + lane] = static_cast<int8_t>((b >> (2 * j)) & 3u);
      }
      end_tile(0);
    }
    if (tiles == 1) return;

    // K1's core (U16Core, acs.cuh) from tile 0's metrics, as K3 starts it
    U16Core core;
    core.init(bsigns, lane);
    int p1[kFwPhases], p0[kFwPhases];
    k3_pack_positions(lane, p1, p0);
    core.start(pm_lo, pm_hi, lane);
    for (int k = 1; k < tiles; ++k) {
      xs[lane] = pack_i8x4(step_soft(begin_tile(k)));
      __syncwarp();
      if (k > 1) core.renorm();
      core.tile(xs, lane, [](int, unsigned, unsigned) {},
                [&](int jp, unsigned w1, unsigned w0) {
                  // pair jp's bytes as soon as its two steps are voted
                  unsigned e_a, e_b;
                  plane_pack_pair(w1, w0, jp, p1, p0, e_a, e_b);
                  out[jp * 64 + lane] = static_cast<int8_t>(e_a);
                  out[jp * 64 + 32 + lane] = static_cast<int8_t>(e_b);
                });
      end_tile(k);
    }
  }
}

template <int kMode, int kK, bool kUnroll>
void launch_plane(int blocks, cudaStream_t st, const float4* s,
                  const int2* sg, const int32_t* bs, int4* p, int B,
                  int Tp2, int T2) {
  // nine blocks of up to 21 KB an SM: ask for the shared-memory carveout
  cudaFuncSetAttribute(forward_plane<kMode, kK, kUnroll>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  forward_plane<kMode, kK, kUnroll><<<blocks, 32 * kPlWarps, 0, st>>>(
      s, sg, bs, p, B, Tp2, T2);
}

template <int kMode, int kK>
void launch_plane_unroll(bool unroll, int blocks, cudaStream_t st,
                         const float4* s, const int2* sg, const int32_t* bs,
                         int4* p, int B, int Tp2, int T2) {
  if constexpr (kMode == kPlaneFull)  // its one rolled loop: word 0's
    launch_plane<kMode, kK, false>(blocks, st, s, sg, bs, p, B, Tp2, T2);
  else if (unroll)
    launch_plane<kMode, kK, true>(blocks, st, s, sg, bs, p, B, Tp2, T2);
  else
    launch_plane<kMode, kK, false>(blocks, st, s, sg, bs, p, B, Tp2, T2);
}

template <int kMode>
void launch_plane_k(int K, bool unroll, int blocks, cudaStream_t st,
                    const float4* s, const int2* sg, const int32_t* bs,
                    int4* p, int B, int Tp2, int T2) {
  if (K == 8)
    launch_plane_unroll<kMode, 8>(unroll, blocks, st, s, sg, bs, p, B, Tp2,
                                  T2);
  else
    launch_plane_unroll<kMode, 16>(unroll, blocks, st, s, sg, bs, p, B, Tp2,
                                   T2);
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
// int8 decision plane of the Viterbi shape).  The cast is XLA's:
// truncated toward zero and saturated, NaN to 0 (cvt.rzi gives 0 for NaN
// and saturates at +-inf; the clamp does the rest).
//
// What bounds it on the card: device-memory write bandwidth; the reads
// are one float per block, from cache.  Design: a 2-D grid, blockIdx.y
// the row and blockIdx.x a 4 KB stretch of it, one 16-byte store per
// thread by st.global.cs (streaming, evicted first), neighbouring
// threads on neighbouring chunks; no division on the store path.  On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF_HISTORY.md): with a plain store
// the kernel ran 9 % behind one fill_ of the plane; with .cs it is
// within 0.2 % of fill_ by device time, and 2 % behind by events, which
// also count the host's issue of the first call through the wrapper.
__global__ void __launch_bounds__(256)
decision_plane(const float* __restrict__ x, int4* __restrict__ out,
               int row_in, int row16, int c) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row16) return;
  const int b = max(-128, min(127, __float2int_rz(
      x[static_cast<size_t>(t / c) * c * row_in])));
  const int w = static_cast<int>((static_cast<unsigned>(b) & 0xffu)
                                 * 0x01010101u);
  __stcs(out + static_cast<size_t>(t) * row16 + i, make_int4(w, w, w, w));
}

}  // namespace

extern "C" {

// soft: [B, Tp2] int8x8 (16-byte aligned); signs: [256] int8x8; dec:
// [B, Tp2 / 16, 64]; stage: 0 dot_store, 1 repadd, 2 maxtree; Tp2 a
// positive multiple of 16
int dabjax_probe_forward_words_stage(const void* soft, const void* signs,
                                     void* dec, int B, int Tp2, int stage,
                                     void* stream) {
  if (Tp2 <= 0 || Tp2 % kPairsPerWord != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWsWarps - 1) / kWsWarps;
  const int threads = 32 * kWsWarps;
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// soft: [B, Tp2, K] float (K 8 or 16, 16-byte aligned); signs: [256]
// int8x8 (S4's rows); bsigns: [32] int8x4 (K1's butterfly signs); plane:
// [B, Tp2, 64] int8 (16-byte aligned); mode 0 full, 1 dot_only, 2 no_acs;
// unroll 0 or 1 (full: no effect)
int dabjax_probe_forward_plane(const void* soft, const void* signs,
                               const void* bsigns, void* plane, int B,
                               int Tp2, int T2, int mode, int K, int unroll,
                               void* stream) {
  if ((K != 8 && K != 16) || Tp2 <= 0 || mode < kPlaneFull ||
      mode > kPlaneNoAcs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kPlWarps - 1) / kPlWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* s = static_cast<const float4*>(soft);
  const int2* sg = static_cast<const int2*>(signs);
  const int32_t* bs = static_cast<const int32_t*>(bsigns);
  int4* p = static_cast<int4*>(plane);
  const bool u = unroll != 0;
  switch (mode) {
    case kPlaneFull:
      launch_plane_k<kPlaneFull>(K, u, blocks, st, s, sg, bs, p, B, Tp2, T2);
      break;
    case kPlaneDotOnly:
      launch_plane_k<kPlaneDotOnly>(K, u, blocks, st, s, sg, bs, p, B, Tp2,
                                    T2);
      break;
    default:
      launch_plane_k<kPlaneNoAcs>(K, u, blocks, st, s, sg, bs, p, B, Tp2,
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
