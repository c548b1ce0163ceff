// Viterbi decoder kernels for the DAB K=7, rate-1/4 convolutional code
// on Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// dabjax_torch/fec/viterbi_cuda.py; every entry point launches on the
// caller's stream and returns cudaGetLastError() of its launch.
//
// Conventions are those of dabjax/fec/viterbi.py::viterbi_decode_np:
// state = last 6 data bits (newest in the LSB), register value
// r = (state << 1) | bit, new state n has predecessors n >> 1 (branch 0,
// r = n) and (n >> 1) | 32 (branch 1, r = n | 64); the branch metric of r
// is sum_k soft[t, k] * signs[r, k]; selection is strict '>' so ties keep
// branch 0; the traceback starts at state 0 after the 6 tail bits.
//
// Soft values are integers in [-127, 127] (the demod's rounded soft-bit
// contract), so int8 inputs and int32 path metrics are exact: the largest
// metric growth is 508 per step, 4.7e6 over the 9222 steps of a
// 384 kbit/s subchannel, far inside int32 with the -2^29 start of the
// states other than 0 (no renormalisation needed).

#include <cstdint>
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

// K1: forward add-compare-select.  Replaces _forward_kernel_lane in
// dabjax/fec/viterbi_pallas.py (radix-4 ACS, 16 pair steps per packed
// decision word, batch on TPU lanes).
//
// What bounds it on the card: each codeword is a sequential chain of T
// dependent steps, and each step is integer issue (4 dp4a, 4 shuffles,
// 2 compare-selects, 2 ballots per lane) plus 8 bytes of decisions.
// Design: one warp per codeword, so the 64 states of a step live in the
// registers of one warp (lane l holds states l and l + 32) and the
// predecessor exchange is 4 warp shuffles, with no shared memory and no
// barriers.  The step's 4 int8 soft values arrive as one int32, and each
// branch metric is one __dp4a against the register value's packed +-1
// signs.  Soft words are read 32 steps at a time, one coalesced 128-byte
// load per warp, and broadcast by shuffle; the 64 decisions of a step are
// two __ballot_sync words, kept in the lane of that step and written as
// one coalesced 256-byte store per 32 steps.  Throughput comes from
// thousands of codewords in flight (4428 warps at the full-ensemble MSC
// shape), not from parallelism inside the chain.
__global__ void __launch_bounds__(128)
forward_acs(const int32_t* __restrict__ soft,   // [B, T] packed int8x4
            const int32_t* __restrict__ signs,  // [128] packed int8x4 +-1
            uint2* __restrict__ dec,            // [B, T] decision words
            int B, int T) {
  const int cw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cw >= B) return;  // whole warps exit together
  const int32_t* s = soft + static_cast<size_t>(cw) * T;
  uint2* d = dec + static_cast<size_t>(cw) * T;

  // branch signs of the four register values this lane scores
  const int sg_lo0 = signs[lane];        // state lane,      branch 0
  const int sg_lo1 = signs[lane | 64];   // state lane,      branch 1
  const int sg_hi0 = signs[lane + 32];   // state lane + 32, branch 0
  const int sg_hi1 = signs[lane + 96];   // state lane + 32, branch 1
  int pm_lo = (lane == 0) ? 0 : -(1 << 29);  // metric of state lane
  int pm_hi = -(1 << 29);                    // metric of state lane + 32
  // predecessors: states lane >> 1 and (lane >> 1) | 32 sit in lane
  // lane >> 1; those of state lane + 32 in lane 16 + (lane >> 1)
  const int src_a = lane >> 1;
  const int src_b = 16 + (lane >> 1);

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int n = min(32, T - t0);
    const int w = (lane < n) ? s[t0 + lane] : 0;
    unsigned keep_lo = 0, keep_hi = 0;
    for (int j = 0; j < n; ++j) {
      const int x = __shfl_sync(kFull, w, j);
      const int a_lo = __shfl_sync(kFull, pm_lo, src_a);
      const int a_hi = __shfl_sync(kFull, pm_hi, src_a);
      const int b_lo = __shfl_sync(kFull, pm_lo, src_b);
      const int b_hi = __shfl_sync(kFull, pm_hi, src_b);
      const int m0 = a_lo + __dp4a(x, sg_lo0, 0);
      const int m1 = a_hi + __dp4a(x, sg_lo1, 0);
      const int m2 = b_lo + __dp4a(x, sg_hi0, 0);
      const int m3 = b_hi + __dp4a(x, sg_hi1, 0);
      const bool d_lo = m1 > m0;
      const bool d_hi = m3 > m2;
      pm_lo = d_lo ? m1 : m0;
      pm_hi = d_hi ? m3 : m2;
      const unsigned bl = __ballot_sync(kFull, d_lo);
      const unsigned bh = __ballot_sync(kFull, d_hi);
      if (lane == j) {
        keep_lo = bl;
        keep_hi = bh;
      }
    }
    if (lane < n) d[t0 + lane] = make_uint2(keep_lo, keep_hi);
  }
}

// K2: traceback plus bit emission.  Replaces _traceback_kernel in
// dabjax/fec/viterbi_pallas.py and the unpack epilogue of
// viterbi_decode_pallas (which recovered bits from the radix-4 branch
// sequence); with radix-2 decisions the decoded bit of step t is the
// state's LSB, as in viterbi_decode_np.
//
// What bounds it on the card: the bytes are T 8-byte decision words in
// and nbits int32 bits out per codeword (0.0244 ms at the MSC shape, 4428
// codewords x 2310 steps), but each codeword is a chain of T dependent
// steps (the state picks the decision bit of the next step), so the
// chain's latency is the limit: about 25 cycles a step.
// Design: a warp owns kTbCw = 16 codewords and a block of two warps 32, so
// the 4428 MSC codewords are 139 blocks, one on each SM (seven take two),
// each with two warps on two of the SM's four schedulers.  With one warp of
// 32 codewords an SM, every copy, shuffle and store of a tile waited out its
// own latency and the kernel ran at several times the chain's time; 16
// codewords a warp measured faster than 8 or 4.  A warp walks backwards in
// tiles of 32 steps whose edges are multiples of 32 in t.  A tile's
// decisions, 16 rows of 256 contiguous bytes, are copied into shared memory
// by coalesced cp.async (16 bytes a copy when every row is 16-byte aligned,
// i.e. T even; 8 bytes otherwise), kTbStages - 1 tiles ahead of the walk;
// the copies are branch-free (cp.async zero-fills what it does not copy).
// Each lane then loads its row's 32 words into registers (compile-time
// indices; lanes l and l + 16 share row l % 16), so the chain of a step is a
// select, a shift and two logic ops with no memory access.  A lane gathers
// the tile's 32 bits in one register; the warp transposes them by shuffle
// (lane r's word to every lane) and writes each codeword's 32 bits as one
// 128-byte store (aligned when nbits * 4 is a multiple of 128, as for every
// DAB size).  The top tile, partial when T is not a multiple of 32, is
// zero-filled past T: zero decisions keep the start state 0, so the walk
// needs no guard.  Rows of codewords >= B are zero-filled too; bits t >=
// nbits and codewords >= B are masked at the store.
constexpr int kTbSteps = 32;                  // steps of a tile
constexpr int kTbCw = 16;                     // codewords of a warp
constexpr int kTbWarps = 2;                   // warps of a block
constexpr int kTbStages = 4;                  // tiles in shared memory
constexpr int kTbRow = kTbSteps * 8 + 16;     // bytes of a row (padded)
constexpr int kTbTile = kTbCw * kTbRow;       // bytes of a warp's tile

// cp.async of kBytes, or kBytes of zeros when !valid (src-size 0; src
// must still be a valid address)
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src,
                                               bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Copy the decisions of tile k (steps 32k .. 32k + 31) of codewords
// cw0 .. cw0 + kTbCw - 1 into the shared tile at `tile`, zeros past T and
// for codewords >= B.
template <bool kVec16>
__device__ __forceinline__ void tb_issue(const uint2* __restrict__ dec,
                                         uint32_t tile, int cw0, int B, int T,
                                         int k, int lane) {
  constexpr int kWords = kVec16 ? 2 : 1;       // decision words a copy
  const int j = (lane * kWords) % kTbSteps;    // the lane's step in a row
  const int r0 = lane * kWords / kTbSteps;
  const bool in_t = k * kTbSteps + j < T;      // j + 1 too when kVec16
#pragma unroll
  for (int i = 0; i < kTbCw / kWords; ++i) {  // a warp's copy: kWords rows
    const int r = i * kWords + r0;
    const bool valid = in_t && cw0 + r < B;
    const uint2* src =
        valid ? dec + static_cast<size_t>(cw0 + r) * T + k * kTbSteps + j
              : dec;
    cp_async_zfill<8 * kWords>(tile + r * kTbRow + j * 8, src, valid);
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(32 * kTbWarps)
traceback(const uint2* __restrict__ dec,  // [B, T] decision words
          int32_t* __restrict__ bits,     // [B, nbits]
          int B, int T, int nbits) {
  __shared__ __align__(16) char tiles[kTbWarps][kTbStages][kTbTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cw0 = (blockIdx.x * kTbWarps + warp) * kTbCw;
  if (cw0 >= B) return;                       // whole warps
  const int top = (T - 1) / kTbSteps;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(tiles[warp]));
#pragma unroll 1
  for (int s = 0; s < kTbStages - 1; ++s) {
    if (top - s >= 0)
      tb_issue<kVec16>(dec, base + (top - s) % kTbStages * kTbTile, cw0, B,
                       T, top - s, lane);
    cp_async_commit();                        // one group a tile, maybe empty
  }
  int state = 0;
  for (int k = top; k >= 0; --k) {
    const int kn = k - (kTbStages - 1);       // its buffer was read at k + 1
    if (kn >= 0)
      tb_issue<kVec16>(dec, base + kn % kTbStages * kTbTile, cw0, B, T, kn,
                       lane);
    cp_async_commit();
    cp_async_wait<kTbStages - 1>();           // tile k has landed
    __syncwarp();
    const char* row =
        tiles[warp][k % kTbStages] + (lane % kTbCw) * kTbRow;
    uint2 w[kTbSteps];
#pragma unroll
    for (int j = 0; j < kTbSteps; ++j)
      w[j] = *reinterpret_cast<const uint2*>(row + j * 8);
    __syncwarp();                             // the buffer may be refilled
    unsigned mask = 0;
#pragma unroll
    for (int j = kTbSteps - 1; j >= 0; --j) {
      mask |= static_cast<unsigned>(state & 1) << j;
      const unsigned word = (state & 32) ? w[j].y : w[j].x;
      state = (state >> 1) |
              static_cast<int>(((word >> (state & 31)) & 1u) << 5);
    }
    const int t = k * kTbSteps + lane;
#pragma unroll
    for (int r = 0; r < kTbCw; ++r) {
      const unsigned m = __shfl_sync(kFull, mask, r);
      if (cw0 + r < B && t < nbits)
        bits[static_cast<size_t>(cw0 + r) * nbits + t] =
            static_cast<int32_t>((m >> lane) & 1u);
    }
  }
}

// ---------------------------------------------------------------------
// Radix-4 decision words: the layout of dabjax's viterbi_forward_words
// (dabjax/fec/viterbi_pallas.py).  Pair step tau joins trellis steps 2tau
// and 2tau+1; for new state n and branch e = (d0 << 1) | d1 the
// predecessor is p = (n >> 2) | (e << 4) and the candidate is
// pm[p] + S4[e*64 + n] . soft[tau] (S4: the 8 +-1 signs of the pair's two
// register values).  The 2-bit e of pair j of word w sits at bits
// 2j..2j+1 of dec[b][w][n]; 16 pair steps per word.  The int8 stream
// (StreamI8), the float stream (StreamF32), the candidate adds and the
// selection are in acs.cuh.

// K3: radix-4 forward ACS emitting decision words.  Replaces
// _forward_kernel in dabjax/fec/viterbi_pallas.py (SOFT_FMT i8mxu: int8
// stream, int32 metrics from 0 / -2^29; i8: int8 stream, float metrics
// from 0 / -1e9; f32: float stream, float metrics from 0 / -1e9).
//
// What bounds it on the card: as K1, a sequential chain per codeword, now
// of T/2 pair steps, each 8 warp shuffles of path metrics, 16 dp4a (or 64
// float multiply-adds), 8 adds and two 4-way selections per lane, and
// one 4-byte decision word per state every 16 pairs.  Design: one warp per
// codeword; lane l holds states l and l + 32.  The four predecessors of
// state l sit in lanes l >> 2 and 16 + (l >> 2), those of l + 32 in lanes
// 8 + (l >> 2) and 24 + (l >> 2), each as a lo (state < 32) and a hi
// metric, so a pair step is 8 shuffles with no shared memory.  Pair
// steps are read 32 at a time, one coalesced load per warp (256 bytes of
// int8 or 1 KB of float), and broadcast by shuffle.  Each lane packs its
// two states' 2-bit branches for 16 pairs and stores them as one word
// each: the 64 words of a codeword's word index are one coalesced
// 256-byte store.  The output layout is [B, W, 64]; the wrapper returns
// it as the [W, 64, B] view of the TPU kernel's output.
//
// Word padding: pair steps >= T2 are never computed, so their slots of
// the last word stay e = 0, which is the TPU kernel's in-loop mask.  The
// lane-0 `da` of the last pair step (state 0's decision at step 2(T2-1))
// goes to last[b]: when T is odd, that is the true last trellis step, and
// the word layout, whose last pair ends on a zero-soft padding step,
// does not keep it when d1 = 1 (see K4).
template <typename M, typename S>
__global__ void __launch_bounds__(128)
forward_acs_words(const typename S::Pair* __restrict__ soft,   // [B, T2]
                  const typename S::Pair* __restrict__ signs,  // [256]
                  int32_t* __restrict__ dec,                   // [B, W, 64]
                  int32_t* __restrict__ last,                  // [B]
                  int B, int T2, M start) {
  using Pair = typename S::Pair;
  const int cw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cw >= B) return;  // whole warps exit together
  const int W = (T2 + kPairsPerWord - 1) / kPairsPerWord;
  const Pair* s = soft + static_cast<size_t>(cw) * T2;
  int32_t* d = dec + static_cast<size_t>(cw) * W * 64;

  // branch rows e*64 + n of the eight candidates this lane scores:
  // sg[e] for state lane, sg[4 + e] for state lane + 32
  Pair sg[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sg[e] = signs[e * 64 + lane];
    sg[4 + e] = signs[e * 64 + 32 + lane];
  }
  M pm_lo = (lane == 0) ? M(0) : start;  // metric of state lane
  M pm_hi = start;                       // metric of state lane + 32
  const int q = lane >> 2;
  const int src_a = q, src_b = 16 + q, src_c = 8 + q, src_d = 24 + q;
  unsigned acc_lo = 0, acc_hi = 0;
  bool da0 = false;

  for (int t0 = 0; t0 < T2; t0 += 32) {
    const int n = min(32, T2 - t0);
    const Pair w = (lane < n) ? s[t0 + lane] : S::zero();
    for (int j = 0; j < n; ++j) {
      const Pair x = S::shfl(w, j);
      // state lane: e=0 p=q, e=1 p=16+q, e=2 p=32+q, e=3 p=48+q
      const M a_lo = __shfl_sync(kFull, pm_lo, src_a);
      const M a_hi = __shfl_sync(kFull, pm_hi, src_a);
      const M b_lo = __shfl_sync(kFull, pm_lo, src_b);
      const M b_hi = __shfl_sync(kFull, pm_hi, src_b);
      // state lane + 32: e=0 p=8+q, e=1 p=24+q, e=2 p=40+q, e=3 p=56+q
      const M c_lo = __shfl_sync(kFull, pm_lo, src_c);
      const M c_hi = __shfl_sync(kFull, pm_hi, src_c);
      const M d_lo = __shfl_sync(kFull, pm_lo, src_d);
      const M d_hi = __shfl_sync(kFull, pm_hi, src_d);
      bool da_lo, da_hi;
      const unsigned e_lo = select4(
          cand(a_lo, S::bm(x, sg[0])), cand(b_lo, S::bm(x, sg[1])),
          cand(a_hi, S::bm(x, sg[2])), cand(b_hi, S::bm(x, sg[3])),
          pm_lo, da_lo);
      const unsigned e_hi = select4(
          cand(c_lo, S::bm(x, sg[4])), cand(d_lo, S::bm(x, sg[5])),
          cand(c_hi, S::bm(x, sg[6])), cand(d_hi, S::bm(x, sg[7])),
          pm_hi, da_hi);
      const int tau = t0 + j;
      const int slot = tau & (kPairsPerWord - 1);
      acc_lo |= e_lo << (2 * slot);
      acc_hi |= e_hi << (2 * slot);
      if (slot == kPairsPerWord - 1 || tau == T2 - 1) {
        int32_t* row = d + (tau / kPairsPerWord) * 64;
        row[lane] = static_cast<int32_t>(acc_lo);
        row[32 + lane] = static_cast<int32_t>(acc_hi);
        acc_lo = 0;
        acc_hi = 0;
      }
      da0 = da_lo;
    }
  }
  if (lane == 0) last[cw] = da0 ? 1 : 0;
}

// K4: traceback over the decision words plus the bit epilogue.  Replaces
// _traceback_kernel in dabjax/fec/viterbi_pallas.py for the word layout,
// with the unpack of viterbi_decode_pallas (bits[2t] = e[t+3] >> 1,
// bits[2t+1] = e[t+3] & 1, trimmed to nbits) fused in.
//
// What bounds it on the card: a chain of T/2 dependent 4-byte loads per
// codeword (the state selects the word entry to read) and B * nbits int32
// stores.  Design: one thread per codeword walking the words in reverse
// from state 0; the words were written by K3 just before and are mostly
// still in the 50 MB L2 at the main-path shapes.
//
// Odd T (odd nbits): the last pair's second step is zero-soft padding.
// The TPU walk starts at state 0 after that padding step, which picks the
// intermediate state 32 over 0 whenever its metric is higher, and then
// differs from the radix-2 reference on noise-like input.  Here the walk
// starts at state 0 after the true last step: the last pair's branch is
// taken as (last[b] << 1), state 0's own decision at that step.
__global__ void __launch_bounds__(128)
traceback_words(const int32_t* __restrict__ dec,   // [B, W, 64]
                const int32_t* __restrict__ last,  // [B]
                int32_t* __restrict__ bits,        // [B, nbits]
                int B, int T2, int nbits) {
  const int cw = blockIdx.x * blockDim.x + threadIdx.x;
  if (cw >= B) return;
  const int W = (T2 + kPairsPerWord - 1) / kPairsPerWord;
  const int32_t* d = dec + static_cast<size_t>(cw) * W * 64;
  int32_t* out = bits + static_cast<size_t>(cw) * nbits;
  const bool odd = 2 * T2 != nbits + 6;
  int state = 0;
  for (int tau = T2 - 1; tau >= 0; --tau) {
    int e;
    if (odd && tau == T2 - 1) {
      e = last[cw] << 1;
    } else {
      const int word = d[(tau / kPairsPerWord) * 64 + state];
      e = (word >> (2 * (tau & (kPairsPerWord - 1)))) & 3;
    }
    const int b = 2 * (tau - 3);
    if (b >= 0 && b < nbits) out[b] = e >> 1;
    if (b >= 0 && b + 1 < nbits) out[b + 1] = e & 1;
    state = (state >> 2) | (e << 4);
  }
}

}  // namespace

extern "C" {

int dabjax_viterbi_forward(const void* soft, const void* signs, void* dec,
                           int B, int T, void* stream) {
  const int threads = 128;                       // 4 codewords per block
  const int blocks = (B + 3) / 4;
  forward_acs<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(soft), static_cast<const int32_t*>(signs),
      static_cast<uint2*>(dec), B, T);
  return static_cast<int>(cudaGetLastError());
}

int dabjax_viterbi_traceback(const void* dec, void* bits, int B, int T,
                             int nbits, void* stream) {
  constexpr int kPerBlock = kTbCw * kTbWarps;    // codewords of a block
  const int blocks = (B + kPerBlock - 1) / kPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2* d = static_cast<const uint2*>(dec);
  int32_t* b = static_cast<int32_t*>(bits);
  if (T % 2 == 0 && reinterpret_cast<uintptr_t>(dec) % 16 == 0)
    traceback<true><<<blocks, 32 * kTbWarps, 0, st>>>(d, b, B, T, nbits);
  else
    traceback<false><<<blocks, 32 * kTbWarps, 0, st>>>(d, b, B, T, nbits);
  return static_cast<int>(cudaGetLastError());
}

// variant 0: int8 stream, int32 metrics (i8mxu); 1: int8 stream, float
// metrics (i8); 2: float stream, float metrics (f32)
int dabjax_viterbi_forward_words(const void* soft, const void* signs,
                                 void* dec, void* last, int B, int T2,
                                 int variant, void* stream) {
  const int threads = 128;                       // 4 codewords per block
  const int blocks = (B + 3) / 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* d = static_cast<int32_t*>(dec);
  int32_t* l = static_cast<int32_t*>(last);
  switch (variant) {
    case 0:
      forward_acs_words<int, StreamI8><<<blocks, threads, 0, st>>>(
          static_cast<const int2*>(soft), static_cast<const int2*>(signs),
          d, l, B, T2, -(1 << 29));
      break;
    case 1:
      forward_acs_words<float, StreamI8><<<blocks, threads, 0, st>>>(
          static_cast<const int2*>(soft), static_cast<const int2*>(signs),
          d, l, B, T2, -1e9f);
      break;
    case 2:
      forward_acs_words<float, StreamF32><<<blocks, threads, 0, st>>>(
          static_cast<const Float8*>(soft),
          static_cast<const Float8*>(signs), d, l, B, T2, -1e9f);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dabjax_viterbi_traceback_words(const void* dec, const void* last,
                                   void* bits, int B, int T2, int nbits,
                                   void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  traceback_words<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dec), static_cast<const int32_t*>(last),
      static_cast<int32_t*>(bits), B, T2, nbits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
