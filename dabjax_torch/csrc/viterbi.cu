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
// contract), so int8 inputs and integer path metrics are exact: the
// largest metric growth is 508 per step, 4.7e6 over the 9222 steps of a
// 384 kbit/s subchannel, far inside int32 with the -2^29 start of the
// states other than 0 (K3: no renormalisation needed); K1 keeps 16-bit
// metrics and renormalises once a tile (see there).

#include <cstdint>
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

// K1: forward add-compare-select.  Replaces _forward_kernel_lane in
// dabjax/fec/viterbi_pallas.py (radix-4 ACS, 16 pair steps per packed
// decision word, batch on TPU lanes).
//
// What bounds it on the card: each codeword is a chain of T dependent
// steps, and with one warp a codeword the card is full of such chains
// (4428 at the MSC shape, nine warps a scheduler), so the latency of a
// step is hidden and the limit is how many instructions a step takes.
// The first version ran 5 shuffles, 2 votes and about 20 integer
// instructions a step on int32 metrics; with any one of those groups
// taken out it ran no faster than 0.29 of its 0.33 ms (NVIDIA H100 80GB
// HBM3, 700 W), so no single queue bounded it: the sum did.  This version
// runs about 12 a step, 10 of them the ones listed below, and half of
// those on the integer ALU pipe, which takes a warp instruction every
// other clock: with the shuffle, the votes, the shared stores or the
// soft loads taken out it is no faster; with the two byte permutes
// taken out it is 9 % faster.  0.176 ms, 3.0 times the bound's 3
// operations a state.
// Design, per warp and codeword:
//  * In place.  The lane that holds the metrics of states p and p + 32
//    holds both predecessors of 2p and 2p + 1 and computes both with no
//    shuffle.  The new pair differs from the pair the next step needs,
//    (u, u + 32), by one exchange with the lane across one lane bit: one
//    shuffle and two byte permutes a step.  The price is that the 5-bit
//    lane index of a state pair rotates one bit a step (period
//    kFwPhases); the unrolled tile knows each step's phase at compile
//    time, one more shuffle a tile of kFwTile steps puts the lanes back,
//    and the decisions are stored where they are made (word = state & 1,
//    bit = the lane): K2 walks in the same rotated coordinates.
//  * Two metrics a register.  Path metrics are unsigned 16-bit halves of
//    one word, so the exchange moves both metrics at once, the four
//    candidates are two 32-bit multiply-adds (the four branch metrics of
//    a butterfly are +-b for one dp4a b, because every generator has its
//    first and last tap set: b * 0xFFFF0001 adds (+b, -b) to the halves,
//    b * 0x0000FFFF adds (-b, +b), exact while no half leaves
//    0 .. 65535), and one DPX __vibmax_u16x2 gives both maxima and both
//    decisions; its predicate is a >= c, so ties keep branch 0.  State 0
//    starts at kLive and is put back there once a tile; live metrics lie
//    within 12 * 508 of each other and move at most 32 * 508 a tile, so
//    no half wraps and every difference is that of an int32 recursion.
//    The other start states begin 8192 lower: further than the 6 * 508 a
//    path gains before every state descends from state 0.
//  * Decisions by vote.  The two predicates of the maximum go through
//    two __ballot_sync a step; lane 0 puts the step's two words in shared
//    memory, and after the tile lane j reads step j's words back and
//    stores them: one coalesced 256-byte store a tile.  Slower, measured:
//    one 16-byte shared store every other step (0.191 ms against 0.187,
//    its register moves cost what the store saved); keeping the words in
//    the lane of their step by predicated moves (0.211); gathering each
//    lane's own decisions in two registers and transposing the two
//    32 x 32 bit matrices by shuffle (0.229).
//  * The soft words of a tile (one coalesced 128-byte load, started a
//    tile ahead) go through shared memory and come back four steps at a
//    time as one broadcast 16-byte load (0.229 ms against 0.249 with a
//    shuffle broadcast a step, on the transposing variant).
//  * Four warps a block, nine blocks an SM: two or three warps a block
//    measured the same, eight slower.
// A partial last tile runs its 32 steps on zero soft words and stores
// only the steps below T.
constexpr int kFwTile = 32;                   // steps of a tile
constexpr int kFwPhases = 5;                  // period of the lane rotation
constexpr int kFwWarps = 4;                   // warps (codewords) of a block
constexpr unsigned kLive = 32768u;            // state 0, at every tile start
constexpr unsigned kDead = kLive - 8192u;     // the other start states

// the 5-bit lane index rotated left by k (k may be negative)
__device__ __forceinline__ int rotl5(int x, int k) {
  k = ((k % kFwPhases) + kFwPhases) % kFwPhases;
  return ((x << k) | (x >> (kFwPhases - k))) & 31;
}

__global__ void __launch_bounds__(32 * kFwWarps, 9)
forward_acs(const int32_t* __restrict__ soft,   // [B, T] packed int8x4
            const int32_t* __restrict__ signs,  // [32] signs of r = 2s
            uint2* __restrict__ dec,            // [B, T] decision words
            int B, int T) {
  __shared__ __align__(16) int32_t xs[kFwWarps][2][kFwTile];
  __shared__ uint2 ds[kFwWarps][kFwTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kFwWarps + warp;
  if (cw >= B) return;  // whole warps exit together
  const int32_t* s = soft + static_cast<size_t>(cw) * T;
  uint2* d = dec + static_cast<size_t>(cw) * T;

  // By phase: the signs of the lane's butterfly (it holds states u and
  // u + 32, u = rotl5(lane, phase)), and the byte selectors that build
  // (lo, lo) and (hi, hi) from the lane's own new pair and its partner's
  // after a step of that phase (the lane keeps its low half when its
  // exchanged lane bit is 0, its high half when it is 1).
  int sg[kFwPhases];
  unsigned sel_lo[kFwPhases], sel_hi[kFwPhases];
#pragma unroll
  for (int p = 0; p < kFwPhases; ++p) {
    sg[p] = signs[rotl5(lane, p)];
    const bool up = (lane >> (4 - p)) & 1;
    sel_lo[p] = up ? 0x7676u : 0x1010u;
    sel_hi[p] = up ? 0x3232u : 0x5454u;
    // kept in registers: left to itself the compiler builds the ten
    // selectors anew in every tile, 25 ALU instructions more
    asm volatile("" : "+r"(sel_lo[p]), "+r"(sel_hi[p]));
  }
  // a tile ends in phase (kFwTile - 1) % kFwPhases and the next begins
  // as if after phase kFwPhases - 1
  const int back = rotl5(lane, -((kFwTile - 1) % kFwPhases + 1));
  // new pair (2v, 2v + 1) of the lane, v = rotl5(lane, -1): state 0 is
  // the low half of lane 0, in every phase
  unsigned n = kDead * 0x10001u;
  if (lane == 0) n = kLive | (kDead << 16);

  const int tiles = (T + kFwTile - 1) / kFwTile;
  int w = (lane < T) ? s[lane] : 0;
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kFwTile;
    int32_t* buf = xs[warp][k & 1];
    buf[lane] = w;
    // also: every lane has read buffer k & 1 of tile k - 2, and its
    // decisions of tile k - 1
    __syncwarp();
    const int t_next = t0 + kFwTile + lane;
    w = (t_next < T) ? s[t_next] : 0;
    if (k) {
      n = __shfl_sync(kFull, n, back);
      const unsigned zero = __shfl_sync(kFull, n, 0) & 0xffffu;
      n += (kLive - zero) * 0x10001u;
    }
    int4 x4;
#pragma unroll
    for (int j = 0; j < kFwTile; ++j) {
      const int phase = j % kFwPhases;
      const int prev = (j + kFwPhases - 1) % kFwPhases;
      if (j % 4 == 0) x4 = *reinterpret_cast<const int4*>(buf + j);
      const int x = j % 4 == 0 ? x4.x : j % 4 == 1 ? x4.y
                  : j % 4 == 2 ? x4.z : x4.w;
      const unsigned other = __shfl_xor_sync(kFull, n, 16 >> prev);
      const unsigned lo = __byte_perm(n, other, sel_lo[prev]);
      const unsigned hi = __byte_perm(n, other, sel_hi[prev]);
      const unsigned b = static_cast<unsigned>(__dp4a(x, sg[phase], 0));
      const unsigned a = lo + b * 0xffff0001u;   // (lo + b, lo - b)
      const unsigned c = hi + b * 0x0000ffffu;   // (hi - b, hi + b)
      bool a_hi, a_lo;                           // branch 0 kept (a >= c)
      n = __vibmax_u16x2(a, c, &a_hi, &a_lo);
      const unsigned dec_lo = __ballot_sync(kFull, !a_lo);
      const unsigned dec_hi = __ballot_sync(kFull, !a_hi);
      if (lane == 0) ds[warp][j] = make_uint2(dec_lo, dec_hi);
    }
    __syncwarp();
    const uint2 mine = ds[warp][lane];
    if (t0 + lane < T) d[t0 + lane] = mine;
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
// DAB size).  The walk runs in K1's rotated coordinates: the state is kept
// as (half, pos), the word and the bit of its decision; a step back
// replaces bit q of pos by the decision and takes the old bit as the new
// half, q being the lane bit K1 exchanged at that step (a compile-time
// constant of the unrolled step), so the chain is as long as a shift of the
// state would be; where a tile ends, pos is re-indexed as K1's one shuffle a
// tile re-indexed the lanes.  The decoded bit of a step is `half`.  The
// top tile, partial when T is not a multiple of 32, is zero-filled past T:
// zero decisions keep the start state 0, so the walk needs no guard.  Rows
// of codewords >= B are zero-filled too; bits t >= nbits and codewords >= B
// are masked at the store.
constexpr int kTbSteps = 32;                  // steps of a tile
constexpr int kTbCw = 16;                     // codewords of a warp
constexpr int kTbWarps = 2;                   // warps of a block
constexpr int kTbStages = 4;                  // tiles in shared memory
constexpr int kTbRow = kTbSteps * 8 + 16;     // bytes of a row (padded)
constexpr int kTbTile = kTbCw * kTbRow;       // bytes of a warp's tile
// K2 walks K1's rotated coordinates: the same tiles, and the re-indexing
// between tiles below is a rotation by 2
static_assert(kTbSteps == kFwTile && (kFwTile - 1) % kFwPhases + 1 == 2,
              "K2's walk assumes K1's tile and rotation");

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
  unsigned half = 0, pos = 0;                 // state 0, in every phase
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
      mask |= half << j;                      // the state's newest bit
      const unsigned word = half ? w[j].y : w[j].x;
      const unsigned dbit = (word >> pos) & 1u;
      if (j > 0) {
        // the lane bit K1 exchanged at step j
        const int q = (kFwPhases - j % kFwPhases) % kFwPhases;
        half = (pos >> q) & 1u;
        pos = (pos & ~(1u << q)) | (dbit << q);
      } else {                                // K1's shuffle between tiles
        half = pos & 1u;
        pos = (pos >> 2) | (dbit << 3) | (((pos >> 1) & 1u) << 4);
      }
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
  const int threads = 32 * kFwWarps;             // a warp a codeword
  const int blocks = (B + kFwWarps - 1) / kFwWarps;
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
