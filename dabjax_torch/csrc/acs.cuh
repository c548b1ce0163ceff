// Pieces of the radix-4 add-compare-select shared by the word forward
// kernel (K3, viterbi.cu) and the forward probes (probes.cu), so that
// they select exactly as dabjax/fec/viterbi_pallas.py's _forward_kernel
// does, and K1's in-place radix-2 core (U16Core; viterbi.cu's K1 comment
// describes it), which K1 runs and K3 and the plane forward probe run
// after their first word.  Internal linkage: each .cu gets its own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// pair steps per packed decision word (2 bits each)
constexpr int kPairsPerWord = 16;

// The 8 soft values of a pair step, and the 8 signs of a branch row, as
// an int8 stream (packed int8x8; branch metric = two dp4a) ...
struct StreamI8 {
  using Pair = int2;
  __device__ static Pair zero() { return make_int2(0, 0); }
  __device__ static Pair shfl(Pair v, int src) {
    return make_int2(__shfl_sync(kFull, v.x, src),
                     __shfl_sync(kFull, v.y, src));
  }
  __device__ static int bm(Pair x, Pair s) {
    return __dp4a(x.y, s.y, __dp4a(x.x, s.x, 0));
  }
};

// ... or as a float stream (integer values times +-1: every product and
// partial sum is an exact float, so the order of the sum is free).
struct __align__(16) Float8 {
  float4 lo, hi;
};

struct StreamF32 {
  using Pair = Float8;
  __device__ static Pair zero() {
    Pair z;
    z.lo = make_float4(0.f, 0.f, 0.f, 0.f);
    z.hi = z.lo;
    return z;
  }
  __device__ static float4 shfl4(float4 v, int src) {
    return make_float4(__shfl_sync(kFull, v.x, src),
                       __shfl_sync(kFull, v.y, src),
                       __shfl_sync(kFull, v.z, src),
                       __shfl_sync(kFull, v.w, src));
  }
  __device__ static Pair shfl(const Pair& v, int src) {
    Pair o;
    o.lo = shfl4(v.lo, src);
    o.hi = shfl4(v.hi, src);
    return o;
  }
  __device__ static float bm(const Pair& x, const Pair& s) {
    return x.lo.x * s.lo.x + x.lo.y * s.lo.y + x.lo.z * s.lo.z +
           x.lo.w * s.lo.w + x.hi.x * s.hi.x + x.hi.y * s.hi.y +
           x.hi.z * s.hi.z + x.hi.w * s.hi.w;
  }
};

// candidate metric: exact int32, or one IEEE round-to-nearest float add
// (the f32 add of the TPU kernel, which the float words depend on)
__device__ __forceinline__ int cand(int pm, int bm) { return pm + bm; }
__device__ __forceinline__ float cand(float pm, int bm) {
  return __fadd_rn(pm, static_cast<float>(bm));
}
__device__ __forceinline__ float cand(float pm, float bm) {
  return __fadd_rn(pm, bm);
}

// The TPU kernel's selection, to the letter: inner max over d0 for each
// d1, then d1 over the two maxima; strict '>' so ties keep 0.
template <typename M>
__device__ __forceinline__ unsigned select4(M m00, M m01, M m10, M m11,
                                            M& pm, bool& da) {
  da = m10 > m00;
  const M a = da ? m10 : m00;
  const bool db = m11 > m01;
  const M b = db ? m11 : m01;
  const bool d1 = b > a;
  pm = d1 ? b : a;
  const bool d0 = d1 ? db : da;
  return (static_cast<unsigned>(d0) << 1) | static_cast<unsigned>(d1);
}

// K1's core: a tile of kFwTile trellis steps, over which the 5-bit lane
// index of a state pair rotates one bit a step (period kFwPhases); u16x2
// metrics relative to state 0, which starts at kLive and is put back
// there once a tile, the other start states at kDead
constexpr int kFwTile = 32;                   // steps of a tile
constexpr int kFwPhases = 5;                  // period of the lane rotation
constexpr unsigned kLive = 32768u;            // state 0, at every tile start
constexpr unsigned kDead = kLive - 8192u;     // the other start states

// the 5-bit lane index rotated left by k (k may be negative)
__device__ __forceinline__ int rotl5(int x, int k) {
  k = ((k % kFwPhases) + kFwPhases) % kFwPhases;
  return ((x << k) | (x >> (kFwPhases - k))) & 31;
}

// x rotated right by k (mod 32)
__device__ __forceinline__ unsigned rotr32(unsigned x, unsigned k) {
  return __funnelshift_r(x, x, k);
}

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

// K3's word 0 (viterbi.cu): pair steps 0 .. n0 - 1 (n0 = min(16, T2))
// of dabjax's radix-4 recursion, stored as the 64 words of word index 0
// at d; leaves the metrics of states lane (pm_lo) and lane + 32 (pm_hi)
// and state 0's inner decision of the last pair step.  The four
// predecessors of state l sit in lanes l >> 2 and 16 + (l >> 2), those
// of l + 32 in lanes 8 + (l >> 2) and 24 + (l >> 2), each as a lo and a
// hi metric.
template <typename M, typename S>
__device__ __forceinline__ void k3_word0(
    const typename S::Pair* __restrict__ s,
    const typename S::Pair* __restrict__ signs, int32_t* __restrict__ d,
    int n0, M start, int lane, M& pm_lo, M& pm_hi, bool& da0) {
  using Pair = typename S::Pair;
  pm_lo = (lane == 0) ? M(0) : start;
  pm_hi = start;
  const int q = lane >> 2;
  const int src_a = q, src_b = 16 + q, src_c = 8 + q, src_d = 24 + q;
  unsigned acc_lo = 0, acc_hi = 0;
  const Pair w = (lane < n0) ? s[lane] : S::zero();
#pragma unroll 1
  for (int j = 0; j < n0; ++j) {
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
    // branch rows e*64 + n, read where they are used (16 steps; L1)
    bool da_lo, da_hi;
    const unsigned e_lo = select4(
        cand(a_lo, S::bm(x, signs[lane])),
        cand(b_lo, S::bm(x, signs[64 + lane])),
        cand(a_hi, S::bm(x, signs[128 + lane])),
        cand(b_hi, S::bm(x, signs[192 + lane])), pm_lo, da_lo);
    const unsigned e_hi = select4(
        cand(c_lo, S::bm(x, signs[32 + lane])),
        cand(d_lo, S::bm(x, signs[96 + lane])),
        cand(c_hi, S::bm(x, signs[160 + lane])),
        cand(d_hi, S::bm(x, signs[224 + lane])), pm_hi, da_hi);
    acc_lo |= e_lo << (2 * j);
    acc_hi |= e_hi << (2 * j);
    da0 = da_lo;
  }
  d[lane] = static_cast<int32_t>(acc_lo);
  d[32 + lane] = static_cast<int32_t>(acc_hi);
}

// K3's pack of the u16 core (viterbi.cu describes it): pair jp's two
// bits of states lane and lane + 32 from the pair's vote words
__device__ __forceinline__ void k3_pack_pair(unsigned w1, unsigned w0, int jp,
                                             const int (&p1)[kFwPhases],
                                             const int (&p0)[kFwPhases],
                                             unsigned& acc_a,
                                             unsigned& acc_b) {
  const int ph1 = (2 * jp + 1) % kFwPhases, ph0 = (2 * jp) % kFwPhases;
  const int c = 4 - ph0;                           // d1's bit in q >> 1
  const int s1 = 16 >> ph1;                        // rotr5(16, ph1)
  const int s0 = rotl5(8, -ph0);                   // rotr5(8, ph0)
  // bit 2jp: d1 of state lane; bit 2jp + s1: of state lane + 32
  const unsigned ta = rotr32(w1, p1[ph1] - 2 * jp);
  const unsigned tb = rotr32(ta, s1);
  const unsigned ca =
      (2 * jp >= c ? ta >> (2 * jp - c) : ta << (c - 2 * jp)) & (1u << c);
  const unsigned cb =
      (2 * jp >= c ? tb >> (2 * jp - c) : tb << (c - 2 * jp)) & (1u << c);
  // bit 2jp + 1: d0
  const unsigned ya = rotr32(w0, ca + p0[ph0] - (2 * jp + 1));
  const unsigned yb = rotr32(w0, cb + p0[ph0] + s0 - (2 * jp + 1));
  const unsigned m1 = 1u << (2 * jp), m0 = 2u << (2 * jp);
  acc_a |= (ta & m1) | (ya & m0);
  acc_b |= (tb & m1) | (yb & m0);
}

// K1's tile-start layout entered from word 0's metrics (pm_lo: state
// lane, pm_hi: state lane + 32): lane L's new states 2v (m_even) and
// 2v + 1 (m_odd), v = rotl5(L, -1)
template <typename M>
__device__ __forceinline__ void k1_tile_start(M pm_lo, M pm_hi, int lane,
                                              M& m_even, M& m_odd) {
  const int v = rotl5(lane, -1);
  const int src = (2 * v) & 31;
  const bool upper = v >> 4;
  const M xl = __shfl_sync(kFull, pm_lo, src);
  const M xh = __shfl_sync(kFull, pm_hi, src);
  const M yl = __shfl_sync(kFull, pm_lo, src + 1);
  const M yh = __shfl_sync(kFull, pm_hi, src + 1);
  m_even = upper ? xh : xl;
  m_odd = upper ? yh : yl;
}

// The bit positions of K3's pack by phase (k3_pack_pair):
// p1[ph] = rotr5(lane >> 1, ph), p0[ph] = rotr5(lane >> 2, ph), kept in
// registers as K1 keeps its selectors
__device__ __forceinline__ void k3_pack_positions(int lane,
                                                  int (&p1)[kFwPhases],
                                                  int (&p0)[kFwPhases]) {
#pragma unroll
  for (int p = 0; p < kFwPhases; ++p) {
    p1[p] = rotl5(lane >> 1, -p);
    p0[p] = rotl5(lane >> 2, -p);
    asm volatile("" : "+r"(p1[p]), "+r"(p0[p]));
  }
}

// K1's u16x2 core (viterbi.cu, where K1's comment describes it), the one
// copy that K1, K3 under its int8 formats and the plane forward probe run:
// a lane's two metrics n, its butterfly signs and byte selectors by
// phase.  init() builds the tables; the caller sets n (K1: the start
// states; K3 and the probe: start(), from word 0's metrics); renorm()
// goes before every tile but the first; tile() runs one tile.
struct U16Core {
  unsigned n;                                    // the lane's new pair
  int sg[kFwPhases];                             // butterfly signs
  unsigned sel_lo[kFwPhases], sel_hi[kFwPhases]; // byte selectors
  int back;                                      // lane of the tile start

  // By phase: the signs of the lane's butterfly (it holds states u and
  // u + 32, u = rotl5(lane, phase)), and the byte selectors that build
  // (lo, lo) and (hi, hi) from the lane's own new pair and its partner's
  // after a step of that phase (the lane keeps its low half when its
  // exchanged lane bit is 0, its high half when it is 1).
  __device__ __forceinline__ void init(const int32_t* __restrict__ signs,
                                       int lane) {
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
    back = rotl5(lane, -((kFwTile - 1) % kFwPhases + 1));
  }

  // n from word 0's metrics (k3_word0), relative to state 0 at kLive:
  // exact once every state is live (after pair step 2), the live
  // metrics then within 12 * 508 of each other
  template <typename M>
  __device__ __forceinline__ void start(M pm_lo, M pm_hi, int lane) {
    M m_even, m_odd;
    k1_tile_start(pm_lo, pm_hi, lane, m_even, m_odd);
    const M ref = __shfl_sync(kFull, pm_lo, 0);
    n = (kLive + static_cast<int>(m_even - ref)) |
        ((kLive + static_cast<int>(m_odd - ref)) << 16);
  }

  // the lanes back in the tile-start layout, state 0 back at kLive
  __device__ __forceinline__ void renorm() {
    n = __shfl_sync(kFull, n, back);
    const unsigned zero = __shfl_sync(kFull, n, 0) & 0xffffu;
    n += (kLive - zero) * 0x10001u;
  }

  // One tile: kFwTile trellis steps on xs (int8x4 words in shared
  // memory, 16-byte aligned).  After step j's votes, vote(j, dec_lo,
  // dec_hi); after the odd step of pair jp, pair(jp, w1, w0) with the
  // pair's vote words that K3's pack reads in lane `lane` (w1: step
  // 2jp + 1, word lane & 1; w0: step 2jp, word (lane >> 1) & 1).
  template <typename Vote, typename Pair>
  __device__ __forceinline__ void tile(const int32_t* xs, int lane,
                                       Vote&& vote, Pair&& pair) {
    unsigned w0 = 0;
    int4 x4;
#pragma unroll
    for (int j = 0; j < kFwTile; ++j) {
      const int phase = j % kFwPhases;
      const int prev = (j + kFwPhases - 1) % kFwPhases;
      if (j % 4 == 0) x4 = *reinterpret_cast<const int4*>(xs + j);
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
      vote(j, dec_lo, dec_hi);
      if (j % 2 == 0)
        w0 = ((lane >> 1) & 1) ? dec_hi : dec_lo;
      else
        pair(j / 2, (lane & 1) ? dec_hi : dec_lo, w0);
    }
  }
};

}  // namespace
