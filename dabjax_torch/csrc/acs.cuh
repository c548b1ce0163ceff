// Pieces of the radix-4 add-compare-select shared by the word forward
// kernel (K3, viterbi.cu) and the forward probes (probes.cu), so that
// they select exactly as dabjax/fec/viterbi_pallas.py's _forward_kernel
// does.  Internal linkage: each .cu gets its own copy.

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

}  // namespace
