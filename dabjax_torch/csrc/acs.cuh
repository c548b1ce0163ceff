// Pieces of the radix-4 add-compare-select shared by the word forward
// kernel (K3, viterbi.cu) and the stage-stripped probe (probes.cu), so
// that both select exactly as dabjax/fec/viterbi_pallas.py's
// _forward_kernel does.  Internal linkage: each .cu gets its own copy.

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
