// Dependent elementwise chains on a resident tile: the Hopper probes of
// tools/vpu_probe.py (make_chain) and tools/vpu_probe2.py (make_chain of
// its `vpu` half), which timed the TPU's vector unit by dtype.  Plain C
// interface, loaded with ctypes by dabjax_torch/tools/vpu_probe{,2}.py;
// every entry point launches on the caller's stream and returns
// cudaGetLastError() of its launch.
//
// What bounds them on the card: at short chains, the launch and the one
// read and one write of the tile; at long ones, the issue rate of the
// pipe that executes the op (FP32, FP16/BF16, integer ALU, DPX), since
// every thread runs a chain of dependent ops and tens of warps per SM
// hide each op's latency.  The slope between two chain lengths is the
// per-op cost.  Design: one thread per 32-bit word of the tile (one f32
// or int32, two bf16 or int16, four int8), read once into a register,
// the N ops of the chain on that register, written once.
//
// Folding.  ptxas, not only the front end, simplifies arithmetic it can
// see: measured on the H100 with nvcc 12.9, it drops max(v, v) outright
// and folds a chain of shift-and-mask doublings into one.  So each op is
// its own asm volatile statement (the front end keeps them all), and
// every op's operands are ones ptxas cannot prove equal to a shortcut:
// `max` is max(v, lowest) with the dtype's lowest value passed at run
// time (v * 1 is v, and max(v, lowest) = v for every non-NaN v, so the
// result is the TPU chain's), and the int8 emulation takes its zero
// from a kernel argument.  vpu_probe.sass_op_counts() counts the SASS
// instructions of each chain in the built library and shows they grow
// with N.
//
// The instruction of each op (the fastest form measured on the card):
//   f32    add.rn.f32 (FADD), max.f32 (FMNMX);
//   bf16   add.rn.bf16x2, max.bf16x2 (native on sm_90, two per word);
//   int32  add.s32, max.s32 (ptxas fuses two max with one operand into
//          a 3-input VIMNMX3, and add + max into the DPX VIADDMNMX);
//   int16  add.s16x2, max.s16x2 (sm_90 packed forms: VIADD.16,
//          VIMNMX.S16, and VIADDMNMX.S16 for add + max);
//   int8   no packed 8x4 add or max on the card: add is vadd4 (ptxas
//          emits it as two integer ops), max goes through two sign-
//          extending byte permutes to int16x2, max.s16x2 on each half,
//          and one permute back (the card's vmax4 emulation took 32
//          instructions a word).
// Integer adds wrap mod 2^k as XLA's do (PTX adds are modular; no C++
// signed overflow is involved).  bf16 rounds after every op, as torch's
// bf16 ops do: a bf16 sum is rounded once to nearest-even, and in these
// chains (operands of like magnitude) torch's add through float rounds
// to the same value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3, kI8 = 4 };
enum ChainOp { kAdd = 0, kMax = 1, kMix = 2 };

constexpr int kThreads = 256;

// a + b and max(a, b) on one 32-bit word of packed elements, each one
// asm volatile statement (zero: a run-time 0 for the int8 emulation)
template <int D>
struct Alu;

template <>
struct Alu<kF32> {
  __device__ static unsigned add(unsigned a, unsigned b, unsigned) {
    float x = __uint_as_float(a);
    asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(__uint_as_float(b)));
    return __float_as_uint(x);
  }
  __device__ static unsigned max(unsigned a, unsigned b) {
    float x = __uint_as_float(a);
    asm volatile("max.f32 %0, %0, %1;" : "+f"(x) : "f"(__uint_as_float(b)));
    return __float_as_uint(x);
  }
};

template <>
struct Alu<kBF16> {
  __device__ static unsigned add(unsigned a, unsigned b, unsigned) {
    asm volatile("add.rn.bf16x2 %0, %0, %1;" : "+r"(a) : "r"(b));
    return a;
  }
  __device__ static unsigned max(unsigned a, unsigned b) {
    asm volatile("max.bf16x2 %0, %0, %1;" : "+r"(a) : "r"(b));
    return a;
  }
};

template <>
struct Alu<kI32> {
  __device__ static unsigned add(unsigned a, unsigned b, unsigned) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(b));
    return a;
  }
  __device__ static unsigned max(unsigned a, unsigned b) {
    asm volatile("max.s32 %0, %0, %1;" : "+r"(a) : "r"(b));
    return a;
  }
};

template <>
struct Alu<kI16> {
  __device__ static unsigned add(unsigned a, unsigned b, unsigned) {
    asm volatile("add.s16x2 %0, %0, %1;" : "+r"(a) : "r"(b));
    return a;
  }
  __device__ static unsigned max(unsigned a, unsigned b) {
    asm volatile("max.s16x2 %0, %0, %1;" : "+r"(a) : "r"(b));
    return a;
  }
};

template <>
struct Alu<kI8> {
  __device__ static unsigned add(unsigned a, unsigned b, unsigned zero) {
    asm volatile("vadd4.u32.u32.u32 %0, %0, %1, %2;"
                 : "+r"(a) : "r"(b), "r"(zero));
    return a;
  }
  // bytes 0, 2 and 1, 3 sign-extended to int16x2 (prmt selector nibble
  // 8 | k: the sign of byte k), max.s16x2 on each, low bytes packed back
  __device__ static unsigned max(unsigned a, unsigned b) {
    unsigned ae, ao, be, bo;
    asm volatile("prmt.b32 %0, %1, 0, 0xA280;" : "=r"(ae) : "r"(a));
    asm volatile("prmt.b32 %0, %1, 0, 0xB391;" : "=r"(ao) : "r"(a));
    asm volatile("prmt.b32 %0, %1, 0, 0xA280;" : "=r"(be) : "r"(b));
    asm volatile("prmt.b32 %0, %1, 0, 0xB391;" : "=r"(bo) : "r"(b));
    asm volatile("max.s16x2 %0, %0, %1;" : "+r"(ae) : "r"(be));
    asm volatile("max.s16x2 %0, %0, %1;" : "+r"(ao) : "r"(bo));
    unsigned d;
    asm volatile("prmt.b32 %0, %1, %2, 0x6240;" : "=r"(d) : "r"(ae), "r"(ao));
    return d;
  }
};

// C1: n dependent ops on each word.  Replaces make_chain in
// tools/vpu_probe.py: add v <- v + v, max v <- max(v, v * 1) (issued as
// max(v, lowest), see above), mix v <- max(v + v, v).
template <int D, int kOp, int N>
__global__ void __launch_bounds__(kThreads)
elementwise_chain(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                  long long words, unsigned lowest, unsigned zero) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= words) return;
  unsigned v = x[i];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (kOp == kAdd) {
      v = Alu<D>::add(v, v, zero);
    } else if constexpr (kOp == kMax) {
      v = Alu<D>::max(v, lowest);
    } else {
      v = Alu<D>::max(Alu<D>::add(v, v, zero), v);
    }
  }
  out[i] = v;
}

// C2: N / 2 dependent pairs v <- max(v, w); w <- w + v on two tiles, out
// v.  Replaces make_chain in tools/vpu_probe2.py (its `vpu` half), whose
// second tile keeps both values live so that no op can be folded.
template <int D, int N>
__global__ void __launch_bounds__(kThreads)
pair_chain(const unsigned* __restrict__ x, const unsigned* __restrict__ y,
           unsigned* __restrict__ out, long long words, unsigned zero) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= words) return;
  unsigned v = x[i];
  unsigned w = y[i];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    v = Alu<D>::max(v, w);
    w = Alu<D>::add(w, v, zero);
  }
  out[i] = v;
}

// the chain lengths built (the wrappers' CHAIN_NS and PAIR_NS)
template <int D, int kOp>
int launch_chain(int n, unsigned grid, cudaStream_t st, const unsigned* x,
                 unsigned* o, long long words, unsigned lowest,
                 unsigned zero) {
  switch (n) {
#define DABJAX_CHAIN(N)                                                  \
  case N:                                                                \
    elementwise_chain<D, kOp, N><<<grid, kThreads, 0, st>>>(x, o, words, \
                                                           lowest, zero); \
    return 0;
    DABJAX_CHAIN(3)
    DABJAX_CHAIN(8)
    DABJAX_CHAIN(64)
    DABJAX_CHAIN(512)
    DABJAX_CHAIN(2048)
#undef DABJAX_CHAIN
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int launch_chain_op(int op, int n, unsigned grid, cudaStream_t st,
                    const unsigned* x, unsigned* o, long long words,
                    unsigned lowest, unsigned zero) {
  switch (op) {
    case kAdd:
      return launch_chain<D, kAdd>(n, grid, st, x, o, words, lowest, zero);
    case kMax:
      return launch_chain<D, kMax>(n, grid, st, x, o, words, lowest, zero);
    case kMix:
      return launch_chain<D, kMix>(n, grid, st, x, o, words, lowest, zero);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int launch_pair(int n, unsigned grid, cudaStream_t st, const unsigned* x,
                const unsigned* y, unsigned* o, long long words,
                unsigned zero) {
  switch (n) {
#define DABJAX_PAIR(N)                                                      \
  case N:                                                                   \
    pair_chain<D, N><<<grid, kThreads, 0, st>>>(x, y, o, words, zero); \
    return 0;
    DABJAX_PAIR(16)
    DABJAX_PAIR(96)
    DABJAX_PAIR(512)
    DABJAX_PAIR(2048)
#undef DABJAX_PAIR
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool grid_of(long long words, unsigned& grid) {
  const long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return false;
  grid = static_cast<unsigned>(blocks);
  return true;
}

}  // namespace

extern "C" {

// words: 32-bit words of x and out; dtype 0 f32, 1 bf16, 2 int32,
// 3 int16, 4 int8; op 0 add, 1 max, 2 mix; n one of 3, 8, 64, 512, 2048;
// lowest: the dtype's lowest value in every lane of a word; zero: 0
int dabjax_probe_chain(const void* x, void* out, long long words, int dtype,
                       int op, int n, unsigned lowest, unsigned zero,
                       void* stream) {
  unsigned grid;
  if (!grid_of(words, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* xi = static_cast<const unsigned*>(x);
  unsigned* o = static_cast<unsigned*>(out);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_chain_op<kF32>(op, n, grid, st, xi, o, words, lowest, zero);
      break;
    case kBF16:
      rc = launch_chain_op<kBF16>(op, n, grid, st, xi, o, words, lowest, zero);
      break;
    case kI32:
      rc = launch_chain_op<kI32>(op, n, grid, st, xi, o, words, lowest, zero);
      break;
    case kI16:
      rc = launch_chain_op<kI16>(op, n, grid, st, xi, o, words, lowest, zero);
      break;
    case kI8:
      rc = launch_chain_op<kI8>(op, n, grid, st, xi, o, words, lowest, zero);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// words: 32-bit words of x, y and out; dtype 0 f32, 1 bf16, 2 int32,
// 3 int16; n (ops, two per pair) one of 16, 96, 512, 2048; zero: 0
int dabjax_probe_pair_chain(const void* x, const void* y, void* out,
                            long long words, int dtype, int n, unsigned zero,
                            void* stream) {
  unsigned grid;
  if (!grid_of(words, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* xi = static_cast<const unsigned*>(x);
  const unsigned* yi = static_cast<const unsigned*>(y);
  unsigned* o = static_cast<unsigned*>(out);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_pair<kF32>(n, grid, st, xi, yi, o, words, zero);
      break;
    case kBF16:
      rc = launch_pair<kBF16>(n, grid, st, xi, yi, o, words, zero);
      break;
    case kI32:
      rc = launch_pair<kI32>(n, grid, st, xi, yi, o, words, zero);
      break;
    case kI16:
      rc = launch_pair<kI16>(n, grid, st, xi, yi, o, words, zero);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // extern "C"
