// OFDM demodulation of frame rows for Hopper (sm_90a): the guard
// correlation, the CFO-mixed FFT windows before the FFT and the DQPSK
// soft bits after it.  Plain C interface, loaded with ctypes by
// dabjax_torch/ofdm/demod_cuda.py; every entry point launches on the
// caller's stream and returns cudaGetLastError() of its launch.
//
// They replace no TPU kernel: dabjax's demod (dabjax/ofdm/demod.py,
// fine_cfo_estimate and demodulate_frames_cfo) is a jnp chain that XLA
// fuses around its FFT.  Eager PyTorch ran the same chain as about 55
// elementwise, gather, cat and copy passes over the full-rate stream
// (about 21 GB a 360-frame mode I block); these three kernels and the
// one cuFFT call between them move about 1.3 GB.
//
// What bounds them: bytes.  Each does a few float operations per 8 to
// 16 bytes it moves, so each is held to reading its input once and
// writing its output once, a warp's accesses on neighbouring addresses:
//  * guard_corr reads each symbol's guard and its copy T_u later
//    (54 MB a core block in u8) and writes one float a frame;
//  * mix_windows reads the T_u useful samples of each symbol (112 MB
//    in u8) and writes the complex64 windows cuFFT reads (448 MB) in
//    16-byte stores, 512 contiguous bytes a warp (a first version
//    whose lanes each wrote 64 contiguous bytes ran at 3.45x the bound);
//    the ramp's cos / sin depend on the frame and the sample only, so a
//    thread computes them once for its 8 samples and reuses them over a
//    run of symbols, and no [F, T_u] table goes through memory;
//  * dqpsk_soft reads the K active carriers of each spectrum once (a
//    thread keeps carrier k of symbol l - 1 in a register for symbol l;
//    one block holds a frame's carriers, so the carrier gather is served
//    by its SM's L1) and writes the soft bits once, the FIC symbols and
//    the MSC symbols each straight into the tensor the next stage reads.
//
// Arithmetic: every elementwise operation of mix_windows and dqpsk_soft
// is the plain path's (demod.demodulate_frames_cfo_torch), in its order
// and rounded as its own pass rounds it: __fmul_rn / __fadd_rn /
// __fsub_rn are never contracted into an FMA, and cosf, sinf, rsqrtf
// and rintf are what ATen's CUDA kernels call.  Given the same CFO the
// soft bits and the spectra are bit-identical to the plain path's.
// The build must not flush subnormals (no --use_fast_math, no -ftz):
// 1e-38 is subnormal, and flushed it gives rsqrt(0) and NaN soft bits
// on an all-zero input.
//
// guard_corr sums in a fixed order (per-thread partials, then a
// shuffle and shared-memory tree in double; no atomics), so its result
// repeats from run to run; u8 terms are summed in integers, exactly,
// float terms in double.

#include <cuda_runtime.h>

namespace {

constexpr int kGuardThreads = 512;
constexpr int kMixV = 8;             // samples a thread
constexpr int kMixThreads = 128;
constexpr int kSoftCarriers = 3;     // carriers a thread; K / 3 threads
constexpr int kWaves = 2;            // resident thread sets a launch fills

// Sample i of a row as (re, im) floats: u8 pairs as (u - 128) / 128,
// the plain path's conversion, which is exact; float pairs as they are.
__device__ __forceinline__ float u8_sample(unsigned int u) {
  return __fmul_rn(__fsub_rn(static_cast<float>(u), 128.0f), 0.0078125f);
}

__device__ __forceinline__ float2 sample(const uchar2* row, long long i) {
  const uchar2 u = row[i];
  return make_float2(u8_sample(u.x), u8_sample(u.y));
}

__device__ __forceinline__ float2 sample(const float2* row, long long i) {
  return __ldg(row + i);
}

// The guard correlation's running sum g * conj(ref): of u8 pairs in
// integers ((u - 128) products, exact; at most 2^15 a term and 74 terms
// a thread in mode I), of float pairs in double.  Either way `re()` /
// `im()` are the thread's partial sums as doubles.
template <typename T> struct GuardSum;

template <> struct GuardSum<uchar2> {
  int sre = 0, sim = 0;
  __device__ __forceinline__ void add(const uchar2* row, long long at,
                                      int T_u) {
    const uchar2 a = row[at], b = row[at + T_u];
    const int gx = a.x - 128, gy = a.y - 128, rx = b.x - 128,
              ry = b.y - 128;
    sre += gx * rx + gy * ry;
    sim += gy * rx - gx * ry;
  }
  __device__ __forceinline__ double re() const { return sre / 16384.0; }
  __device__ __forceinline__ double im() const { return sim / 16384.0; }
};

template <> struct GuardSum<float2> {
  double sre = 0.0, sim = 0.0;
  __device__ __forceinline__ void add(const float2* row, long long at,
                                      int T_u) {
    const float2 g = sample(row, at), r = sample(row, at + T_u);
    sre += static_cast<double>(g.x) * r.x + static_cast<double>(g.y) * r.y;
    sim += static_cast<double>(g.y) * r.x - static_cast<double>(g.x) * r.y;
  }
  __device__ __forceinline__ double re() const { return sre; }
  __device__ __forceinline__ double im() const { return sim; }
};

// The fine CFO of frame blockIdx.x: the guard-interval correlation
// sum_{l >= 1, j < T_g} g * conj(ref), g = row[l T_s - T_g + j], ref the
// sample T_u later; its angle as Hz, -angle / pi * half_cd.  With
// `cfo`, also writes fine + coarse (coarse 0 where it is null).
template <typename T>
__global__ void __launch_bounds__(kGuardThreads)
guard_corr(const T* __restrict__ rows, long long row_stride, int T_s,
           int T_u, int T_g, int L, float half_cd,
           const float* __restrict__ coarse, float* __restrict__ fine,
           float* __restrict__ cfo) {
  const int f = blockIdx.x;
  const T* row = rows + f * row_stride;
  const int n = (L - 1) * T_g;
  // term i is sample j = i % T_g of symbol l = 1 + i / T_g's guard; a
  // thread steps i by kGuardThreads, so (l, j) by (dl, dj) and a carry
  const int dl = kGuardThreads / T_g, dj = kGuardThreads % T_g;
  int l = 1 + threadIdx.x / T_g, j = threadIdx.x % T_g;
  GuardSum<T> sum;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kGuardThreads) {
    sum.add(row, static_cast<long long>(l) * T_s - T_g + j, T_u);
    l += dl;
    j += dj;
    if (j >= T_g) {
      j -= T_g;
      ++l;
    }
  }
  double re = sum.re(), im = sum.im();
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    re += __shfl_down_sync(0xffffffffu, re, d);
    im += __shfl_down_sync(0xffffffffu, im, d);
  }
  __shared__ double part[kGuardThreads / 32][2];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[warp][0] = re;
    part[warp][1] = im;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    re = part[0][0];
    im = part[0][1];
    for (int w = 1; w < kGuardThreads / 32; ++w) {
      re += part[w][0];
      im += part[w][1];
    }
    // the correlation as complex64, as the plain sum returns it
    const float a = atan2f(static_cast<float>(im), static_cast<float>(re));
    const float hz = __fmul_rn(__fdiv_rn(-a, 3.14159265358979323846f),
                               half_cd);
    fine[f] = hz;
    if (cfo != nullptr)
      cfo[f] = coarse != nullptr ? __fadd_rn(hz, coarse[f]) : hz;
  }
}

// out[f, l, t] = x[f, l T_s + t] * e^{j w cfo[f] t} for t < T_u: the
// plain path's ramp, ang = (w * cfo) * t, mixed as (wr cr - wi ci,
// wr ci + wi cr).  Grid (T_u / (kMixV threads), F, symbol runs); a
// thread owns kMixV samples over one run of symbols: a warp 32 kMixV
// consecutive ones, lane `lane`'s pair j at 64 j + 2 lane, so each of
// the warp's 16-byte stores covers 512 consecutive bytes.
template <typename T>
__global__ void __launch_bounds__(kMixThreads)
mix_windows(const T* __restrict__ rows, long long row_stride, int T_s,
            int T_u, int L, float w, const float* __restrict__ cfo,
            float2* __restrict__ out) {
  const int f = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int t0 = (blockIdx.x * blockDim.x + threadIdx.x - lane) * kMixV
                 + 2 * lane;
  const int per = (L + gridDim.z - 1) / gridDim.z;
  const int l0 = blockIdx.z * per;
  if (l0 >= L) return;
  const int l1 = min(L, l0 + per);
  const float wc = __fmul_rn(w, cfo[f]);
  float cr[kMixV], ci[kMixV];
#pragma unroll
  for (int v = 0; v < kMixV; ++v) {
    const int t = t0 + 64 * (v / 2) + v % 2;
    const float ang = __fmul_rn(wc, static_cast<float>(t));
    cr[v] = cosf(ang);
    ci[v] = sinf(ang);
  }
  const T* row = rows + f * row_stride + t0;
  float2* o = out + static_cast<long long>(f) * L * T_u + t0;
  for (int l = l0; l < l1; ++l) {
    const T* x = row + static_cast<long long>(l) * T_s;
    float2* dst = o + static_cast<long long>(l) * T_u;
#pragma unroll
    for (int v = 0; v < kMixV; v += 2) {
      float m[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 s = sample(x, 64 * (v / 2) + h);
        m[2 * h] = __fsub_rn(__fmul_rn(s.x, cr[v + h]),
                             __fmul_rn(s.y, ci[v + h]));
        m[2 * h + 1] = __fadd_rn(__fmul_rn(s.x, ci[v + h]),
                                 __fmul_rn(s.y, cr[v + h]));
      }
      *reinterpret_cast<float4*>(dst + 64 * (v / 2)) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
  }
}

// Soft bits of data symbol s = l - 1 of frame blockIdx.y from spectra l
// and l - 1 at carrier bins[k]: r1 = F_l conj(F_{l-1}), rotated by
// e^{j w cfo T_s}, then -r1 rsqrt(|r1|^2 + 1e-38) * 127 rounded half to
// even; real parts at [k], imaginary at [K + k] of the symbol's 2K.
// Symbols s < fic go to fic_out (frame stride fic_stride), the others
// to msc_out (frame stride msc_stride).  Block: K / kSoftCarriers
// threads, all the frame's carriers; grid.x runs of symbols.
__global__ void dqpsk_soft(const float2* __restrict__ spec,
                           const int* __restrict__ bins, int T_u, int L,
                           int K, int fic, float w, float T_s,
                           const float* __restrict__ cfo,
                           float* __restrict__ fic_out, long long fic_stride,
                           float* __restrict__ msc_out,
                           long long msc_stride) {
  const int f = blockIdx.y;
  const int per = (L - 1 + gridDim.x - 1) / gridDim.x;
  const int l0 = 1 + blockIdx.x * per;
  if (l0 >= L) return;
  const int l1 = min(L, l0 + per);
  const float pang = __fmul_rn(__fmul_rn(w, cfo[f]), T_s);
  const float pr = cosf(pang), pi = sinf(pang);
  const float2* s = spec + static_cast<long long>(f) * L * T_u;
  int bin[kSoftCarriers];
  float2 prev[kSoftCarriers];
#pragma unroll
  for (int c = 0; c < kSoftCarriers; ++c) {
    bin[c] = bins[threadIdx.x + c * blockDim.x];
    prev[c] = __ldg(s + static_cast<long long>(l0 - 1) * T_u + bin[c]);
  }
  for (int l = l0; l < l1; ++l) {
    const int sym = l - 1;
    float* o = sym < fic
        ? fic_out + f * fic_stride + static_cast<long long>(sym) * 2 * K
        : msc_out + f * msc_stride
              + static_cast<long long>(sym - fic) * 2 * K;
#pragma unroll
    for (int c = 0; c < kSoftCarriers; ++c) {
      const float2 cur = __ldg(s + static_cast<long long>(l) * T_u + bin[c]);
      const float r1re = __fadd_rn(__fmul_rn(cur.x, prev[c].x),
                                   __fmul_rn(cur.y, prev[c].y));
      const float r1im = __fsub_rn(__fmul_rn(cur.y, prev[c].x),
                                   __fmul_rn(cur.x, prev[c].y));
      const float re = __fsub_rn(__fmul_rn(r1re, pr), __fmul_rn(r1im, pi));
      const float im = __fadd_rn(__fmul_rn(r1re, pi), __fmul_rn(r1im, pr));
      const float inv = rsqrtf(__fadd_rn(
          __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), 1e-38f));
      const int k = threadIdx.x + c * blockDim.x;
      o[k] = rintf(__fmul_rn(__fmul_rn(-re, inv), 127.0f));
      o[K + k] = rintf(__fmul_rn(__fmul_rn(-im, inv), 127.0f));
      prev[c] = cur;
    }
  }
}

// Runs of symbols a launch cuts `symbols` into, so that about kWaves
// full sets of resident threads run when `threads` threads cover one
// run of every frame.
int runs_for(long long threads, int symbols) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                         dev);
  const long long want = static_cast<long long>(kWaves) * sms * per_sm;
  const long long runs = (want + threads - 1) / threads;
  return static_cast<int>(runs < 1 ? 1 : runs > symbols ? symbols : runs);
}

}  // namespace

extern "C" {

// `u8`: rows are uint8 (re, im) pairs, else float32 pairs (or complex64);
// row_stride in samples.  coarse and cfo may be null.
int dabjax_demod_guard_corr(const void* rows, int u8, long long row_stride,
                            int F, int T_s, int T_u, int T_g, int L,
                            float half_cd, const void* coarse, void* fine,
                            void* cfo, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coarse);
  float* fi = static_cast<float*>(fine);
  float* cf = static_cast<float*>(cfo);
  if (u8)
    guard_corr<<<F, kGuardThreads, 0, st>>>(
        static_cast<const uchar2*>(rows), row_stride, T_s, T_u, T_g, L,
        half_cd, c, fi, cf);
  else
    guard_corr<<<F, kGuardThreads, 0, st>>>(
        static_cast<const float2*>(rows), row_stride, T_s, T_u, T_g, L,
        half_cd, c, fi, cf);
  return static_cast<int>(cudaGetLastError());
}

// out: complex64 [F, L, T_u], contiguous; T_u a multiple of 32 kMixV
// (every mode's FFT size).
int dabjax_demod_mix_windows(const void* rows, int u8, long long row_stride,
                             int F, int T_s, int T_u, int L, float w,
                             const void* cfo, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_frame = T_u / kMixV;
  const int threads = per_frame < kMixThreads ? per_frame : kMixThreads;
  const dim3 grid(per_frame / threads, F,
                  runs_for(static_cast<long long>(F) * per_frame, L));
  const float* c = static_cast<const float*>(cfo);
  float2* o = static_cast<float2*>(out);
  if (u8)
    mix_windows<<<grid, threads, 0, st>>>(
        static_cast<const uchar2*>(rows), row_stride, T_s, T_u, L, w, c, o);
  else
    mix_windows<<<grid, threads, 0, st>>>(
        static_cast<const float2*>(rows), row_stride, T_s, T_u, L, w, c, o);
  return static_cast<int>(cudaGetLastError());
}

// spec: complex64 [F, L, T_u], contiguous; bins: int32 [K], K a multiple
// of kSoftCarriers * 32.
int dabjax_demod_dqpsk_soft(const void* spec, const void* bins, int F,
                            int T_s, int T_u, int L, int K, int fic, float w,
                            const void* cfo, void* fic_out,
                            long long fic_stride, void* msc_out,
                            long long msc_stride, void* stream) {
  const int threads = K / kSoftCarriers;
  const dim3 grid(runs_for(static_cast<long long>(F) * threads, L - 1), F);
  dqpsk_soft<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const int*>(bins), T_u,
      L, K, fic, w, static_cast<float>(T_s), static_cast<const float*>(cfo),
      static_cast<float*>(fic_out), fic_stride,
      static_cast<float*>(msc_out), msc_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
