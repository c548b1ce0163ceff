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

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
// What bounds it on the card: a sequential chain of T dependent 8-byte
// loads per codeword (the next state selects which decision bit to read)
// and B * nbits int32 stores.  Design: one thread per codeword; the load
// address does not depend on the state, so the loads of successive steps
// can be in flight together, and only the bit extraction is on the
// dependent chain.  The decisions were written by K1 just before and are
// mostly still in the 50 MB L2 at the main-path shapes.
__global__ void __launch_bounds__(128)
traceback(const uint2* __restrict__ dec,  // [B, T] decision words
          int32_t* __restrict__ bits,     // [B, nbits]
          int B, int T, int nbits) {
  const int cw = blockIdx.x * blockDim.x + threadIdx.x;
  if (cw >= B) return;
  const uint2* d = dec + static_cast<size_t>(cw) * T;
  int32_t* out = bits + static_cast<size_t>(cw) * nbits;
  int state = 0;
  for (int t = T - 1; t >= 0; --t) {
    if (t < nbits) out[t] = state & 1;
    const uint2 w = d[t];
    const unsigned word = (state < 32) ? w.x : w.y;
    const int bit = (word >> (state & 31)) & 1;
    state = (state >> 1) | (bit << 5);
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
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  traceback<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(dec), static_cast<int32_t*>(bits), B, T,
      nbits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
