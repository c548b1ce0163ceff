// The MSC front end on Hopper (sm_90a): one shape bucket's subchannels,
// read from the CIF block where they lie, time de-interleaved,
// depunctured and cast to int8, stored as K1's input.  Plain C interface,
// loaded with ctypes by dabjax_torch/msc/front_cuda.py; the entry point
// launches on the caller's stream and returns cudaGetLastError() of its
// launch.
//
// It replaces no TPU kernel: dabjax leaves this work to XLA (slices, a
// stack, a one-hot depuncture).  Its plain version is the torch chain
// step_soft(depuncture_profile(time_deinterleave(msc_soft(block)))) over
// the bucket's slices (msc/subchannel.py full_rate_torch), which runs a
// full pass over device memory for each of its gathers, stacks, cats and
// casts.
//
// What it computes.  Rows r < H of the block are head's, rows H .. H+N-1
// tail's (the decoder's CIF history, then the new CIFs), at one row
// stride.  Subchannel b's transmitted soft bit i of row r is the element
// at column 64 starts[b] + i.  Output frame t, full-rate position j of
// subchannel b is 0 where j is punctured, and where j carries transmitted
// bit i it is
//   soft8(row t + 15 - DELAYS[i % 16], column i),
// soft8 being viterbi_cuda.to_int8: clip to +-127, truncate toward zero
// (+-inf to +-127).  A NaN gives 0 here (__float2int_rz); the chain's
// clamp keeps the NaN and its cast then gives what torch's float -> int8
// cast gives on the card (0 on an H100).  An int8 block passes as it is,
// as to_int8 passes an int8 tensor.  Transmitted bits past the profile's
// n_tx (UEP padding) are never read.
//
// What bounds it: bytes.  At the core cell's bucket (12 subchannels of
// 4608 soft bits over 1455 CIFs, 1440 frames of 9240 bytes out) it reads
// 322 MB and writes 160 MB, 0.144 ms at 3.35 TB/s; its operations (a
// shared load, a conversion, a clamp and a shift an output byte) are
// several times below that.  It runs 0.198 ms there (NVIDIA H100 80GB
// HBM3, 700 W; the torch chain 2.70 ms).  What set its pace, measured:
// the blocks resident on an SM, not the rows in flight.  A ring of 32
// rows with 16 in flight and two words a thread (3 blocks an SM) ran
// 0.302 ms; one word a thread 0.233; rings of 24 rows (8 in flight) and
// of 20 (4 in flight, 10 blocks an SM) 0.211 and 0.198; 18 rows (2 in
// flight) no faster, 17 (1 in flight) 0.236.
//
// Design, per block: one chunk of the full-rate codeword (at most
// kThreads * kWords words) of one subchannel, over one run of frames.
//  * The chunk's output bytes draw on one contiguous run of transmitted
//    columns (the depuncture keeps their order), at most kMaxWidth wide;
//    the host cuts the codeword into chunks and aligns each run to 16
//    elements (front_cuda.front_table).  The block copies that run of
//    each row it needs, in row order, by 16-byte cp.async into a ring of
//    kRing rows in shared memory, kAhead rows ahead of the row in use.
//  * Output frame f (block-relative) reads rows f .. f + 15, so it is
//    complete once row f + 15 has landed: one barrier a row, then each
//    thread gathers its output bytes from the ring, casts them and stores
//    one 4-byte word per kWords, neighbouring threads on neighbouring
//    words (coalesced).  A thread's bytes have fixed sources relative to
//    the frame's first row, so their ring offsets are computed once, into
//    registers; a frame adds its row's slot and wraps.
//  * Each input element is read from device memory once (a run of frames
//    re-reads the 15 rows before it) and each output byte is written
//    once.  The frames are cut into runs only as far as the card needs
//    blocks to fill it (launch()), at least kMinFrames a run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // a block's threads
constexpr int kWords = 1;       // output words (4 bytes) a thread a frame
constexpr int kSpan = 16;       // rows an output frame reads: HISTORY + 1
constexpr int kAhead = 4;       // rows in flight ahead of the newest in use
constexpr int kRing = 20;       // rows of the shared ring
constexpr int kMaxWidth = 512;  // a chunk's columns, at most
constexpr int kMinFrames = 64;  // fewest frames a run of frames
static_assert(kRing >= kSpan + kAhead,
              "the ring holds a frame's rows and the rows in flight");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies of all rows but the newest kAhead - 1 have landed
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ int soft8(float x) {
  return min(max(__float2int_rz(x), -127), 127);
}

__device__ __forceinline__ int soft8(int8_t x) { return x; }

// Grid (chunks, subchannels, runs of frames).  chunks[c] = (first column,
// columns) of chunk c's run of transmitted columns; codes[j] for output
// position j of the codeword (chunk c's words from c * chunk_words):
// -1 where j is punctured (or past out_len), else (d << 16) | column,
// the column counted from the chunk's first and d = 15 - DELAYS[i % 16]
// the row after the frame's first.
template <typename In>
__global__ void __launch_bounds__(kThreads)
msc_front(const In* __restrict__ head, const In* __restrict__ tail, int H,
          long long ld, const long long* __restrict__ starts,
          const int2* __restrict__ chunks, const int* __restrict__ codes,
          int chunk_words, int width, int out_len, int T_out, int per_run,
          int8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = blockIdx.z * per_run;
  const int t1 = min(T_out, t0 + per_run);
  if (t0 >= t1) return;
  const int row_bytes = width * static_cast<int>(sizeof(In));
  const int ring_bytes = kRing * row_bytes;
  const int2 chunk = chunks[c];
  const long long col0 = starts[b] * 64 + chunk.x;
  const int j0 = c * chunk_words * 4;
  const int words = min(chunk_words, (out_len - j0) / 4);

  // each output byte's ring offset for a frame whose first row is in
  // slot 0, or -1 where it is punctured
  int off[kWords][4];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int w = threadIdx.x + k * kThreads;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int code = w < words ? codes[j0 + 4 * w + q] : -1;
      off[k][q] = code < 0 ? -1
                           : (code >> 16) * row_bytes
                                 + (code & 0xffff)
                                       * static_cast<int>(sizeof(In));
    }
  }

  constexpr int kVec = 16 / sizeof(In);
  const int copies = chunk.y / kVec;
  const int n_rows = t1 - t0 + kSpan - 1;
  int next_slot = 0;     // the ring slot of the next row issued
  auto issue = [&](int k) {
    if (k < n_rows) {
      const int r = t0 + k;
      const In* src = (r < H ? head + static_cast<long long>(r) * ld
                             : tail + static_cast<long long>(r - H) * ld)
                      + col0;
      unsigned char* dst = ring + next_slot * row_bytes;
      for (int v = threadIdx.x; v < copies; v += kThreads)
        cp_async16(dst + 16 * v, src + kVec * v);
    }
    cp_async_commit();   // an empty group past the last row keeps the count
    next_slot = next_slot + 1 == kRing ? 0 : next_slot + 1;
  };
#pragma unroll 1
  for (int k = 0; k < kAhead; ++k) issue(k);

  int8_t* dst = out + (static_cast<long long>(b) * T_out + t0) * out_len + j0;
  int base = 0;          // the ring offset of the next frame's first row
#pragma unroll 1
  for (int k = 0; k < n_rows; ++k) {
    cp_async_wait_ahead();
    __syncthreads();     // row k landed; every read of row k - kAhead done
    issue(k + kAhead);   // into the slot row k + kAhead - kRing left
    if (k < kSpan - 1) continue;
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
      const int w = threadIdx.x + kk * kThreads;
      if (w < words) {
        unsigned word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (off[kk][q] >= 0) {
            int a = base + off[kk][q];
            if (a >= ring_bytes) a -= ring_bytes;
            const int v = soft8(*reinterpret_cast<const In*>(ring + a));
            word |= (static_cast<unsigned>(v) & 0xffu) << (8 * q);
          }
        }
        *reinterpret_cast<unsigned*>(dst + 4 * w) = word;
      }
    }
    dst += out_len;
    base += row_bytes;
    if (base == ring_bytes) base = 0;
  }
}

// The kernel's shared-memory limit, raised once per device (before any
// capture: the first call of a key runs eagerly) to the widest ring.
template <typename In>
int allow_ring(int dev) {
  static bool done[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        msc_front<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRing * kMaxWidth * static_cast<int>(sizeof(In)));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    done[dev] = true;
  }
  return 0;
}

template <typename In>
int launch(const void* head, const void* tail, int H, int N, long long ld,
           const void* starts, int n_subch, const void* chunks,
           const void* codes, int n_chunks, int chunk_words, int width,
           int out_len, void* out, cudaStream_t st) {
  if (width <= 0 || width > kMaxWidth || width % (16 / sizeof(In)) != 0
      || chunk_words > kThreads * kWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T_out = H + N - (kSpan - 1);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  const int rc = allow_ring<In>(dev);
  if (rc != 0) return rc;
  const int smem = kRing * width * static_cast<int>(sizeof(In));
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, msc_front<In>,
                                                kThreads, smem);
  // runs of frames: enough blocks for every slot of the card, no run
  // under kMinFrames frames
  const long long slots = static_cast<long long>(per_sm < 1 ? 1 : per_sm)
                          * sms;
  long long runs = slots / (static_cast<long long>(n_chunks) * n_subch);
  const int most = T_out / kMinFrames;
  if (runs > most) runs = most;
  if (runs < 1) runs = 1;
  const int per_run = static_cast<int>((T_out + runs - 1) / runs);
  const dim3 grid(n_chunks, n_subch, (T_out + per_run - 1) / per_run);
  msc_front<In><<<grid, kThreads, smem, st>>>(
      static_cast<const In*>(head), static_cast<const In*>(tail), H, ld,
      static_cast<const long long*>(starts), static_cast<const int2*>(chunks),
      static_cast<const int*>(codes), chunk_words, width, out_len, T_out,
      per_run, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// head [H rows], tail [N rows] (tail may equal head when N is 0): float32
// (i8 0) or int8 (i8 1) rows at the row stride ld elements, 16-byte
// aligned, ld a multiple of 16 bytes; starts int64 [n_subch] in units of
// 64 elements; chunks int32 [n_chunks, 2]; codes int32 [n_chunks *
// chunk_words * 4]; out int8 [n_subch, H + N - 15, out_len], contiguous,
// out_len a multiple of 4.
int dabjax_msc_front(const void* head, const void* tail, int i8, int H,
                     int N, long long ld, const void* starts, int n_subch,
                     const void* chunks, const void* codes, int n_chunks,
                     int chunk_words, int width, int out_len, void* out,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (i8)
    return launch<int8_t>(head, tail, H, N, ld, starts, n_subch, chunks,
                          codes, n_chunks, chunk_words, width, out_len, out,
                          st);
  return launch<float>(head, tail, H, N, ld, starts, n_subch, chunks, codes,
                       n_chunks, chunk_words, width, out_len, out, st);
}

}  // extern "C"
