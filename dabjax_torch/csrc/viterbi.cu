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
// 384 kbit/s subchannel.  K1, and K3 under its int8 formats after its
// first word, keep 16-bit metrics relative to state 0 and renormalise
// once a tile (see K1); K3's first word keeps the format's int32 or float
// metrics from dabjax's start values, and K3 under "f32" (unclipped soft)
// float metrics throughout.

#include <cstdint>
#include <type_traits>
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
// (kFwTile, kFwPhases, kLive, kDead, rotl5 and the core's step, U16Core,
// are in acs.cuh: K3 and the plane forward probe run this core too)
constexpr int kFwWarps = 4;                   // warps (codewords) of a block

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

  U16Core core;
  core.init(signs, lane);
  // new pair (2v, 2v + 1) of the lane, v = rotl5(lane, -1): state 0 is
  // the low half of lane 0, in every phase
  core.n = kDead * 0x10001u;
  if (lane == 0) core.n = kLive | (kDead << 16);

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
    if (k) core.renorm();
    core.tile(buf, lane,
              [&](int j, unsigned dec_lo, unsigned dec_hi) {
                if (lane == 0) ds[warp][j] = make_uint2(dec_lo, dec_hi);
              },
              [](int, unsigned, unsigned) {});
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
// The packed epilogue (kPacked, the MSC chain on the card) stores the
// logical-frame bytes themselves in place of the bits: after a tile the
// lane's `mask` holds its codeword's 32 bits of the tile (bit j is step
// 32k + j), so it XORs the matching 32-bit word of the energy-dispersal
// PRBS (`prbs`, in the same bit order), reverses the bits of each byte
// (np.packbits order, MSB first) and lanes 0 .. 15 store the tile's 4
// bytes into their codeword's row of [B, nbits / 8] uint8 (nbits a
// multiple of 8; one 32-bit store when the rows are 4-byte aligned, as
// for every DAB size, else a byte at a time), with no shuffle: 4 bytes
// of a tile in place of 128 of int32 bits, and no pass of a bit plane
// left for the dispersal and the pack.
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

template <bool kVec16, bool kPacked>
__global__ void __launch_bounds__(32 * kTbWarps)
traceback(const uint2* __restrict__ dec,      // [B, T] decision words
          void* __restrict__ out,             // [B, nbits] int32 bits, or
                                              // [B, nbits / 8] bytes
          const uint32_t* __restrict__ prbs,  // [ceil(nbits / 32)] (packed)
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
    if constexpr (kPacked) {
      const int nbytes = nbits >> 3;
      const int b0 = k * (kTbSteps / 8);      // the tile's first byte
      if (lane < kTbCw && cw0 + lane < B && b0 < nbytes) {
        // byte i of v is byte i of the dispersed mask, bits reversed
        const unsigned v = __byte_perm(__brev(mask ^ prbs[k]), 0, 0x0123);
        uint8_t* row = static_cast<uint8_t*>(out) +
                       static_cast<size_t>(cw0 + lane) * nbytes;
        if ((nbytes & 3) == 0 && b0 + 4 <= nbytes) {
          *reinterpret_cast<uint32_t*>(row + b0) = v;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (b0 + i < nbytes) row[b0 + i] = static_cast<uint8_t>(v >> 8 * i);
        }
      }
    } else {
      int32_t* bits = static_cast<int32_t*>(out);
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
// What bounds it on the card: as K1, a chain of T dependent radix-2 steps
// per codeword, one warp a codeword, so the number of instructions a step
// takes; on top of K1's step, the repack of each tile's votes into words.
// A radix-4 decision is two radix-2 decisions: for new state n at pair
// step tau, d1 is n's decision at trellis step 2tau+1 and d0 that of
// q = (n >> 1) | (d1 << 5) at step 2tau, because both candidates of an
// inner maximum pass through q and add the same second-step branch
// metric; with strict '>' in both (acs.cuh select4) ties agree too, as
// long as the metrics are exact.  They are once every state is live
// (after pair step 2) except where dabjax's -1e9 float start rounds, in
// the first pair steps.  Design, per warp and codeword:
//  * Word 0 (pair steps 0-15) runs dabjax's radix-4 recursion with its
//    own metric type and start (k3_word0): lane l holds states l and
//    l + 32, 8 metric shuffles a pair step.  That gives the float
//    formats' rounded word 0 and costs 16 of the 1155 pair steps of the
//    MSC shape.
//  * From tile 1 on (a tile of kFwTile = 32 trellis steps is one word of
//    16 pair steps) K1's in-place core runs, started from word 0's
//    metrics moved into K1's tile-start layout: one exchange shuffle a
//    step, votes into shared memory, one shuffle a tile.  i8mxu and i8
//    (|soft| <= 127) use K1's u16x2 metrics relative to state 0, exact
//    within K1's bounds.  f32 is not clipped (|soft| may pass 127), so it
//    keeps one float metric a state with IEEE adds, two a lane, and still
//    one shuffle a step: the lane sends the metric that leaves and keeps
//    the one that stays.  Its words are exact while the metrics are
//    integers below 2^24 in magnitude (|soft| * 4 * T), as the TPU
//    kernel's own rounding-free range.
//  * Word pack: lane l turns the tile's 64 vote words into the words of
//    states l and l + 32 (two bit extractions a state and pair, at K1's
//    rotated positions; see k3_pack_pair) and the warp stores the 64
//    words of the word index as one 256-byte row.  The pack costs about
//    as much as the core: 0.16 of 0.35 ms at the MSC shape (measured with
//    it taken out), the reason K3 is twice K1.
// Word padding: pair steps >= T2 of the last word are masked to e = 0
// (the core's last tile runs its 32 steps on zero soft).  last[b], state
// 0's radix-2 decision at step 2(T2-1), is bit 0 of that step's low vote
// word (or word 0's `da`): when T is odd that is the true last trellis
// step, and the word layout, whose last pair ends on a zero-soft padding
// step, does not keep it when d1 = 1 (see K4).  The output layout is
// [B, W, 64]; the wrapper returns it as the [W, 64, B] view of the TPU
// kernel's output.
constexpr int kWdWarps = 4;                   // warps (codewords) of a block

// (k3_word0, word 0, k3_pack_pair, the u16 core's pack, and the u16 core,
// U16Core, are in acs.cuh: the plane forward probe runs them too)

// The pack: the radix-4 words of states lane (acc_a) and lane + 32
// (acc_b) of one tile from its vote words (low word, high word of each
// step).  Pair jp's d1 is n's decision at step 2jp + 1 (word n & 1 =
// lane & 1, bit rotr5(n >> 1, ph1)); its d0 is q's at step 2jp (word
// q & 1 = (lane >> 1) & 1, bit rotr5(q >> 1, ph0) = rotr5(n >> 2, ph0) +
// (d1 << (4 - ph0)): d1 is bit 4 of q >> 1, and its place after the
// rotation is a constant of the unrolled pair).  State lane + 32 adds the
// constant rotr5(16, ph1) to the first position and rotr5(8, ph0) to the
// second (bits that are clear there).  About 15 instructions a pair for
// both states, in two forms, each the faster one for its core (measured):
//  * k3_pack_pair (acs.cuh), integer-ALU: each bit fetched by one funnel
//    rotation that puts it where the word wants it (bit 2jp for d1,
//    2jp + 1 for d0) and merged under a constant mask;
//    p1[ph] = rotr5(lane >> 1, ph), p0[ph] = rotr5(lane >> 2, ph)
//    (k3_pack_positions).  The u16 core calls it as soon as a pair's two
//    steps are voted (0.338 ms against 0.348 after the tile).
//  * k3_pack_imad, multiplies: x * 2^(31 - p) puts bit p at bit 31 and
//    hi(y * 2) takes it (IMAD, IMAD.HI), so the pack runs beside the
//    float core's integer work; m1[ph] = 2^(31 - p1 - rotr5(16, ph)) and
//    m0[ph] = 2^(31 - p0 - rotr5(8, ph) - rotr5(16, ph)) put the highest
//    of a pair's candidate bits at 31, and a multiplier chosen by d1
//    moves the wanted one there.  After the tile (0.444 ms against 0.475
//    with k3_pack_pair, 0.490 with it in the steps).

__device__ __forceinline__ void k3_pack_imad(const uint2* __restrict__ v,
                                             const unsigned (&m1)[kFwPhases],
                                             const unsigned (&m0)[kFwPhases],
                                             int lane, unsigned& acc_a,
                                             unsigned& acc_b) {
  const unsigned* w1p = reinterpret_cast<const unsigned*>(v) + (lane & 1);
  const unsigned* w0p =
      reinterpret_cast<const unsigned*>(v) + ((lane >> 1) & 1);
  unsigned two = 2;
  asm volatile("" : "+r"(two));     // a multiply, not a shift: IMAD.HI
  acc_a = 0;
  acc_b = 0;
#pragma unroll
  for (int jp = 0; jp < kFwTile / 2; ++jp) {
    const int ph1 = (2 * jp + 1) % kFwPhases, ph0 = (2 * jp) % kFwPhases;
    const unsigned c = 1u << (4 - ph0);            // rotr5(16, ph0)
    const unsigned s1 = 16u >> ph1;                // rotr5(16, ph1)
    const unsigned s0 = static_cast<unsigned>(rotl5(8, -ph0));
    // d1 of lane + 32 at bit 31, of lane at bit 31 - s1
    const unsigned t1 = w1p[2 * (2 * jp + 1)] * m1[ph1];
    const unsigned d1b = __umulhi(t1, two);
    const unsigned d1a = __umulhi(t1 * (1u << s1), two);
    // q's candidates at 31 - {s0 + c, s0, c, 0}: (lane, d1 = 0), (lane,
    // 1), (lane + 32, 0), (lane + 32, 1)
    const unsigned t0 = w0p[2 * (2 * jp)] * m0[ph0];
    const unsigned ma =
        (1u << (s0 + c)) - d1a * ((1u << (s0 + c)) - (1u << s0));
    const unsigned mb = (1u << c) - d1b * ((1u << c) - 1u);
    const unsigned d0a = __umulhi(t0 * ma, two);
    const unsigned d0b = __umulhi(t0 * mb, two);
    acc_a += d1a * (1u << (2 * jp)) + d0a * (2u << (2 * jp));
    acc_b += d1b * (1u << (2 * jp)) + d0b * (2u << (2 * jp));
  }
}

template <typename M0, typename S, bool kF32, int kMinBlocks>
__global__ void __launch_bounds__(32 * kWdWarps, kMinBlocks)
forward_acs_words(const typename S::Pair* __restrict__ soft,   // [B, T2]
                  const typename S::Pair* __restrict__ signs,  // [256]
                  const int32_t* __restrict__ bsigns,          // [32]
                  int32_t* __restrict__ dec,                   // [B, W, 64]
                  int32_t* __restrict__ last,                  // [B]
                  int B, int T2, M0 start) {
  // a trellis step: four int8 soft values, or four floats
  using Step = typename std::conditional<kF32, float4, int32_t>::type;
  __shared__ __align__(16) int32_t xs[kWdWarps][2][kFwTile];
  // f32: the 16 signed sums of each step's four soft values, [pattern]
  // [step], rows padded so that a step's 16 and a pattern's 32 are in
  // distinct banks
  __shared__ float bms[kWdWarps][kF32 ? 16 : 1][kFwTile + 1];
  __shared__ __align__(16) uint2 ds[kWdWarps][kFwTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kWdWarps + warp;
  if (cw >= B) return;  // whole warps exit together
  const int W = (T2 + kPairsPerWord - 1) / kPairsPerWord;
  const typename S::Pair* s = soft + static_cast<size_t>(cw) * T2;
  int32_t* d = dec + static_cast<size_t>(cw) * W * 64;

  M0 pm_lo, pm_hi;
  bool da0 = false;
  k3_word0<M0, S>(s, signs, d, min(kPairsPerWord, T2), start, lane, pm_lo,
                  pm_hi, da0);
  if (W == 1) {
    if (lane == 0) last[cw] = da0 ? 1 : 0;
    return;
  }

  // From tile 1 on: K1's core in its tile-start layout (lane L holds new
  // states 2v and 2v + 1, v = rotl5(L, -1); word 0 left state s in lane
  // s & 31, half s >> 5), on u16x2 metrics (U16Core) or, under f32, on
  // float metrics with the lane's butterfly row of the branch-metric
  // table (bit k: sign k < 0), whether it keeps its high half after a
  // step of a phase (its exchanged lane bit) and the pack's multipliers,
  // by phase
  U16Core core;
  int p1[kFwPhases], p0[kFwPhases], pat[kFwPhases];
  unsigned m1[kFwPhases], m0[kFwPhases];
  bool up[kFwPhases];
  float f_lo = 0.f, f_hi = 0.f;
  if constexpr (kF32) {
    k1_tile_start(pm_lo, pm_hi, lane, f_lo, f_hi);
#pragma unroll
    for (int p = 0; p < kFwPhases; ++p) {
      const int sg = bsigns[rotl5(lane, p)];
      pat[p] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) pat[p] |= ((sg >> (8 * k + 7)) & 1) << k;
      up[p] = (lane >> (4 - p)) & 1;
      p1[p] = rotl5(lane >> 1, -p);
      p0[p] = rotl5(lane >> 2, -p);
      m1[p] = 1u << (31 - p1[p] - (16 >> p));
      m0[p] = 1u << (31 - p0[p] - rotl5(8, -p) - (16 >> p));
      // kept in registers (see K1)
      asm volatile("" : "+r"(m1[p]), "+r"(m0[p]), "+r"(pat[p]));
    }
  } else {
    core.init(bsigns, lane);
    k3_pack_positions(lane, p1, p0);
    core.start(pm_lo, pm_hi, lane);
  }
  const int back = rotl5(lane, -((kFwTile - 1) % kFwPhases + 1));

  const Step* st = reinterpret_cast<const Step*>(s);
  const int T = 2 * T2;                          // trellis steps, padded
  Step zero{};
  Step w = (kFwTile + lane < T) ? st[kFwTile + lane] : zero;
  for (int k = 1; k < W; ++k) {
    const int t0 = k * kFwTile;
    int32_t* buf = xs[warp][k & 1];
    if constexpr (kF32) {
      // lane j: the branch metrics of step j for every sign pattern
      // (integer soft: exact in any order)
      const float4 x = w;
      const float s01[4] = {x.x + x.y, x.y - x.x, x.x - x.y, -x.x - x.y};
      const float s23[4] = {x.z + x.w, x.w - x.z, x.z - x.w, -x.z - x.w};
#pragma unroll
      for (int p = 0; p < 16; ++p)
        bms[warp][p][lane] = s01[p & 3] + s23[p >> 2];
    } else {
      buf[lane] = w;
    }
    // also: every lane has read buffer k & 1 of tile k - 2, the table of
    // tile k - 1 and its votes
    __syncwarp();
    const int t_next = t0 + kFwTile + lane;
    w = (t_next < T) ? st[t_next] : zero;
    unsigned acc_a = 0, acc_b = 0;
    if constexpr (kF32) {
      if (k > 1) {
        f_lo = __shfl_sync(kFull, f_lo, back);
        f_hi = __shfl_sync(kFull, f_hi, back);
      }
#pragma unroll
      for (int j = 0; j < kFwTile; ++j) {
        const int phase = j % kFwPhases;
        const int prev = (j + kFwPhases - 1) % kFwPhases;
        const float b = bms[warp][pat[phase]][j];
        const float send = up[prev] ? f_lo : f_hi;
        const float recv = __shfl_xor_sync(kFull, send, 16 >> prev);
        const float lo = up[prev] ? recv : f_lo;
        const float hi = up[prev] ? f_hi : recv;
        const float a0 = __fadd_rn(lo, b), c0 = __fadd_rn(hi, -b);
        const float a1 = __fadd_rn(lo, -b), c1 = __fadd_rn(hi, b);
        const bool d_lo = c0 > a0, d_hi = c1 > a1;   // ties keep branch 0
        f_lo = d_lo ? c0 : a0;
        f_hi = d_hi ? c1 : a1;
        const unsigned dec_lo = __ballot_sync(kFull, d_lo);
        const unsigned dec_hi = __ballot_sync(kFull, d_hi);
        if (lane == 0) ds[warp][j] = make_uint2(dec_lo, dec_hi);
      }
      __syncwarp();
      k3_pack_imad(ds[warp], m1, m0, lane, acc_a, acc_b);
    } else {
      if (k > 1) core.renorm();
      core.tile(buf, lane,
                [&](int j, unsigned dec_lo, unsigned dec_hi) {
                  if (lane == 0) ds[warp][j] = make_uint2(dec_lo, dec_hi);
                },
                [&](int jp, unsigned w1, unsigned w0) {
                  // pair jp as soon as its two steps are voted
                  k3_pack_pair(w1, w0, jp, p1, p0, acc_a, acc_b);
                });
      __syncwarp();
    }
    if (k == W - 1) {
      const int pairs = T2 - k * kPairsPerWord;  // 1 .. 16
      if (pairs < kPairsPerWord) {
        const unsigned keep = (1u << (2 * pairs)) - 1u;
        acc_a &= keep;
        acc_b &= keep;
      }
      if (lane == 0) last[cw] = ds[warp][2 * (T2 - 1) - t0].x & 1u;
    }
    int32_t* row = d + k * 64;
    row[lane] = static_cast<int32_t>(acc_a);
    row[32 + lane] = static_cast<int32_t>(acc_b);
  }
}

// K4: traceback over the decision words plus the bit epilogue.  Replaces
// _traceback_kernel in dabjax/fec/viterbi_pallas.py for the word layout,
// with the unpack of viterbi_decode_pallas (bits[2t] = e[t+3] >> 1,
// bits[2t+1] = e[t+3] & 1, trimmed to nbits) fused in.
//
// What bounds it on the card: the bytes are W * 256 bytes of words in and
// nbits int32 bits out per codeword (0.0183 ms at the MSC shape, counting
// the one word a pair step needs), but each codeword is a chain of T2
// dependent pair steps (the state picks the word of the next step), so
// the chain's latency is the limit.  K2's design: a warp owns kWbCw = 16
// codewords and a block of two warps 32, so the 4428 MSC codewords are 139
// blocks.  A tile is one word index: 64 words, 256 contiguous bytes per
// codeword, copied by branch-free zero-filling 16-byte cp.async into
// shared memory kWbStages - 1 tiles ahead of the walk.  Lanes l and l + 16
// walk codeword l % 16; a pair step is one shared load at the state's word
// (the state is a run-time index), a shift and two logic ops.  The tile's
// 16 branches land at bits 2j, 2j + 1 of E; swapping each pair's two bits
// makes them bits 32k - 6 .. 32k + 25 of the output, and the output word
// k (bits 32k .. 32k + 31) is a funnel shift of this tile's and the one
// above's; the warp transposes the words by shuffle and writes each
// codeword's 32 bits as one 128-byte store, masked at nbits and B.
// Pair steps >= T2 of the top word are 0 and keep the start state 0.
//
// Odd T (odd nbits): the last pair's second step is zero-soft padding.
// The TPU walk starts at state 0 after that padding step, which picks the
// intermediate state 32 over 0 whenever its metric is higher, and then
// differs from the radix-2 reference on noise-like input.  Here the walk
// starts at state 0 after the true last step: before the walk, the top
// tile's word of state 0 gets (last[b] << 1) as the branch of pair T2 - 1,
// state 0's own decision at that step (the walk is at state 0 there).
constexpr int kWbCw = 16;                     // codewords of a warp
constexpr int kWbWarps = 2;                   // warps of a block
constexpr int kWbStages = 4;                  // tiles in shared memory
constexpr int kWbRow = 64 * 4 + 16;           // bytes of a row (padded)
constexpr int kWbTile = kWbCw * kWbRow;       // bytes of a warp's tile

// Copy word index k of codewords cw0 .. cw0 + kWbCw - 1 into the shared
// tile at `tile`, zeros for codewords >= B.  `dec` is 16-byte aligned.
__device__ __forceinline__ void wb_issue(const int32_t* __restrict__ dec,
                                         uint32_t tile, int cw0, int B, int W,
                                         int k, int lane) {
  const int c = lane & 15;                    // the lane's 16 bytes of a row
  const int r0 = lane >> 4;
#pragma unroll
  for (int i = 0; i < kWbCw / 2; ++i) {       // a warp's copy: two rows
    const int r = 2 * i + r0;
    const bool valid = cw0 + r < B;
    const int32_t* src =
        valid ? dec + (static_cast<size_t>(cw0 + r) * W + k) * 64 + c * 4
              : dec;
    cp_async_zfill<16>(tile + r * kWbRow + c * 16, src, valid);
  }
}

__global__ void __launch_bounds__(32 * kWbWarps)
traceback_words(const int32_t* __restrict__ dec,   // [B, W, 64]
                const int32_t* __restrict__ last,  // [B]
                int32_t* __restrict__ bits,        // [B, nbits]
                int B, int T2, int nbits) {
  __shared__ __align__(16) char tiles[kWbWarps][kWbStages][kWbTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cw0 = (blockIdx.x * kWbWarps + warp) * kWbCw;
  if (cw0 >= B) return;                       // whole warps
  const int W = (T2 + kPairsPerWord - 1) / kPairsPerWord;
  const int top = W - 1;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(tiles[warp]));
#pragma unroll 1
  for (int s = 0; s < kWbStages - 1; ++s) {
    if (top - s >= 0)
      wb_issue(dec, base + (top - s) % kWbStages * kWbTile, cw0, B, W,
               top - s, lane);
    cp_async_commit();                        // one group a tile, maybe empty
  }
  const int r = lane % kWbCw;
  const bool odd = 2 * T2 != nbits + 6;
  const unsigned lastv = (odd && cw0 + r < B) ? last[cw0 + r] & 1u : 0u;
  unsigned state = 0, carry = 0;
  for (int k = top; k >= 0; --k) {
    const int kn = k - (kWbStages - 1);       // its buffer was read at k + 1
    if (kn >= 0)
      wb_issue(dec, base + kn % kWbStages * kWbTile, cw0, B, W, kn, lane);
    cp_async_commit();
    cp_async_wait<kWbStages - 1>();           // tile k has landed
    __syncwarp();
    char* row = tiles[warp][k % kWbStages] + r * kWbRow;
    if (odd && k == top) {
      if (lane < kWbCw) {
        const int slot = 2 * ((T2 - 1) % kPairsPerWord);
        unsigned* w0 = reinterpret_cast<unsigned*>(row);
        *w0 = (*w0 & ~(3u << slot)) | (lastv << (slot + 1));
      }
      __syncwarp();
    }
    unsigned E = 0;
#pragma unroll
    for (int j = kPairsPerWord - 1; j >= 0; --j) {
      const unsigned word = *reinterpret_cast<const unsigned*>(row + 4 * state);
      const unsigned e = (word >> (2 * j)) & 3u;
      E |= e << (2 * j);
      state = (state >> 2) | (e << 4);
    }
    __syncwarp();                             // the buffer may be refilled
    const unsigned m = ((E >> 1) & 0x55555555u) | ((E & 0x55555555u) << 1);
    const unsigned out = __funnelshift_r(m, carry, 6);
    carry = m;
    const int t = k * 32 + lane;
#pragma unroll
    for (int i = 0; i < kWbCw; ++i) {
      const unsigned o = __shfl_sync(kFull, out, i);
      if (cw0 + i < B && t < nbits)
        bits[static_cast<size_t>(cw0 + i) * nbits + t] =
            static_cast<int32_t>((o >> lane) & 1u);
    }
  }
}

// K2's launch: the 16-byte copies when every row of decisions is 16-byte
// aligned, else the 8-byte ones.
template <bool kPacked>
int launch_traceback(const void* dec, void* out, const void* prbs, int B,
                     int T, int nbits, void* stream) {
  constexpr int kPerBlock = kTbCw * kTbWarps;    // codewords of a block
  const int blocks = (B + kPerBlock - 1) / kPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2* d = static_cast<const uint2*>(dec);
  const uint32_t* p = static_cast<const uint32_t*>(prbs);
  if (T % 2 == 0 && reinterpret_cast<uintptr_t>(dec) % 16 == 0)
    traceback<true, kPacked><<<blocks, 32 * kTbWarps, 0, st>>>(d, out, p, B,
                                                                T, nbits);
  else
    traceback<false, kPacked><<<blocks, 32 * kTbWarps, 0, st>>>(d, out, p, B,
                                                                 T, nbits);
  return static_cast<int>(cudaGetLastError());
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
  return launch_traceback<false>(dec, bits, nullptr, B, T, nbits, stream);
}

// `prbs`: the energy-dispersal PRBS as [ceil(nbits / 32)] words, bit j of
// word k its bit 32k + j; `bytes`: [B, nbits / 8], nbits a multiple of 8.
int dabjax_viterbi_traceback_packed(const void* dec, const void* prbs,
                                    void* bytes, int B, int T, int nbits,
                                    void* stream) {
  if (nbits % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_traceback<true>(dec, bytes, prbs, B, T, nbits, stream);
}

// variant 0: int8 stream, int32 metrics in word 0 (i8mxu); 1: int8
// stream, float metrics in word 0 (i8); 2: float stream, float metrics
// (f32).  `bsigns`: K1's butterfly signs, [32] packed int8x4.
int dabjax_viterbi_forward_words(const void* soft, const void* signs,
                                 const void* bsigns, void* dec, void* last,
                                 int B, int T2, int variant, void* stream) {
  const int threads = 32 * kWdWarps;             // a warp a codeword
  const int blocks = (B + kWdWarps - 1) / kWdWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* bs = static_cast<const int32_t*>(bsigns);
  int32_t* d = static_cast<int32_t*>(dec);
  int32_t* l = static_cast<int32_t*>(last);
  switch (variant) {
    case 0:
      forward_acs_words<int, StreamI8, false, 9><<<blocks, threads, 0, st>>>(
          static_cast<const int2*>(soft), static_cast<const int2*>(signs),
          bs, d, l, B, T2, -(1 << 29));
      break;
    case 1:
      forward_acs_words<float, StreamI8, false, 9><<<blocks, threads, 0, st>>>(
          static_cast<const int2*>(soft), static_cast<const int2*>(signs),
          bs, d, l, B, T2, -1e9f);
      break;
    case 2:
      forward_acs_words<float, StreamF32, true, 6><<<blocks, threads, 0, st>>>(
          static_cast<const Float8*>(soft),
          static_cast<const Float8*>(signs), bs, d, l, B, T2, -1e9f);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dabjax_viterbi_traceback_words(const void* dec, const void* last,
                                   void* bits, int B, int T2, int nbits,
                                   void* stream) {
  if (reinterpret_cast<uintptr_t>(dec) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int kPerBlock = kWbCw * kWbWarps;    // codewords of a block
  const int blocks = (B + kPerBlock - 1) / kPerBlock;
  traceback_words<<<blocks, 32 * kWbWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dec), static_cast<const int32_t*>(last),
      static_cast<int32_t*>(bits), B, T2, nbits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
