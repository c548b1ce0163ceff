"""Variants of the radix-4 word kernels (K3 ``forward_acs_words``, K4
``traceback_words`` in ``csrc/viterbi.cu``), each built from the source
by text replacement and timed against the kernel as it is, at the
main-path shape (4428 codewords of 2304 bits):

* K3, by word format: ``pack_after_tile`` (the u16 core packs its words
  after the tile instead of in its steps), ``f32_rotations`` and
  ``f32_rotations_in_steps`` (the float core packs with rotations, after
  the tile or in its steps, instead of with multiplies), ``no_pack`` and
  ``no_word0`` (the pack or word 0 left out: the words are wrong, the
  time says what the part costs);
* K3 against K1 plus a separate repack kernel (K1's decisions to device
  memory, then one warp a codeword and word index packing them), i8mxu,
  whose words K1's decisions give exactly;
* K4's walk from a shared load a pair step against a walk from
  registers (the tile repacked into pair-major 2-bit slices, a 16 x 16
  transpose a group of 16 states; the chain a select among four
  registers and a rotate).

Each variant is one ``nvcc`` of ``viterbi.cu`` alone into
``dabjax_torch/build/variants/``; every variant but the ``no_*`` ones
must give the kernel's words or bits.  Times are device times, the
median (min-max) of 4 runs of 20 calls, the variants taken in turns.

    python -m dabjax_torch.tools.word_variants
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda

__all__ = ["K3_VARIANTS", "variant_source", "main"]

_KERNEL = "template <typename M0, typename S, bool kF32, int kMinBlocks>"
#: the u16 core's pack of a pair, in its steps
_PAIR = "                  k3_pack_pair(w1, w0, jp, p1, p0, acc_a, acc_b);\n"
#: the end of the u16 core's tile
_U16_END = "      __syncwarp();\n    }\n    if (k == W - 1) {"
_IMAD = "      k3_pack_imad(ds[warp], m1, m0, lane, acc_a, acc_b);"
_ROT = "k3_pack_rot(ds[warp], p1, p0, lane, acc_a, acc_b);"
#: the float core's votes of a step, and its tile's accumulators
_F32_VOTE = ("\n        if (lane == 0) ds[warp][j] = make_uint2(dec_lo, dec_hi);"
             "\n      }")
_F32_ACC = "    unsigned acc_a = 0, acc_b = 0;\n    if constexpr (kF32) {"
_F32_IN_STEPS = """
        if (lane == 0) ds[warp][j] = make_uint2(dec_lo, dec_hi);
        if (j % 2 == 0)
          w0 = ((lane >> 1) & 1) ? dec_hi : dec_lo;
        else
          k3_pack_pair((lane & 1) ? dec_hi : dec_lo, w0, j / 2, p1, p0,
                       acc_a, acc_b);
      }"""
_FROM_VOTES = "      acc_a = ds[warp][lane].x;\n      acc_b = ds[warp][lane].y;"
_WORD0 = ("  k3_word0<M0, S>(s, signs, d, min(kPairsPerWord, T2), start, lane,"
          " pm_lo,\n                  pm_hi, da0);")
#: the rotation pack of a whole tile from its vote words in shared memory
_PACK_ROT = """__device__ __forceinline__ void k3_pack_rot(
    const uint2* v, const int (&p1)[kFwPhases], const int (&p0)[kFwPhases],
    int lane, unsigned& acc_a, unsigned& acc_b) {
  const unsigned* w = reinterpret_cast<const unsigned*>(v);
  acc_a = 0;
  acc_b = 0;
#pragma unroll
  for (int jp = 0; jp < kFwTile / 2; ++jp)
    k3_pack_pair(w[2 * (2 * jp + 1) + (lane & 1)],
                 w[4 * jp + ((lane >> 1) & 1)], jp, p1, p0, acc_a, acc_b);
}

"""
_WITH_ROT = (_KERNEL, _PACK_ROT + _KERNEL)

#: name -> [(text, replacement), ...] applied to viterbi.cu in order
K3_VARIANTS = {
    "pack_after_tile": [_WITH_ROT, (_PAIR, ""),
                        (_U16_END, _U16_END.replace(
                            "    }", "      " + _ROT + "\n    }", 1))],
    "f32_rotations": [_WITH_ROT, (_IMAD, "      " + _ROT)],
    "f32_rotations_in_steps": [
        (_F32_ACC, _F32_ACC.replace("acc_b = 0;", "acc_b = 0, w0 = 0;")),
        (_F32_VOTE, _F32_IN_STEPS), (_IMAD, "")],
    "no_pack": [(_PAIR, ""), (_IMAD, _FROM_VOTES),
                (_U16_END, _U16_END.replace(
                    "    }", _FROM_VOTES + "\n    }", 1))],
    "no_word0": [(_WORD0, "  pm_lo = lane ? start : M0(0);\n"
                          "  pm_hi = start;")],
}

#: K1's decisions of one codeword and word index packed into its words
_REPACK = _PACK_ROT + """__global__ void __launch_bounds__(128)
repack(const uint2* __restrict__ dec, int32_t* __restrict__ out, int B,
       int T, int W) {
  __shared__ uint2 v[4][kFwTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * 4 + warp;
  if (gw >= B * W) return;
  const int cw = gw / W, k = gw % W, t = kFwTile * k + lane;
  v[warp][lane] = t < T ? dec[static_cast<size_t>(cw) * T + t]
                        : make_uint2(0, 0);
  __syncwarp();
  int p1[kFwPhases], p0[kFwPhases];
#pragma unroll
  for (int p = 0; p < kFwPhases; ++p) {
    p1[p] = rotl5(lane >> 1, -p);
    p0[p] = rotl5(lane >> 2, -p);
  }
  unsigned a, b;
  k3_pack_rot(v[warp], p1, p0, lane, a, b);
  int32_t* row = out + (static_cast<size_t>(cw) * W + k) * 64;
  row[lane] = static_cast<int32_t>(a);
  row[32 + lane] = static_cast<int32_t>(b);
}

}  // namespace

extern "C" int dabjax_variant_repack(const void* dec, void* out, int B,
                                     int T, int W, void* stream) {
  const long warps = static_cast<long>(B) * W;
  repack<<<(warps + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(dec), static_cast<int32_t*>(out), B, T, W);
  return static_cast<int>(cudaGetLastError());
}

namespace {
"""

#: K4's walk from registers: the tile's words of each group of 16 states
#: transposed into pair-major 2-bit slices, then a select and a rotate
_WALK_REGISTERS = """    unsigned sl[4][16];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        sl[g][i] = *reinterpret_cast<const unsigned*>(row + 4 * (16 * g + i));
#pragma unroll
      for (int b = 8; b >= 1; b >>= 1) {
        const unsigned m = b == 8 ? 0x0000FFFFu : b == 4 ? 0x00FF00FFu
                         : b == 2 ? 0x0F0F0F0Fu : 0x33333333u;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i & b) continue;
          const unsigned x = ((sl[g][i] >> (2 * b)) ^ sl[g][i + b]) & m;
          sl[g][i] ^= x << (2 * b);
          sl[g][i + b] ^= x;
        }
      }
    }
    unsigned E = 0;
#pragma unroll
    for (int j = kPairsPerWord - 1; j >= 0; --j) {
      const unsigned lo = (state & 16u) ? sl[1][j] : sl[0][j];
      const unsigned hi = (state & 16u) ? sl[3][j] : sl[2][j];
      const unsigned w = (state & 32u) ? hi : lo;
      const unsigned e = __funnelshift_r(w, w, state << 1) & 3u;
      E |= e << (2 * j);
      state = (state >> 2) | (e << 4);
    }
"""


def _walk_shared(src: str) -> str:
    """K4's walk as it is: from ``unsigned E = 0;`` to the __syncwarp that
    releases the buffer."""
    i = src.index("    unsigned E = 0;\n#pragma unroll\n    for (int j = "
                  "kPairsPerWord - 1;")
    return src[i: src.index("    __syncwarp();                             "
                            "// the buffer may be refilled", i)]


def variant_source(src: str, edits) -> str:
    """``src`` with each (text, replacement) of ``edits`` applied (every
    text must be found)."""
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant text not in the source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_variant(name: str, text: str) -> ctypes.CDLL:
    """nvcc ``text`` (a viterbi.cu) alone into build/variants/<name>.so."""
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(text)
    (out / "acs.cuh").write_text((_build.CSRC / "acs.cuh").read_text())
    so = out / f"{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(cu)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stderr[:3000]}")
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dabjax_viterbi_forward_words.argtypes = [vp] * 5 + [i] * 3 + [vp]
    lib.dabjax_viterbi_traceback_words.argtypes = [vp] * 3 + [i] * 3 + [vp]
    if hasattr(lib, "dabjax_variant_repack"):
        lib.dabjax_variant_repack.argtypes = [vp, vp, i, i, i, vp]
    return lib


def _in_turns(fns: dict) -> dict:
    """{name: (median, min, max)} device ms (``tools.device_ms``) of 4
    runs of 20 calls, in turns."""
    spread = tools.interleaved_ms(fns, 4, 20, tools.device_ms)
    return {name: (v["median"], v["min"], v["max"])
            for name, v in spread.items()}


def _line(label: str, spread: dict, same: dict) -> str:
    return label + ": " + ", ".join(
        f"{name} {m:.4f} ({lo:.4f}-{hi:.4f}) ms"
        + ("" if same.get(name, True) else " [differs]")
        for name, (m, lo, hi) in spread.items())


def main() -> int:
    if not tools.have_card("word_variants"):
        return 1
    vc = viterbi_cuda
    dev = torch.device("cuda", 0)
    B, nbits = tools.CODEWORDS, tools.NBITS
    soft = torch.from_numpy(tools.soft_bits(B, nbits, seed=6)).to(dev)
    src = (_build.CSRC / "viterbi.cu").read_text()
    libs = {name: _build_variant(name, variant_source(src, edits))
            for name, edits in K3_VARIANTS.items()}
    libs["repack"] = _build_variant("repack", variant_source(
        src, [(_KERNEL, _REPACK + _KERNEL)]))
    libs["k4_registers"] = _build_variant("k4_registers", variant_source(
        src, [(_walk_shared(src), _WALK_REGISTERS)]))
    stream = torch.cuda.current_stream().cuda_stream

    for fmt, variant in vc.WORD_FORMATS.items():
        x = vc.pair_soft(soft, nbits, fmt)
        T2 = x.shape[1]
        signs, bsigns = vc._signs4(dev, fmt), vc._signs(dev)
        want, _ = vc.viterbi_forward_words_cuda(x, fmt)
        fns = {"kernel": lambda: vc.viterbi_forward_words_cuda(x, fmt)}
        same = {}
        for name in K3_VARIANTS:
            dec = torch.empty((B, -(-T2 // 16), 64), dtype=torch.int32,
                              device=dev)
            last = torch.empty((B,), dtype=torch.int32, device=dev)

            def run(lib=libs[name], dec=dec, last=last):
                lib.dabjax_viterbi_forward_words(
                    x.data_ptr(), signs.data_ptr(), bsigns.data_ptr(),
                    dec.data_ptr(), last.data_ptr(), B, T2, variant, stream)
            run()
            torch.cuda.synchronize()
            same[name] = torch.equal(dec.permute(1, 2, 0), want)
            if not same[name] and not name.startswith("no_"):
                raise AssertionError(f"K3 variant {name} ({fmt}) differs")
            fns[name] = run
        print(_line(f"K3 {fmt}", _in_turns(fns), same), flush=True)

    # K1 + a separate repack, i8mxu
    x = vc.pair_soft(soft, nbits, "i8mxu")
    T2 = x.shape[1]
    W = -(-T2 // 16)
    steps = x.view(B, 2 * T2, 4)
    words = torch.empty((B, W, 64), dtype=torch.int32, device=dev)
    dec = vc.viterbi_forward_cuda(steps)

    def repack():
        libs["repack"].dabjax_variant_repack(dec.data_ptr(), words.data_ptr(),
                                             B, 2 * T2, W, stream)

    def split():
        nonlocal dec
        dec = vc.viterbi_forward_cuda(steps)
        repack()
    split()
    torch.cuda.synchronize()
    want, _ = vc.viterbi_forward_words_cuda(x, "i8mxu")
    if not torch.equal(words.permute(1, 2, 0), want):
        raise AssertionError("K1 + repack words differ from K3's")
    print(_line("K3 i8mxu against K1 + repack", _in_turns(
        {"K3": lambda: vc.viterbi_forward_words_cuda(x, "i8mxu"),
         "K1+repack": split, "repack": repack}), {}), flush=True)

    # K4's walk: shared load against registers, on K3's i8mxu words
    words, last = vc.viterbi_forward_words_cuda(x, "i8mxu")
    dec4 = words.permute(2, 0, 1).contiguous()
    bits = torch.empty((B, nbits), dtype=torch.int32, device=dev)

    def k4_registers():
        libs["k4_registers"].dabjax_viterbi_traceback_words(
            dec4.data_ptr(), last.data_ptr(), bits.data_ptr(), B, T2, nbits,
            stream)
    k4_registers()
    torch.cuda.synchronize()
    if not torch.equal(bits, vc.viterbi_traceback_words_cuda(words, last,
                                                             nbits)):
        raise AssertionError("K4 register walk differs")
    print(_line("K4 walk", _in_turns(
        {"shared_load": lambda: vc.viterbi_traceback_words_cuda(
            words, last, nbits), "registers": k4_registers}), {}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
