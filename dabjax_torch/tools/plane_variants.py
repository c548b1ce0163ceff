"""Variants of the redesigned forward probes (P4 ``forward_plane``, P1
``forward_words_stage`` in ``csrc/probes.cu``), each built from the
source by text replacement and timed against the kernel as it is, at the
main-path shape (4428 codewords of 2304 bits, ksplit, chunk 8):

* ``l2_prefetch_2``, ``l2_prefetch_4`` (P4): after each tile's copies,
  one lane asks the L2 for the whole tile 2 or 4 tiles further on
  (``cp.async.bulk.prefetch.L2``), more bytes in flight with no more
  shared memory;
* ``l2_256b`` (P4 and P1): the input copies ask the L2 to fetch 256
  bytes a request (``cp.async ... .L2::256B``);
* ``p4_ring_4`` (P4 ``full``): a ring of 4 tiles of input in place of 2
  (in the float modes 4 tiles and the table leave room for fewer than the
  nine blocks an SM that one wave of 4428 codewords needs, so they are
  not timed);
* ``p1_ring_2`` (P1): a ring of 2 words of input in place of 4 (P1's
  variants are timed in the stages its own kernel runs, not in ``full``,
  which is K3);
* ``plain_stores`` (P4 and P1): the staged tiles and the words stored
  with plain stores in place of evict-first ``st.global.cs``;
* ``no_bytes`` (P4 ``full``): the core's byte pack left out (each pair
  stores one byte of its votes), so the time says what the pack costs on
  K3's core; its plane is wrong;
* ``no_stores``, ``no_reads`` (P4 ``dot_only``): the staged tiles not
  stored, or every codeword's input read from codeword 0's (from the L2
  after the first), so the times say what the plane's writes and the
  input's reads from device memory cost; their planes are wrong.

Each variant is one ``nvcc`` of ``probes.cu`` alone into
``dabjax_torch/build/variants/``; every variant but the ``no_*`` ones
must give the kernel's plane or words.  Times are device times
(``tools.device_ms``), the median (min-max) of 4 runs of 20 calls, the
variants taken in turns (``word_variants``' timing).

    python -m dabjax_torch.tools.plane_variants
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda
from dabjax_torch.tools import vit_variants as vv
from dabjax_torch.tools import vit_variants2 as vv2
from dabjax_torch.tools.word_variants import _in_turns, _line, variant_source

__all__ = ["VARIANTS", "P4_MODES", "P1_VARIANTS", "build_variant", "main"]

_PLANE_STORE = ("        __stcs(dst + i, row < live ? stage[warp][i] : "
                "make_int4(0, 0, 0, 0));")
_WORD_STORE = ("    __stcs(d + k * 64 + lane, static_cast<int32_t>(a));\n"
               "    __stcs(d + k * 64 + 32 + lane, static_cast<int32_t>(b));")
_PACK = """                  unsigned e_a, e_b;
                  plane_pack_pair(w1, w0, jp, p1, p0, e_a, e_b);
                  out[jp * 64 + lane] = static_cast<int8_t>(e_a);
                  out[jp * 64 + 32 + lane] = static_cast<int8_t>(e_b);"""

#: the copies of a tile of input, as they are and with an L2 prefetch of
#: 256 bytes a request
_P4_COPY = "        cp_async_zfill<16>(slot + i * 16, valid ? src : s, valid);"
_P1_COPY = ("      cp_async_zfill<16>(ring0 + (k % kWsStages) * 128 + lane * 16,"
            "\n                         s + k * kPairsPerWord + 2 * lane, true);")
_L2_256 = ('asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, '
           '%2;" :: "r"({dst}), "l"({src}), "r"({n}) : "memory");')

#: after a tile's copies, lane 0 asks the L2 for the whole tile {d}
#: tiles further on (a bulk prefetch; only tiles inside the codeword)
_COMMIT = "    }\n    cp_async_commit();\n  };"
_PREFETCH = """      if (lane == 0 && (k + {d} + 1) * kPlPairs <= Tp2)
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                     :: "l"(s + static_cast<size_t>(k + {d}) * kTile4),
                        "r"(kTile4 * 16) : "memory");
"""

#: name -> [(text, replacement), ...] applied to probes.cu in order
VARIANTS = {
    "l2_prefetch_2": [(_COMMIT, _PREFETCH.format(d=2) + _COMMIT)],
    "l2_prefetch_4": [(_COMMIT, _PREFETCH.format(d=4) + _COMMIT)],
    "l2_256b": [
        (_P4_COPY, "        " + _L2_256.format(
            dst="slot + i * 16", src="valid ? src : s", n="valid ? 16 : 0")),
        (_P1_COPY, "      " + _L2_256.format(
            dst="ring0 + (k % kWsStages) * 128 + lane * 16",
            src="s + k * kPairsPerWord + 2 * lane", n="16"))],
    "p4_ring_4": [("constexpr int kPlStages = 2;",
                   "constexpr int kPlStages = 4;")],
    "p1_ring_2": [("constexpr int kWsStages = 4;",
                   "constexpr int kWsStages = 2;")],
    "plain_stores": [
        (_PLANE_STORE, "        dst[i] = row < live ? stage[warp][i] : "
                       "make_int4(0, 0, 0, 0);"),
        (_WORD_STORE, "    d[k * 64 + lane] = static_cast<int32_t>(a);\n"
                      "    d[k * 64 + 32 + lane] = static_cast<int32_t>(b);")],
    "no_bytes": [(_PACK, "                  out[jp * 64 + lane] = "
                         "static_cast<int8_t>(w1 ^ w0);")],
    "no_stores": [(_PLANE_STORE, "        (void)row;")],
    "no_reads": [("  const float4* s = soft + static_cast<size_t>(cw) * Tp2 * "
                  "kRow4;", "  const float4* s = soft;")],
}
#: the P4 modes each variant is timed in, and the variants timed on P1
P4_MODES = {"l2_prefetch_2": vv.MODES, "l2_prefetch_4": vv.MODES,
            "l2_256b": vv.MODES, "p4_ring_4": ("full",),
            "plain_stores": vv.MODES, "no_bytes": ("full",),
            "no_stores": ("dot_only",), "no_reads": ("dot_only",)}
P1_VARIANTS = ("l2_256b", "p1_ring_2", "plain_stores")


def build_variant(name: str, text: str) -> subprocess.Popen:
    """Start nvcc of ``text`` (a probes.cu) alone into
    build/variants/plane_<name>.so."""
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"plane_{name}.cu"
    cu.write_text(text)
    (out / "acs.cuh").write_text((_build.CSRC / "acs.cuh").read_text())
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             "-o", str(out / f"plane_{name}.so"), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.BUILD / "variants" / f"plane_{name}.so"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dabjax_probe_forward_plane.argtypes = [vp] * 4 + [i] * 6 + [vp]
    lib.dabjax_probe_forward_words_stage.argtypes = [vp] * 3 + [i] * 3 + [vp]
    return lib


def main() -> int:
    if not tools.have_card("plane_variants"):
        return 1
    dev = torch.device("cuda", 0)
    B, nbits = tools.CODEWORDS, tools.NBITS
    soft = torch.from_numpy(tools.soft_bits(B, nbits, seed=6)).to(dev)
    src = (_build.CSRC / "probes.cu").read_text()
    jobs = {name: build_variant(name, variant_source(src, edits))
            for name, edits in VARIANTS.items()}
    for name, job in jobs.items():
        _, err = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc plane_{name} failed:\n{err[:3000]}")
    libs = {name: _load(name) for name in VARIANTS}
    stream = torch.cuda.current_stream().cuda_stream
    signs, bsigns = viterbi_cuda._signs4(dev, "i8"), viterbi_cuda._signs(dev)

    T2, Tp2 = vv.pair_steps(nbits)
    x = vv.plane_soft(soft, nbits)
    for mode in vv.MODES:
        want = vv.forward_plane_cuda(x, T2, mode)
        fns = {"kernel": lambda: vv.forward_plane_cuda(x, T2, mode)}
        same = {}
        for name, modes in P4_MODES.items():
            if mode not in modes:
                continue
            lib = libs[name]
            plane = torch.empty((B, Tp2, 64), dtype=torch.int8, device=dev)

            def run(lib=lib, plane=plane):
                lib.dabjax_probe_forward_plane(
                    x.data_ptr(), signs.data_ptr(), bsigns.data_ptr(),
                    plane.data_ptr(), B, Tp2, T2, vv.MODES.index(mode), 16,
                    0, stream)
            run()
            torch.cuda.synchronize()
            same[name] = torch.equal(plane.permute(1, 2, 0), want)
            if not same[name] and not name.startswith("no_"):
                raise AssertionError(f"P4 variant {name} ({mode}) differs")
            fns[name] = run
        print(_line(f"P4 {mode}", _in_turns(fns), same), flush=True)

    xw = vv2.padded_pair_soft(soft, nbits)
    Tw = xw.shape[1]
    for mode in vv2.KERNEL_MODES:
        want = vv2.forward_words_stage_cuda(xw, mode)
        fns = {"kernel": lambda: vv2.forward_words_stage_cuda(xw, mode)}
        same = {}
        for name in P1_VARIANTS:
            lib = libs[name]
            dec = torch.empty((B, Tw // 16, 64), dtype=torch.int32,
                              device=dev)

            def run(lib=lib, dec=dec):
                lib.dabjax_probe_forward_words_stage(
                    xw.data_ptr(), signs.data_ptr(), dec.data_ptr(), B, Tw,
                    vv2.MODES.index(mode), stream)
            run()
            torch.cuda.synchronize()
            same[name] = torch.equal(dec.permute(1, 2, 0), want)
            if not same[name]:
                raise AssertionError(f"P1 variant {name} ({mode}) differs")
            fns[name] = run
        print(_line(f"P1 {mode}", _in_turns(fns), same), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
