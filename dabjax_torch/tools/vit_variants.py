"""The per-step-plane forward, on the card (the port of
``tools/vit_variants.py``).

The forward of the old float soft format: every pair step's result for
each of the 64 states is one int8 of a [Tp2, 64, B] plane, where K3
packs 16 pair steps per int32 word.  The input is the float32 pair-step
soft of :func:`plane_soft`, [B, Tp2, K]: with ``ksplit`` (the probe's
default) K = 16, the 8 values of hi = round(s / 256) * 256 then the 8 of
lo = s - hi, and the branch signs S4 over both halves; else K = 8.  With
path metrics pm float32 from 0 / -1e9, bm[r] = S4[r] . x (exact
integers) and m[r] = pm[r >> 2] + bm[r] (one round-to-nearest float add)
over the rows r = e*64 + n, the byte of state n at step t is:

* ``full``: K3's branch e = (d0 << 1) | d1, or 0 for t >= T2;
* ``dot_only``: bm[n] > 0; pm is never updated;
* ``no_acs``: m[64 + n] cast to int8 as XLA casts (truncated toward
  zero, saturated to [-128, 127]), with pm[n] <- m[n].

:func:`forward_plane_cuda` runs the kernel (``csrc/probes.cu``),
:func:`forward_plane_torch` is its plain version; :func:`pack_words`
packs a ``full`` plane 16 steps per word, which gives K3 "i8"'s words.
``main()`` times the three modes, kernel and plain, at the main-path
shape (4428 codewords of 2304 bits, chunk 8, ksplit on) and prints ms
and coded Mb/s (4 * B * nbits / t).  The TPU probe's sweeps over the
lane block (``lb``) and the chunk C (the VMEM block) are TPU tilings and
are left out; ``vit_split`` times chunk 8 against 16.

    python -m dabjax_torch.tools.vit_variants
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi, viterbi_cuda

__all__ = ["MODES", "CHUNKS", "pair_steps", "plane_soft",
           "forward_plane_cuda", "forward_plane_torch",
           "forward_plane_lanes_torch", "pack_words", "ENTRIES",
           "main"]

#: the modes, in the kernel's code order
MODES = ("full", "dot_only", "no_acs")
#: the pair steps of a chunk the kernel is built for (Tp2 is a multiple)
CHUNKS = (8, 16)
_vp, _i = ctypes.c_void_p, ctypes.c_int
#: the C entry launched here: its arguments' ctypes types before the
#: stream (``_build.launch``, which counts it as "forward_plane")
ENTRIES = {"dabjax_probe_forward_plane": (_vp, _vp, _vp, _vp, _i, _i, _i,
                                          _i, _i, _i)}

_PAIRS_PER_WORD = 16
#: pair steps whose branch metrics the plain version forms in one matmul
_BM_CHUNK = 64


def pair_steps(nbits: int, chunk: int = 8) -> tuple[int, int]:
    """(T2, Tp2): the pair steps of ``nbits`` and their count rounded up
    to whole chunks."""
    T2 = -(-(nbits + 6) // 2)
    return T2, -(-T2 // chunk) * chunk


def plane_soft(soft: torch.Tensor, nbits: int, chunk: int = 8,
               ksplit: bool = True) -> torch.Tensor:
    """``soft`` (B, 4*(nbits+6)) -> float32 [B, Tp2, K]: each codeword's
    pair steps of 8 soft values, zero-padded to Tp2 steps (a whole
    number of chunks), with ``ksplit`` hi = round(s / 256) * 256 and
    lo = s - hi side by side (K = 16), else K = 8; the numbers of the
    TPU probe's [Tp2, K, Bp] input, codeword first."""
    T = nbits + 6
    if soft.dim() != 2 or soft.shape[1] != 4 * T:
        raise ValueError(f"need soft [B, 4*({nbits}+6)], got "
                         f"{tuple(soft.shape)}")
    _, Tp2 = pair_steps(nbits, chunk)
    s = soft.to(torch.float32).reshape(soft.shape[0], T, 4)
    s = torch.nn.functional.pad(s, (0, 0, 0, 2 * Tp2 - T))
    s = s.reshape(soft.shape[0], Tp2, 8)
    if ksplit:
        hi = torch.round(s * (1.0 / 256.0)) * 256.0
        s = torch.cat([hi, s - hi], dim=2)
    return s.contiguous()


def _check_input(x: torch.Tensor, mode: str, chunk: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} is not one of {CHUNKS}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] not in (8, 16)
            or x.shape[1] == 0 or x.shape[1] % chunk):
        raise ValueError(f"need float32 [B, Tp2, 8 or 16] with Tp2 a "
                         f"positive multiple of {chunk}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def forward_plane_cuda(x: torch.Tensor, T2: int, mode: str = "full",
                       chunk: int = 8, unroll: bool = False) -> torch.Tensor:
    """The kernel: pair-step soft float32 [B, Tp2, K] -> int8 plane
    [Tp2, 64, B] of ``mode`` (a view of the kernel's [B, Tp2, 64]
    output).

    ``full`` runs K3's core after its first 16 pair steps: it is exact,
    equal to :func:`forward_plane_torch`, when every soft value (hi + lo
    with ksplit) is an integer in [-127, 127], as :func:`plane_soft` of
    int8-valued soft bits gives them (hi is then 0); the kernel converts
    each trellis step's values to int8, so other input gives other bytes.
    ``dot_only`` and ``no_acs`` keep float arithmetic (equal to the plain
    version wherever its sums are exact, as on integer-valued input).
    The kernel works in tiles of 16 pair steps whatever ``chunk``, which
    only has to divide Tp2 (the padding :func:`plane_soft` gave);
    ``unroll`` unrolls the pair-step loop of a tile in ``dot_only`` and
    ``no_acs`` and changes nothing in ``full``."""
    viterbi_cuda._require(x, torch.float32, 3, "forward_plane_cuda")
    _check_input(x, mode, chunk)
    if x.data_ptr() % 16:                    # the kernel copies 16 bytes
        x = x.clone()
    B, Tp2, K = x.shape
    plane = torch.empty((B, Tp2, 64), dtype=torch.int8, device=x.device)
    if B:
        _build.launch("forward_plane", ENTRIES, "dabjax_probe_forward_plane",
                      x.device, x.data_ptr(),
                      viterbi_cuda._signs4(x.device, "i8").data_ptr(),
                      viterbi_cuda._signs(x.device).data_ptr(),
                      plane.data_ptr(), B, Tp2, T2, MODES.index(mode), K,
                      int(unroll))
    return plane.permute(1, 2, 0)


def forward_plane_torch(x: torch.Tensor, T2: int, mode: str = "full",
                        chunk: int = 8) -> torch.Tensor:
    """Plain version of :func:`forward_plane_cuda`: a loop over pair steps
    on [B, 256] tensors, on the tensor's device."""
    _check_input(x, mode, chunk)
    B, Tp2, K = x.shape
    dev = x.device
    # |bm| <= 16 * 127 < 2^11 and every term is an integer: the float32
    # matmul is exact, TF32 or not
    S4 = torch.as_tensor(viterbi_cuda.radix4_signs().T.astype(np.float32),
                         device=dev)                        # [8, 256]
    S = S4.repeat(K // 8, 1)                                # [K, 256]
    pm = torch.full((B, 64), -1e9, dtype=torch.float32, device=dev)
    pm[:, 0] = 0
    plane = torch.empty((Tp2, B, 64), dtype=torch.int8, device=dev)
    for c0 in range(0, Tp2, _BM_CHUNK):
        bms = x[:, c0: c0 + _BM_CHUNK] @ S                  # [B, c, 256]
        for j in range(bms.shape[1]):
            t, bm = c0 + j, bms[:, j]
            if mode == "dot_only":
                plane[t] = bm[:, :64] > 0
                continue
            m = pm.repeat_interleave(4, dim=1) + bm   # pm[r >> 2] + bm[r]
            if mode == "no_acs":
                pm = m[:, :64]
                # XLA's cast; .to(torch.int8) alone would wrap
                plane[t] = m[:, 64:128].trunc().clamp(-128, 127)
                continue
            m00, m01 = m[:, 0:64], m[:, 64:128]
            m10, m11 = m[:, 128:192], m[:, 192:256]
            a = torch.maximum(m00, m10)
            b = torch.maximum(m01, m11)
            d1 = b > a
            pm = torch.where(d1, b, a)
            d0 = torch.where(d1, m11 > m01, m10 > m00)
            plane[t] = ((d0.to(torch.int8) << 1) | d1.to(torch.int8)
                        if t < T2 else 0)
    return plane.permute(0, 2, 1)


def _plane_bytes(votes: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """The kernel's byte pack (``plane_pack_pair``): a tile's ballot words
    int64 [B, TILE, 2] (K1's rotated layout) -> its pair steps' bytes
    int64 [B, TILE / 2, 64].  Lane l makes the bytes of states l and
    l + 32 from the vote words K3's pack reads (d1: step 2j + 1, word
    l & 1; d0: step 2j, word (l >> 1) & 1), each bit rotated to its place
    in the byte (d1 to bit 0, d0 to bit 1): d1 from K1's position
    rotr5(n >> 1, ph1), d0 from rotr5(n >> 2, ph0) plus d1 at the bit it
    sets in q >> 1, q = (n >> 1) | (d1 << 5)."""
    vc = viterbi_cuda
    rot = viterbi._rotr32
    p1 = [vc.rotl5(lane >> 1, -ph) for ph in range(vc.PHASES)]
    p0 = [vc.rotl5(lane >> 2, -ph) for ph in range(vc.PHASES)]
    out = torch.zeros((votes.shape[0], vc.TILE // 2, 64), dtype=torch.int64,
                      device=votes.device)
    for jp in range(vc.TILE // 2):
        ph1, ph0 = (2 * jp + 1) % vc.PHASES, (2 * jp) % vc.PHASES
        c, s1, s0 = 4 - ph0, 16 >> ph1, vc.rotl5(8, -ph0)
        w1 = votes[:, 2 * jp + 1, lane & 1]                  # [B, 32]
        w0 = votes[:, 2 * jp, (lane >> 1) & 1]
        ta = rot(w1, p1[ph1])
        tb = rot(ta, s1)
        ya = rot(w0, ((ta & 1) << c) + p0[ph0] - 1)
        yb = rot(w0, ((tb & 1) << c) + p0[ph0] + s0 - 1)
        out[:, jp, :32] = (ta & 1) | (ya & 2)
        out[:, jp, 32:] = (tb & 1) | (yb & 2)
    return out


def forward_plane_lanes_torch(x: torch.Tensor, T2: int,
                              chunk: int = 8) -> torch.Tensor:
    """The ``full`` kernel's own arithmetic and layout, lane by lane:
    pair-step soft float32 [B, Tp2, K] -> int8 plane [Tp2, 64, B], as
    :func:`forward_plane_torch` gives it for soft values (hi + lo) that
    are integers in [-127, 127].

    A model of the kernel for the tests, in its tiles of 16 pair steps
    (zeros past Tp2).  Each trellis step's four values become int8
    (rounded, the low byte kept, as the kernel converts them).  Tile 0 is
    the radix-4 recursion in float32 from 0 / -1e9 with one rounded add a
    candidate, on those int8 values.  From tile 1 on, K1's core runs on
    u16x2 metrics (``viterbi._u16_tile``), started from tile 0's metrics
    relative to state 0 in K1's tile-start layout and put back at
    ``METRIC_LIVE`` between tiles (``viterbi._tile_start``);
    :func:`_plane_bytes` turns each tile's votes into bytes.  Pair steps
    >= T2 are 0."""
    _check_input(x, "full", chunk)
    vc = viterbi_cuda
    B, Tp2, K = x.shape
    dev = x.device
    lane = torch.arange(32, device=dev)
    s8 = x[..., :8] + x[..., 8:] if K == 16 else x          # exact
    tiles = -(-Tp2 // 16)
    s8 = torch.nn.functional.pad(s8, (0, 0, 0, 16 * tiles - Tp2))
    q = ((torch.round(s8).to(torch.int64) + 128) & 255) - 128
    plane = torch.zeros((B, 16 * tiles, 64), dtype=torch.int64, device=dev)
    pm, plane[:, :16], _ = viterbi._radix4_steps(
        viterbi._radix4_start(q, "i8"), q[:, :16])
    if tiles > 1:
        v = vc.rotl5(lane, -1)
        pair = torch.stack([pm[:, 2 * v], pm[:, 2 * v + 1]])  # [2, B, 32]
        rel = (pair - pm[:, :1]).to(torch.int64) + vc.METRIC_LIVE
        n = rel[0] | (rel[1] << 16)
        sg = torch.as_tensor(vc.butterfly_signs().astype(np.int64),
                             device=dev)
        steps = q.reshape(B, 32 * tiles, 4)
        for k in range(1, tiles):
            if k > 1:
                n = viterbi._tile_start(n, lane)
            n, votes = viterbi._u16_tile(n, steps[:, 32 * k: 32 * k + 32],
                                         lane, sg)
            plane[:, 16 * k: 16 * k + 16] = _plane_bytes(votes, lane)
    plane = plane[:, :Tp2]
    plane[:, T2:] = 0
    return plane.to(torch.int8).permute(1, 2, 0)


def pack_words(plane: torch.Tensor) -> torch.Tensor:
    """A ``full`` plane int8 [Tp2, 64, B] -> radix-4 words int32
    [W, 64, B] (16 pair steps per word, step j of a word at bits
    2j..2j+1; steps past Tp2 count as 0), the layout of K3's words."""
    Tp2 = plane.shape[0]
    W = -(-Tp2 // _PAIRS_PER_WORD)
    words = torch.zeros((W,) + tuple(plane.shape[1:]), dtype=torch.int64,
                        device=plane.device)
    for j in range(_PAIRS_PER_WORD):
        steps = plane[j::_PAIRS_PER_WORD].to(torch.int64)
        words[: steps.shape[0]] |= steps << (2 * j)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def main() -> int:
    if not tools.have_card("vit_variants"):
        return 1
    dev = torch.device("cuda", 0)
    B, nbits = tools.CODEWORDS, tools.NBITS
    T2, _ = pair_steps(nbits)
    x = plane_soft(torch.from_numpy(tools.soft_bits(B, nbits)).to(dev), nbits)
    coded = 4 * B * nbits
    for mode in MODES:
        for impl, fn, reps in (("kernel", forward_plane_cuda, 10),
                               ("plain", forward_plane_torch, 1)):
            ms = tools.cuda_ms(lambda: fn(x, T2, mode), reps)
            print(f"{mode:9s} C=8 {impl:6s}: {ms:8.3f} ms "
                  f"{coded / ms / 1e3:8.1f} Mb/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
