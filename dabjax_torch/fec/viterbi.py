"""Batched Viterbi decoder for the DAB K=7, rate-1/4 code (torch).

:func:`viterbi_decode` is the one entry point of the FIC and MSC paths: a
CUDA tensor goes to the hand-written kernels of
:mod:`dabjax_torch.fec.viterbi_cuda`, a CPU tensor to the plain versions
(radix-2 :func:`viterbi_forward_torch` and
:func:`viterbi_traceback_torch`, the port of dabjax's
``viterbi_decode_jax``, or the radix-4 word pair), in the format
``viterbi_cuda.SOFT_FMT`` picks.  Both are bit-exact with the numpy
reference decoder :func:`viterbi_decode_np` on integer soft bits with
|soft| <= 127, the demod's contract.  The reference decoder and the ACS
tables (:func:`branch_signs`) are dabjax's own, copied.

:func:`viterbi_forward_words` and :func:`viterbi_traceback_words` split
the decode in two, as ``dabjax.fec.viterbi_pallas`` does for its stage
timing, in the layout of ``viterbi_cuda.SOFT_FMT``.  The radix-4 word
layout's plain versions are :func:`viterbi_forward_words_torch` and
:func:`viterbi_traceback_words_torch`.

The ``*_lanes_torch`` functions model the CUDA kernels' own arithmetic
lane by lane (K1, K2 and its packed epilogue, and the word kernels K3,
K4) for the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dabjax_torch.fec import conv, prbs, viterbi_cuda

__all__ = ["viterbi_decode", "viterbi_decode_torch", "viterbi_forward_torch",
           "viterbi_traceback_torch", "viterbi_forward_words",
           "viterbi_traceback_words", "viterbi_forward_words_torch",
           "viterbi_traceback_words_torch", "viterbi_decode_np",
           "branch_signs", "viterbi_forward_lanes_torch",
           "viterbi_traceback_lanes_torch", "packed_epilogue_lanes_torch",
           "viterbi_traceback_packed_lanes_torch",
           "viterbi_forward_words_lanes_torch",
           "viterbi_traceback_words_lanes_torch"]

#: trellis steps whose branch metrics are formed in one matmul
_CHUNK = 64


@functools.lru_cache(maxsize=None)
def _tables():
    """Static ACS gather tables.

    Returns (signs, prev0, prev1) where
      signs[r, k] = +1 if transition r=(s<<1)|b expects coded bit 1 else -1
      prev0[n] = predecessor state for new state n via r = n        (= n>>1)
      prev1[n] = predecessor state for new state n via r = n | 64   (= n>>1 | 32)
    """
    exp = conv.expected_bits_table()            # (128, 4) 0/1
    signs = (exp.astype(np.int32) * 2 - 1)      # (128, 4) ±1
    n = np.arange(64)
    prev0 = n >> 1
    prev1 = (n >> 1) | 32
    return signs, prev0.astype(np.int32), prev1.astype(np.int32)


def branch_signs() -> np.ndarray:
    """(128, 4) ±1 expected-bit signs for register value r."""
    return _tables()[0]


def viterbi_decode_np(soft: np.ndarray, nbits: int) -> np.ndarray:
    """Reference numpy decoder. ``soft``: (..., 4*(nbits+6)) -> (..., nbits)."""
    signs, prev0, prev1 = _tables()
    soft = np.asarray(soft, dtype=np.float32)
    T = nbits + conv.K - 1
    assert soft.shape[-1] == 4 * T, (soft.shape, nbits)
    lead = soft.shape[:-1]
    s = soft.reshape(lead + (T, 4))

    # branch score for every register value r at every step: (..., T, 128)
    bs = np.einsum("...tk,rk->...tr", s, signs.astype(np.float32))

    pm = np.full(lead + (64,), -1e9, dtype=np.float32)
    pm[..., 0] = 0.0
    decisions = np.empty(lead + (T, 64), dtype=np.uint8)
    n = np.arange(64)
    r0 = n            # r for decision 0
    r1 = n | 64       # r for decision 1
    for t in range(T):
        m0 = pm[..., prev0] + bs[..., t, r0]
        m1 = pm[..., prev1] + bs[..., t, r1]
        d = (m1 > m0)
        decisions[..., t, :] = d
        pm = np.where(d, m1, m0)

    # traceback from state 0
    out = np.empty(lead + (T,), dtype=np.uint8)
    state = np.zeros(lead, dtype=np.int64)
    for t in range(T - 1, -1, -1):
        out[..., t] = state & 1
        d = np.take_along_axis(
            decisions[..., t, :], state[..., None], axis=-1)[..., 0]
        state = (state >> 1) | (d.astype(np.int64) << 5)
    return out[..., :nbits]


def _steps(soft: torch.Tensor, nbits: int):
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    lead = tuple(soft.shape[:-1])
    return T, lead, int(np.prod(lead)) if lead else 1


def viterbi_forward_torch(soft: torch.Tensor) -> torch.Tensor:
    """Plain forward ACS: ``soft`` [B, T, 4] integer-valued -> decisions
    bool [B, T, 64].  Int32 path metrics start at 0 for state 0 and -2^29
    elsewhere (exact, no renormalisation); ties keep branch 0."""
    B, T, _ = soft.shape
    dev = soft.device
    s = soft.to(torch.float32)
    # integer soft bits times +-1: the float32 products and sums are exact
    sg = torch.as_tensor(branch_signs().T.astype(np.float32), device=dev)
    pm = torch.full((B, 64), -(1 << 29), dtype=torch.int32, device=dev)
    pm[:, 0] = 0
    dec = torch.empty((B, T, 64), dtype=torch.bool, device=dev)
    for c0 in range(0, T, _CHUNK):
        bs = (s[:, c0: c0 + _CHUNK] @ sg).to(torch.int32)   # [B, c, 128]
        for j in range(bs.shape[1]):
            # new state n: predecessor n >> 1 via r = n (scores bs[:, :64]),
            # predecessor (n >> 1) | 32 via r = n | 64 (bs[:, 64:])
            m0 = pm[:, :32].repeat_interleave(2, dim=1) + bs[:, j, :64]
            m1 = pm[:, 32:].repeat_interleave(2, dim=1) + bs[:, j, 64:]
            d = m1 > m0
            dec[:, c0 + j] = d
            pm = torch.where(d, m1, m0)
    return dec


def viterbi_traceback_torch(dec: torch.Tensor, nbits: int) -> torch.Tensor:
    """Plain traceback from state 0: decisions bool [B, T, 64] ->
    bits int32 [B, nbits]."""
    B, T, _ = dec.shape
    state = torch.zeros((B, 1), dtype=torch.int64, device=dec.device)
    out = torch.empty((B, T), dtype=torch.int32, device=dec.device)
    for t in range(T - 1, -1, -1):
        out[:, t] = (state[:, 0] & 1).to(torch.int32)
        d = dec[:, t].gather(1, state).to(torch.int64)
        state = (state >> 1) | (d << 5)
    return out[:, :nbits]


_M32 = 0xFFFFFFFF


def _u16_tile(n: torch.Tensor, x: torch.Tensor, lane: torch.Tensor,
              sg: torch.Tensor):
    """One tile of K1's in-place core: ``n`` int64 [B, 32], each lane's
    two unsigned 16-bit metrics in one 32-bit word (new states 2v, 2v + 1
    of v = rotl5(lane, -1)); ``x`` int64 [B, TILE, 4] soft (zeros past
    the end) -> (``n``, votes int64 [B, TILE, 2]: each step's two ballot
    words).  Every product and sum wraps at 32 bits as the card's does;
    the halves are compared unsigned, ``>=`` keeping branch 0."""
    vc = viterbi_cuda
    B = n.shape[0]
    acc = torch.zeros((2, B, 32), dtype=torch.int64, device=n.device)
    for j in range(vc.TILE):
        phase, prev = j % vc.PHASES, (j - 1) % vc.PHASES
        sel = ((lane >> (4 - prev)) & 1).bool()
        other = n[:, lane ^ (16 >> prev)]
        lo = torch.where(sel, other >> 16, n & 0xFFFF)
        hi = torch.where(sel, n >> 16, other & 0xFFFF)
        # [B, 32]; no matmul: the card has none for int64
        b = (x[:, j, None] * sg[vc.rotl5(lane, phase)]).sum(-1)
        a = (lo * 0x10001 + b * -65535) & _M32   # (lo + b, lo - b)
        c = (hi * 0x10001 + b * 65535) & _M32    # (hi - b, hi + b)
        halves = []
        for h, shift in enumerate((0, 16)):
            a_h, c_h = (a >> shift) & 0xFFFF, (c >> shift) & 0xFFFF
            keep0 = a_h >= c_h
            acc[h] |= (~keep0).to(torch.int64) << j
            halves.append(torch.where(keep0, a_h, c_h) << shift)
        n = halves[0] | halves[1]
    return n, _ballots(acc, lane)


def _ballots(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Each lane's decisions of a tile, ``acc`` [2, B, 32] with step j at
    bit j, -> the steps' ballot words int64 [B, TILE, 2] (a 32 x 32 bit
    transpose: step j's word has lane i's decision at bit i)."""
    steps = torch.arange(viterbi_cuda.TILE, device=acc.device)
    words = (((acc[..., None] >> steps) & 1) << lane[:, None]).sum(dim=2)
    return words.permute(1, 2, 0)


def _tile_start(n: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """K1 between tiles: the shuffle that undoes the lane rotation, then
    state 0 put back at ``METRIC_LIVE``."""
    vc = viterbi_cuda
    n = n[:, vc.rotl5(lane, -((vc.TILE - 1) % vc.PHASES + 1))]
    return (n + (vc.METRIC_LIVE - (n[:, :1] & 0xFFFF)) * 0x10001) & _M32


def _tile_soft(x: torch.Tensor, t0: int) -> torch.Tensor:
    """Steps t0 .. t0 + TILE - 1 of ``x`` [B, T, 4], zeros past T."""
    xt = x[:, t0: t0 + viterbi_cuda.TILE]
    pad = viterbi_cuda.TILE - xt.shape[1]
    return torch.cat([xt, xt.new_zeros((xt.shape[0], pad, 4))], 1) if pad \
        else xt


def _signed32(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def viterbi_forward_lanes_torch(soft: torch.Tensor) -> torch.Tensor:
    """K1's own arithmetic, lane by lane: ``soft`` int8 [B, T, 4] ->
    decision words int32 [B, T, 2] in K1's layout
    (``viterbi_cuda.decision_positions``).

    A model of the kernel for the tests, not a fast path: 32 lanes, each
    holding two unsigned 16-bit path metrics packed in one 32-bit word
    (:func:`_u16_tile`), the in-place butterfly with one exchange a step,
    the start values ``METRIC_LIVE`` / ``METRIC_DEAD``, and once a tile of
    ``TILE`` steps the shuffle that undoes the lane rotation and the
    renormalisation that puts state 0 back at ``METRIC_LIVE``.  Its
    decisions equal :func:`viterbi_forward_torch`'s (int32 metrics) bit
    for bit as long as no half leaves 0 .. 65535."""
    vc = viterbi_cuda
    B, T, _ = soft.shape
    dev = soft.device
    lane = torch.arange(32, device=dev)
    sg = torch.as_tensor(vc.butterfly_signs().astype(np.int64), device=dev)
    x = soft.to(torch.int64)
    live, dead = vc.METRIC_LIVE, vc.METRIC_DEAD
    n = torch.full((B, 32), dead * 0x10001, dtype=torch.int64, device=dev)
    n[:, 0] = live | (dead << 16)
    out = torch.zeros((B, T, 2), dtype=torch.int64, device=dev)
    for t0 in range(0, T, vc.TILE):
        if t0:
            n = _tile_start(n, lane)
        n, votes = _u16_tile(n, _tile_soft(x, t0), lane, sg)
        out[:, t0: t0 + vc.TILE] = votes[:, : T - t0]
    return _signed32(out)


def viterbi_traceback_lanes_torch(dec: torch.Tensor,
                                  nbits: int) -> torch.Tensor:
    """K2's own walk over K1's decision words int32 [B, T, 2] -> bits
    int32 [B, nbits]: the state is kept as (bit b, lane i) in K1's rotated
    coordinates, so a step replaces one bit of ``i`` and one shuffle's
    worth of re-indexing happens where a tile ends.  A model of the
    kernel for the tests; equals :func:`viterbi_traceback_torch` on
    ``viterbi_cuda.unpack_decisions(dec)``."""
    vc = viterbi_cuda
    B, T, _ = dec.shape
    d64 = dec.to(torch.int64) & _M32
    i = torch.zeros((B,), dtype=torch.int64, device=dec.device)
    b = torch.zeros_like(i)
    out = torch.empty((B, T), dtype=torch.int32, device=dec.device)
    for t in range(T - 1, -1, -1):
        j = t % vc.TILE
        out[:, t] = b.to(torch.int32)
        word = d64[:, t].gather(1, b[:, None])[:, 0]
        d = (word >> i) & 1
        if j:
            q = -j % vc.PHASES
            b = (i >> q) & 1
            i = (i & ~(1 << q)) | (d << q)
        else:               # into the tile before: undo K1's shuffle
            b = i & 1
            i = (i >> 2) | (d << 3) | (((i >> 1) & 1) << 4)
    return out[:, :nbits]


def packed_epilogue_lanes_torch(bits: torch.Tensor,
                                nbits: int) -> torch.Tensor:
    """K2's packed epilogue as the kernel computes it: bits int32 [B,
    nbits] (``nbits`` a multiple of 8) -> uint8 [B, nbits / 8].  Tile k's
    bits make the lane's ``mask`` (bit j is step 32k + j); the lane XORs
    PRBS word k (``prbs.words``), reverses the whole word (``__brev``),
    reverses its bytes (``__byte_perm(v, 0, 0x0123)``) and stores the 4
    bytes little-endian.  Equals ``pack_bits_u8(prbs.disperse(bits))``."""
    B = bits.shape[0]
    tiles = -(-nbits // 32)
    padded = torch.zeros((B, tiles * 32), dtype=torch.int64,
                         device=bits.device)
    padded[:, :nbits] = bits
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    mask = (padded.reshape(B, tiles, 32) << shifts).sum(dim=-1)
    mask ^= torch.from_numpy(prbs.words(nbits).astype(np.int64)).to(
        bits.device)
    rev = torch.zeros_like(mask)                   # __brev
    for j in range(32):
        rev |= ((mask >> j) & 1) << (31 - j)
    perm = sum(((rev >> 8 * (3 - i)) & 0xFF) << 8 * i for i in range(4))
    out = torch.stack([(perm >> 8 * i) & 0xFF for i in range(4)], dim=-1)
    return out.reshape(B, tiles * 4)[:, : nbits // 8].to(torch.uint8)


def viterbi_traceback_packed_lanes_torch(dec: torch.Tensor,
                                         nbits: int) -> torch.Tensor:
    """K2 with its packed epilogue: :func:`viterbi_traceback_lanes_torch`
    then :func:`packed_epilogue_lanes_torch` -> uint8 [B, nbits / 8]."""
    return packed_epilogue_lanes_torch(
        viterbi_traceback_lanes_torch(dec, nbits), nbits)


def viterbi_decode_torch(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """Plain torch decode: ``soft`` (..., 4*(nbits+6)) -> (..., nbits)
    int32."""
    T, lead, B = _steps(soft, nbits)
    dec = viterbi_forward_torch(soft.reshape(B, T, 4))
    return viterbi_traceback_torch(dec, nbits).reshape(lead + (nbits,))


def viterbi_forward_words_torch(soft: torch.Tensor, nbits: int, fmt: str):
    """Plain radix-4 forward ACS of a word format ("i8mxu", "i8", "f32"):
    ``soft`` (..., 4*(nbits+6)) -> (words int32 [W, 64, B], last int32
    [B]).

    ``words`` equals dabjax's ``viterbi_forward_words`` under that
    ``SOFT_FMT`` with the lane padding dropped: pair step ``16w + j`` of
    state n holds its 2-bit branch e = (d0 << 1) | d1 at bits 2j..2j+1 of
    ``words[w, n]``, and pair steps >= T2 are 0.  The metrics are int32
    from 0 / -2^29 ("i8mxu") or float32 from 0 / -1e9 with one float add
    per candidate ("i8", "f32"), as there: the two groups' words differ
    where the -1e9 start rounds, in the first pair steps of states that
    state 0 cannot reach yet.  ``last`` is state 0's decision at trellis
    step 2(T2-1), which :func:`viterbi_traceback_words_torch` needs when
    the step count is odd."""
    x = viterbi_cuda.pair_soft(soft, nbits, fmt)        # [B, T2, 8]
    B, T2, _ = x.shape
    pm = _radix4_start(x, fmt)
    words = torch.zeros((B, -(-T2 // 16), 64), dtype=torch.int64,
                        device=x.device)
    for c0 in range(0, T2, _CHUNK):
        pm, e, da = _radix4_steps(pm, x[:, c0: c0 + _CHUNK])
        for j in range(e.shape[1]):
            tau = c0 + j
            words[:, tau // 16] |= e[:, j] << (2 * (tau % 16))
    return _signed32(words).permute(1, 2, 0), da[:, 0].to(torch.int32)


def _radix4_start(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """The word formats' start metrics [B, 64]: state 0 at 0, the others
    at -2^29 (int32, "i8mxu") or -1e9 (float32, "i8", "f32")."""
    if fmt == "i8mxu":
        mtype, start = torch.int32, -(1 << 29)
    else:
        mtype, start = torch.float32, -1e9
    pm = torch.full((x.shape[0], 64), start, dtype=mtype, device=x.device)
    pm[:, 0] = 0
    return pm


def _radix4_steps(pm: torch.Tensor, x: torch.Tensor):
    """Radix-4 pair steps of dabjax's ``_forward_kernel`` from metrics
    ``pm`` [B, 64] (int32, or float32 with one rounded add a candidate)
    over pair soft ``x`` [B, n, 8] -> (pm, e int64 [B, n, 64], the
    inner decision ``da`` bool [B, 64] of the last step)."""
    mtype = pm.dtype
    # integer soft times +-1: the float32 products and sums are exact
    S4 = torch.as_tensor(viterbi_cuda.radix4_signs().T.astype(np.float32),
                         device=x.device)                # [8, 256]
    bms = (x.to(torch.float32) @ S4).to(mtype)
    es = []
    for j in range(bms.shape[1]):
        # row e*64 + n has predecessor p with 4p + (n & 3) == e*64 + n
        m = pm.repeat_interleave(4, dim=1) + bms[:, j]      # [B, 256]
        m00, m01 = m[:, 0:64], m[:, 64:128]
        m10, m11 = m[:, 128:192], m[:, 192:256]
        da = m10 > m00
        a = torch.where(da, m10, m00)
        db = m11 > m01
        b = torch.where(db, m11, m01)
        d1 = b > a
        pm = torch.where(d1, b, a)
        es.append((torch.where(d1, db, da).to(torch.int64) << 1)
                  | d1.to(torch.int64))
    return pm, torch.stack(es, 1), da


def viterbi_traceback_words_torch(words: torch.Tensor, last: torch.Tensor,
                                  nbits: int) -> torch.Tensor:
    """Plain word traceback: (words [W, 64, B], last [B]) -> bits int32
    [B, nbits].

    The walk of ``_traceback_kernel`` from state 0 (state =
    (state >> 2) | (e << 4)), then bits[2t] = e[t+3] >> 1 and
    bits[2t+1] = e[t+3] & 1.  With an odd step count the last pair ends on
    a zero-soft padding step; the walk then starts at state 0 after the
    true last step, taking that pair's branch as ``last << 1``, so the
    bits equal ``viterbi_decode_np`` where dabjax's walk, starting after
    the padding step, does not on noise-like input."""
    T = nbits + conv.K - 1
    T2 = -(-T // 2)
    B = words.shape[2]
    d = words.permute(2, 0, 1)                           # [B, W, 64]
    state = torch.zeros((B, 1), dtype=torch.int64, device=words.device)
    e_seq = torch.empty((B, T2), dtype=torch.int64, device=words.device)
    for tau in range(T2 - 1, -1, -1):
        if T % 2 and tau == T2 - 1:
            e = last.to(torch.int64)[:, None] << 1
        else:
            e = (d[:, tau // 16].gather(1, state).to(torch.int64)
                 >> (2 * (tau % 16))) & 3
        e_seq[:, tau] = e[:, 0]
        state = (state >> 2) | (e << 4)
    n_pairs = -(-nbits // 2)
    e3 = e_seq[:, 3: 3 + n_pairs]
    bits = torch.stack([e3 >> 1, e3 & 1], dim=-1).reshape(B, 2 * n_pairs)
    return bits[:, :nbits].to(torch.int32)


def _f32_tile(f: torch.Tensor, x: torch.Tensor, lane: torch.Tensor,
              sg: torch.Tensor):
    """One tile of K3's float core: ``f`` float32 [2, B, 32], each lane's
    metrics of new states 2v and 2v + 1 (v = rotl5(lane, -1)); ``x``
    float32 [B, TILE, 4]; ``sg`` the butterfly signs [32, 4] -> (``f``,
    votes int64 [B, TILE, 2]).  As :func:`_u16_tile`, with one float a
    metric: the lane sends the metric that leaves (its low one when its
    exchanged lane bit is 1) and keeps the one that stays; a step's
    branch metric is read from a table of its 16 signed soft sums; every
    add is one IEEE float32 add."""
    vc = viterbi_cuda
    B = f.shape[1]
    acc = torch.zeros((2, B, 32), dtype=torch.int64, device=f.device)
    # each step's 16 signed sums of its soft values (pattern bit k: sign k
    # negative), and the lane's pattern by phase
    s01 = torch.stack([x[..., 0] + x[..., 1], x[..., 1] - x[..., 0],
                       x[..., 0] - x[..., 1], -x[..., 0] - x[..., 1]], -1)
    s23 = torch.stack([x[..., 2] + x[..., 3], x[..., 3] - x[..., 2],
                       x[..., 2] - x[..., 3], -x[..., 2] - x[..., 3]], -1)
    table = (s01[..., None, :] + s23[..., :, None]).reshape(B, vc.TILE, 16)
    bits = (sg < 0).to(torch.int64) << torch.arange(4, device=f.device)
    pat = [bits[vc.rotl5(lane, ph)].sum(-1) for ph in range(vc.PHASES)]
    for j in range(vc.TILE):
        phase, prev = j % vc.PHASES, (j - 1) % vc.PHASES
        up = ((lane >> (4 - prev)) & 1).bool()
        recv = torch.where(up, f[0], f[1])[:, lane ^ (16 >> prev)]
        lo = torch.where(up, recv, f[0])
        hi = torch.where(up, f[1], recv)
        b = table[:, j, pat[phase]]
        new = []
        for h, sign in enumerate((1.0, -1.0)):
            a, c = lo + sign * b, hi - sign * b    # branch 0, branch 1
            d = c > a
            acc[h] |= d.to(torch.int64) << j
            new.append(torch.where(d, c, a))
        f = torch.stack(new)
    return f, _ballots(acc, lane)


def _rotr32(x: torch.Tensor, k) -> torch.Tensor:
    """32-bit words ``x`` (int64 holding 0 .. 2^32 - 1) rotated right by
    ``k`` mod 32 (the card's funnel shift)."""
    k = k % 32 if isinstance(k, int) else torch.remainder(k, 32)
    return ((x >> k) | (x << (32 - k))) & _M32


def _pack_tile(votes: torch.Tensor, lane: torch.Tensor,
               imad: bool = False) -> torch.Tensor:
    """K3's word pack: the ballot words of one tile int64 [B, TILE, 2]
    (K1's rotated layout) -> the tile's radix-4 words int64 [B, 64].

    Lane l builds the words of states n = l and n = l + 32.  Pair j's d1
    is n's decision at step 2j + 1 (word n & 1, bit rotr5(n >> 1, ph1));
    its d0 is the decision of q = (n >> 1) | (d1 << 5) at step 2j (word
    (n >> 1) & 1, bit rotr5(n >> 2, ph0) + (d1 << (4 - ph0)): the bit d1
    sets in q >> 1 lands at a constant place of the rotation).  The
    kernel's two forms: each bit fetched by a rotation that puts it at
    its place in the word (2j for d1, 2j + 1 for d0) and merged under a
    mask (the u16 core's), or (``imad``, the float core's) a multiply by
    a power of 2 that puts the pair's highest candidate bit at bit 31, a
    multiplier chosen by d1 that moves the wanted one there, and the
    high word of a doubling that takes it."""
    vc = viterbi_cuda
    acc = [torch.zeros((votes.shape[0], 32), dtype=torch.int64,
                       device=votes.device) for _ in range(2)]
    p1 = [vc.rotl5(lane >> 1, -ph) for ph in range(vc.PHASES)]
    p0 = [vc.rotl5(lane >> 2, -ph) for ph in range(vc.PHASES)]
    for jp in range(vc.TILE // 2):
        ph1, ph0 = (2 * jp + 1) % vc.PHASES, (2 * jp) % vc.PHASES
        c, s1, s0 = 4 - ph0, 16 >> ph1, vc.rotl5(8, -ph0)
        w1 = votes[:, 2 * jp + 1, lane & 1]                  # [B, 32]
        w0 = votes[:, 2 * jp, (lane >> 1) & 1]
        if imad:
            def top(x):                        # the high word of x * 2
                return (x & _M32) >> 31
            t1 = w1 * (1 << (31 - p1[ph1] - s1)) & _M32
            d1 = [top(t1 << s1), top(t1)]
            t0 = w0 * (1 << (31 - p0[ph0] - s0 - (1 << c))) & _M32
            mult = [(1 << s0 + (1 << c)) - d1[0] * ((1 << s0 + (1 << c))
                                                    - (1 << s0)),
                    (1 << (1 << c)) - d1[1] * ((1 << (1 << c)) - 1)]
            for h in (0, 1):
                acc[h] += (d1[h] << 2 * jp) + (top(t0 * mult[h]) << 2 * jp + 1)
            continue
        ta = _rotr32(w1, p1[ph1] - 2 * jp)
        for h, t, extra in ((0, ta, 0), (1, _rotr32(ta, s1), s0)):
            d1c = ((t >> (2 * jp - c)) if 2 * jp >= c
                   else (t << (c - 2 * jp))) & (1 << c)
            y = _rotr32(w0, d1c + p0[ph0] + extra - (2 * jp + 1))
            acc[h] |= (t & (1 << 2 * jp)) | (y & (2 << 2 * jp))
    return torch.cat(acc, dim=1)


def viterbi_forward_words_lanes_torch(soft: torch.Tensor, nbits: int,
                                      fmt: str):
    """K3's own arithmetic, lane by lane: ``soft`` (..., 4*(nbits+6)) ->
    (words int32 [W, 64, B], last int32 [B]) of a word format, as
    :func:`viterbi_forward_words_torch` gives them.

    A model of the kernel for the tests.  Word 0 (pair steps 0-15) is the
    radix-4 recursion with the format's metrics (int32 from -2^29, or
    float32 from -1e9 with a rounded add).  From tile 1 on, a tile of
    TILE = 32 trellis steps is one word: K1's radix-2 core (u16x2 metrics,
    :func:`_u16_tile`, under "i8mxu" and "i8"; float32 metrics,
    :func:`_f32_tile`, under "f32"), started from word 0's metrics in
    K1's tile-start layout (relative to state 0 and put at
    ``METRIC_LIVE`` for u16), then :func:`_pack_tile` turns the votes into
    the tile's words (the u16 core's form, or under "f32" the float
    core's), pair steps >= T2 masked to 0.  A radix-4 decision
    is two radix-2 ones with the same strict ``>``, so once every state
    is live (after pair step 2, inside word 0) and the metrics are exact
    integers, the words are dabjax's.  ``last`` is state 0's vote at
    trellis step 2(T2-1), or word 0's ``da``."""
    vc = viterbi_cuda
    x = vc.pair_soft(soft, nbits, fmt)                  # [B, T2, 8]
    B, T2, _ = x.shape
    W = -(-T2 // 16)
    dev = x.device
    lane = torch.arange(32, device=dev)
    pm, e, da = _radix4_steps(_radix4_start(x, fmt), x[:, :16])
    words = torch.zeros((B, W, 64), dtype=torch.int64, device=dev)
    words[:, 0] = (e << 2 * torch.arange(e.shape[1], device=dev)[:, None]
                   ).sum(1)
    last = da[:, 0].to(torch.int64)
    v = vc.rotl5(lane, -1)
    pair = torch.stack([pm[:, 2 * v], pm[:, 2 * v + 1]])   # [2, B, 32]
    steps = x.reshape(B, 2 * T2, 4)
    if fmt == "f32":
        f, sg = pair, torch.as_tensor(
            vc.butterfly_signs().astype(np.float32), device=dev)
    else:
        rel = (pair - pm[:, :1]).to(torch.int64) + vc.METRIC_LIVE
        n, sg = rel[0] | (rel[1] << 16), torch.as_tensor(
            vc.butterfly_signs().astype(np.int64), device=dev)
        steps = steps.to(torch.int64)
    for k in range(1, W):
        t0 = k * vc.TILE
        xt = _tile_soft(steps, t0)
        if fmt == "f32":
            if k > 1:
                f = f[:, :, vc.rotl5(lane, -((vc.TILE - 1) % vc.PHASES + 1))]
            f, votes = _f32_tile(f, xt, lane, sg)
        else:
            if k > 1:
                n = _tile_start(n, lane)
            n, votes = _u16_tile(n, xt, lane, sg)
        npairs = min(16, T2 - 16 * k)
        words[:, k] = (_pack_tile(votes, lane, imad=fmt == "f32")
                       & ((1 << 2 * npairs) - 1))
        if k == W - 1:
            last = votes[:, 2 * (T2 - 1) - t0, 0] & 1
    return _signed32(words).permute(1, 2, 0), last.to(torch.int32)


def viterbi_traceback_words_lanes_torch(words: torch.Tensor,
                                        last: torch.Tensor,
                                        nbits: int) -> torch.Tensor:
    """K4's own walk: (words [W, 64, B], last [B]) -> bits int32
    [B, nbits], as :func:`viterbi_traceback_words_torch` gives them.

    A model of the kernel for the tests.  With an odd step count the top
    tile's word of state 0 first gets ``last << 1`` as the branch of pair
    T2 - 1 (the walk is at state 0 there: the pairs above it are zero
    padding).  A tile is one word index, walked from pair 15 down to 0;
    pair j's branch e lands at bits 2j, 2j + 1 of the tile's E, the two
    bits of each pair swapped once a tile (bits[2(tau-3)] = e >> 1), so
    the tile's 32 bits are bits 32k - 6 .. 32k + 25; the output word k
    (bits 32k .. 32k + 31) takes the upper 26 and the low 6 of the tile
    above, carried from the step before (a funnel shift)."""
    T = nbits + conv.K - 1
    T2 = -(-T // 2)
    W = -(-T2 // 16)
    B = words.shape[2]
    d = words.permute(2, 0, 1).to(torch.int64) & _M32   # [B, W, 64]
    if T % 2:
        d = d.clone()
        slot = 2 * ((T2 - 1) % 16)
        d[:, W - 1, 0] = ((d[:, W - 1, 0] & ~(3 << slot))
                          | (last.to(torch.int64) << 1 + slot))
    s = torch.zeros((B, 1), dtype=torch.int64, device=words.device)
    carry = torch.zeros((B,), dtype=torch.int64, device=words.device)
    out = torch.zeros((B, 32 * W), dtype=torch.int64, device=words.device)
    shifts = torch.arange(32, device=words.device)
    for k in range(W - 1, -1, -1):
        E = torch.zeros_like(carry)
        for j in range(15, -1, -1):
            e = (d[:, k].gather(1, s) >> 2 * j) & 3
            E |= e[:, 0] << 2 * j
            s = (s >> 2) | (e << 4)
        M = ((E >> 1) & 0x55555555) | ((E & 0x55555555) << 1)
        word = ((M >> 6) | (carry << 26)) & _M32
        out[:, 32 * k: 32 * k + 32] = (word[:, None] >> shifts) & 1
        carry = M
    return out[:, :nbits].to(torch.int32)


def _device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernels), False for a CPU tensor (plain
    versions); any other device raises."""
    if t.is_cuda or t.device.type == "cpu":
        return t.is_cuda
    raise ValueError(f"no Viterbi decoder for device {t.device}")


def viterbi_forward_words(soft: torch.Tensor, nbits: int):
    """Forward ACS only, in the layout of ``viterbi_cuda.SOFT_FMT``:
    ``soft`` (..., 4*(nbits+6)) -> (dec, last).

    * "i8lane"/"i8lane2": ``dec`` is K1's int32 [B, T, 2] (state s's
      radix-2 decision at step t sits where
      ``viterbi_cuda.decision_positions`` says); ``last`` is None.
    * "i8mxu"/"i8"/"f32": ``dec`` is the radix-4 words int32 [W, 64, B]
      of dabjax's ``viterbi_forward_words`` (16 pair steps per word, pair
      j at bits 2j..2j+1); ``last`` is int32 [B] (see
      :func:`viterbi_forward_words_torch`).

    This is the one place a format picks its kernels: a CUDA tensor goes
    to K1 or K3, a CPU tensor to the plain version, both fed by the same
    ``step_soft`` / ``pair_soft`` (so the same clip or cast)."""
    fmt = viterbi_cuda.soft_format()
    cuda = _device(soft)
    if fmt in viterbi_cuda.WORD_FORMATS:
        if cuda:
            return viterbi_cuda.viterbi_forward_words_cuda(
                viterbi_cuda.pair_soft(soft, nbits, fmt), fmt)
        return viterbi_forward_words_torch(soft, nbits, fmt)
    s = viterbi_cuda.step_soft(soft, nbits)
    if cuda:
        return viterbi_cuda.viterbi_forward_cuda(s), None
    return viterbi_cuda.pack_decisions(viterbi_forward_torch(s)), None


def viterbi_traceback_words(words: torch.Tensor, last: torch.Tensor,
                            nbits: int) -> torch.Tensor:
    """Traceback of the radix-4 words of :func:`viterbi_forward_words`:
    K4 for CUDA tensors, the plain version for CPU tensors."""
    if _device(words):
        return viterbi_cuda.viterbi_traceback_words_cuda(words, last, nbits)
    return viterbi_traceback_words_torch(words, last, nbits)


def viterbi_decode(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """Decode on the tensor's device in the format ``SOFT_FMT`` picks
    (:func:`viterbi_forward_words`), then the traceback of its layout:
    the CUDA kernels for a CUDA tensor, the plain versions for a CPU
    tensor; any other device raises."""
    _, lead, _ = _steps(soft, nbits)
    dec, last = viterbi_forward_words(soft, nbits)
    if last is not None:
        bits = viterbi_traceback_words(dec, last, nbits)
    elif dec.is_cuda:
        bits = viterbi_cuda.viterbi_traceback_cuda(dec, nbits)
    else:
        bits = viterbi_traceback_torch(viterbi_cuda.unpack_decisions(dec),
                                       nbits)
    return bits.reshape(lead + (nbits,))
