"""ctypes wrappers over the CUDA Viterbi kernels (``csrc/viterbi.cu``).

* forward ACS (K1) replaces ``_forward_kernel_lane`` of
  ``dabjax/fec/viterbi_pallas.py``: soft int8 [B, T, 4] -> decision words
  int32 [B, T, 2] in the kernel's own layout (:func:`decision_positions`:
  word ``s & 1``, bit = ``s >> 1`` rotated right by ``(t % 32) % 5``);
* traceback (K2) replaces ``_traceback_kernel`` and the unpack epilogue
  of ``viterbi_decode_pallas``: decision words -> bits int32 [B, nbits];
  its packed epilogue (:func:`viterbi_traceback_packed_cuda`, the MSC
  chain's on the card) stores the dispersed logical-frame bytes uint8
  [B, nbits / 8] in their place, the result of
  ``pack_bits_u8(prbs.disperse(bits))``;
* radix-4 forward ACS (K3) replaces ``_forward_kernel``: pair-step soft
  [B, T2, 8] -> the radix-4 decision words of dabjax's
  ``viterbi_forward_words`` [W, 64, B] int32, plus ``last`` [B] int32;
  its first word is dabjax's radix-4 recursion, the rest K1's radix-2
  core with each tile's votes packed into words
  (:func:`dabjax_torch.fec.viterbi.viterbi_forward_words_lanes_torch`
  models it);
* word traceback (K4) replaces ``_traceback_kernel`` and the epilogue for
  that word layout: (words, last) -> bits int32 [B, nbits], K2's tiled
  walk over word indices
  (:func:`dabjax_torch.fec.viterbi.viterbi_traceback_words_lanes_torch`).

:data:`SOFT_FMT` picks the forward kernel of
:func:`dabjax_torch.fec.viterbi.viterbi_forward_words` (and so of every
decode), as the same global of ``dabjax/fec/viterbi_pallas.py`` does
there: "i8lane" and
"i8lane2" run K1 + K2 ("i8lane2" is a TPU scheduling variant of the same
kernel), "i8mxu", "i8" and "f32" run K3 + K4 with int32 / float / float
path metrics on an int8 / int8 / float soft stream.

The wrappers take CUDA tensors only and raise on anything else, on a
failed build and on a failed launch; there is no fallback.  They launch
through ``_build.launch``, which counts K1-K4 in ``_build.LAUNCHES``
under "k1" .. "k4", and K2's packed epilogue under "k2_packed".
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dabjax_torch import _build
from dabjax_torch.fec import conv, prbs

__all__ = ["SOFT_FMT", "FORMATS", "WORD_FORMATS", "viterbi_forward_cuda",
           "viterbi_traceback_cuda", "viterbi_traceback_packed_cuda",
           "viterbi_forward_words_cuda", "viterbi_traceback_words_cuda",
           "step_soft", "pair_soft", "radix4_signs", "ENTRIES",
           "soft_format", "pack_decisions", "unpack_decisions",
           "decision_positions", "to_int8", "TILE", "PHASES", "METRIC_LIVE",
           "METRIC_DEAD", "rotl5", "forward_sass_counts",
           "forward_words_sass_counts"]

#: the soft-input formats of dabjax's ``viterbi_pallas.SOFT_FMT``
FORMATS = ("i8lane", "i8lane2", "i8mxu", "i8", "f32")
#: formats decoded through the radix-4 decision words (K3 + K4), with
#: K3's variant code
WORD_FORMATS = {"i8mxu": 0, "i8": 1, "f32": 2}
#: the forward kernel of every decode on a CUDA tensor (see module doc)
SOFT_FMT = "i8lane"

_vp, _i = ctypes.c_void_p, ctypes.c_int
#: the C entries launched here: their arguments' ctypes types before the
#: stream (``_build.launch``)
ENTRIES = {"dabjax_viterbi_forward": (_vp, _vp, _vp, _i, _i),
           "dabjax_viterbi_traceback": (_vp, _vp, _i, _i, _i),
           "dabjax_viterbi_traceback_packed": (_vp, _vp, _vp, _i, _i, _i),
           "dabjax_viterbi_forward_words": (_vp, _vp, _vp, _vp, _vp, _i, _i,
                                            _i),
           "dabjax_viterbi_traceback_words": (_vp, _vp, _vp, _i, _i, _i)}

_PAIRS_PER_WORD = 16

#: K1 / K2 walk the trellis in tiles of TILE steps; inside a tile the
#: lane that holds a state rotates with period PHASES (see
#: :func:`decision_positions`)
TILE = 32
PHASES = 5
#: K1's unsigned 16-bit path metrics: state 0 starts (and is put back,
#: once a tile) at METRIC_LIVE, the other start states at METRIC_DEAD
METRIC_LIVE = 32768
METRIC_DEAD = METRIC_LIVE - 8192


def soft_format() -> str:
    """:data:`SOFT_FMT`, checked against :data:`FORMATS`."""
    if SOFT_FMT not in FORMATS:
        raise ValueError(f"unknown SOFT_FMT {SOFT_FMT!r}; one of {FORMATS}")
    return SOFT_FMT


@functools.lru_cache(maxsize=None)
def radix4_signs() -> np.ndarray:
    """S4 [256, 8] int8: the +-1 signs of pair-step branch row e*64 + n
    (new state n, branch e = (d0 << 1) | d1), the first step's 4 then the
    second's; the S4 of ``viterbi_pallas._radix4_matrices``."""
    from dabjax_torch.fec.viterbi import branch_signs
    signs = branch_signs()
    S4 = np.zeros((256, 8), np.int8)
    n = np.arange(64)
    for e in range(4):
        p = (n >> 2) | (e << 4)                   # predecessor
        q = ((p << 1) | ((n >> 1) & 1)) & 63      # state between the steps
        rows = e * 64 + n
        S4[rows, :4] = signs[q | ((p >> 5) << 6)]
        S4[rows, 4:] = signs[n | ((q >> 5) << 6)]
    return S4


def to_int8(soft: torch.Tensor) -> torch.Tensor:
    """The int8 formats' soft values: clipped to +-127 and truncated
    toward zero (a float -> int8 cast that saturates, where torch's own
    wraps); an int8 tensor is returned as it is.  Elementwise, so it
    commutes with the de-interleave and depuncture gathers (0 stays 0)."""
    if soft.dtype == torch.int8:
        return soft
    return soft.clamp(-127, 127).to(torch.int8)


def step_soft(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) -> K1's input: int8 [B, T, 4].  A float
    tensor is clipped to +-127 as ``viterbi_forward_words`` does (identity
    inside the decode contract); an int8 tensor (the MSC chain casts once,
    before its gathers) passes through with no clamp, cast or copy beyond
    what contiguity needs."""
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    return to_int8(soft.reshape(-1, T, 4)).contiguous()


def pair_soft(soft: torch.Tensor, nbits: int, fmt: str) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) -> pair-step soft [B, T2, 8] of a word
    format: clipped to +-127 and cast to int8 for "i8mxu"/"i8" (an int8
    tensor passes through), cast to float32 (no clip) for "f32"; an odd
    step count gets one zero step, as ``viterbi_forward_words`` pads."""
    if fmt not in WORD_FORMATS:
        raise ValueError(f"{fmt!r} is not a word format {tuple(WORD_FORMATS)}")
    T = nbits + conv.K - 1
    if soft.shape[-1] != 4 * T:
        raise ValueError(f"soft length {soft.shape[-1]} != 4*({nbits}+6)")
    s = soft.reshape(-1, T, 4)
    if fmt == "f32":
        s = s.to(torch.float32)
    else:
        s = to_int8(s)
    if T % 2:
        s = torch.cat([s, s.new_zeros((s.shape[0], 1, 4))], dim=1)
    return s.reshape(s.shape[0], -1, 8).contiguous()


@functools.lru_cache(maxsize=None)
def butterfly_signs() -> np.ndarray:
    """[32, 4] int8: the signs of register value r = 2s, for s < 32.

    K1 scores the four branches of the butterfly (s, s + 32) ->
    (2s, 2s + 1) from this one row: every generator polynomial of the
    code has its newest and its oldest tap set, so flipping bit 0 or bit 6
    of r flips all four expected bits (checked here, not assumed)."""
    from dabjax_torch.fec.viterbi import branch_signs
    signs = branch_signs()
    r = np.arange(128)
    if not ((signs[r ^ 1] == -signs).all() and (signs[r ^ 64] == -signs).all()):
        raise AssertionError("branch signs lack the butterfly symmetry")
    return np.ascontiguousarray(signs[0:64:2].astype(np.int8))


@functools.lru_cache(maxsize=None)
def _signs(device: torch.device) -> torch.Tensor:
    """[32] int32: :func:`butterfly_signs` packed as int8x4."""
    return torch.from_numpy(butterfly_signs().view(np.int32).reshape(32)
                            ).to(device)


def _require(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype} with {ndim} dims,"
                         f" got {t.dtype} {tuple(t.shape)}")


def viterbi_forward_cuda(soft: torch.Tensor) -> torch.Tensor:
    """K1: ``soft`` int8 [B, T, 4] -> decision words int32 [B, T, 2]."""
    _require(soft, torch.int8, 3, "viterbi_forward_cuda")
    B, T, k = soft.shape
    if k != 4:
        raise ValueError(f"viterbi_forward_cuda: last dim {k} != 4")
    dec = torch.empty((B, T, 2), dtype=torch.int32, device=soft.device)
    if B == 0 or T == 0:
        return dec
    _build.launch("k1", ENTRIES, "dabjax_viterbi_forward", soft.device,
                  soft.data_ptr(), _signs(soft.device).data_ptr(),
                  dec.data_ptr(), B, T)
    return dec


def viterbi_traceback_cuda(dec: torch.Tensor, nbits: int) -> torch.Tensor:
    """K2: decision words int32 [B, T, 2] -> bits int32 [B, nbits]."""
    _require(dec, torch.int32, 3, "viterbi_traceback_cuda")
    B, T, k = dec.shape
    if k != 2 or not 0 <= nbits <= T:
        raise ValueError(f"viterbi_traceback_cuda: bad shape {tuple(dec.shape)}"
                         f" for nbits={nbits}")
    bits = torch.empty((B, nbits), dtype=torch.int32, device=dec.device)
    if B == 0 or nbits == 0:
        return bits
    _build.launch("k2", ENTRIES, "dabjax_viterbi_traceback", dec.device,
                  dec.data_ptr(), bits.data_ptr(), B, T, nbits)
    return bits


def viterbi_traceback_packed_cuda(dec: torch.Tensor,
                                  nbits: int) -> torch.Tensor:
    """K2 with its packed epilogue: decision words int32 [B, T, 2] ->
    the dispersed logical-frame bytes uint8 [B, nbits / 8], equal to
    ``pack_bits_u8(prbs.disperse(viterbi_traceback_cuda(dec, nbits)))``
    with no bit plane in between.  ``nbits`` must be a multiple of 8 (every
    DAB subchannel's 24 x bitrate, and the FIC's 768, are)."""
    if nbits % 8:
        raise ValueError(f"viterbi_traceback_packed_cuda: nbits={nbits} is "
                         f"not a multiple of 8")
    _require(dec, torch.int32, 3, "viterbi_traceback_packed_cuda")
    B, T, k = dec.shape
    if k != 2 or not 0 <= nbits <= T:
        raise ValueError(f"viterbi_traceback_packed_cuda: bad shape "
                         f"{tuple(dec.shape)} for nbits={nbits}")
    out = torch.empty((B, nbits // 8), dtype=torch.uint8, device=dec.device)
    if B == 0 or nbits == 0:
        return out
    _build.launch("k2_packed", ENTRIES, "dabjax_viterbi_traceback_packed",
                  dec.device, dec.data_ptr(),
                  prbs.words_on(nbits, dec.device).data_ptr(),
                  out.data_ptr(), B, T, nbits)
    return out


@functools.lru_cache(maxsize=None)
def _signs4(device: torch.device, fmt: str) -> torch.Tensor:
    """K3's branch rows: [256, 2] int32 (packed int8x8) for an int8
    stream, [256, 8] float32 for the float stream."""
    S4 = radix4_signs()
    if fmt == "f32":
        return torch.from_numpy(S4.astype(np.float32)).to(device)
    return torch.from_numpy(S4.view(np.int32).copy()).to(device)


def viterbi_forward_words_cuda(x: torch.Tensor, fmt: str):
    """K3: pair-step soft [B, T2, 8] from :func:`pair_soft` (int8, or
    float32 for "f32") -> (words int32 [W, 64, B], last int32 [B]).

    ``words`` is a view of the kernel's [B, W, 64] output.  ``last`` is
    state 0's decision at trellis step 2(T2-1), which the traceback needs
    when the step count is odd."""
    variant = WORD_FORMATS.get(fmt)
    if variant is None:
        raise ValueError(f"{fmt!r} is not a word format {tuple(WORD_FORMATS)}")
    _require(x, torch.float32 if fmt == "f32" else torch.int8, 3,
             "viterbi_forward_words_cuda")
    B, T2, k = x.shape
    if k != 8 or T2 == 0:
        raise ValueError(f"viterbi_forward_words_cuda: bad shape "
                         f"{tuple(x.shape)}")
    W = -(-T2 // _PAIRS_PER_WORD)
    dec = torch.empty((B, W, 64), dtype=torch.int32, device=x.device)
    last = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B:
        _build.launch("k3", ENTRIES, "dabjax_viterbi_forward_words",
                      x.device, x.data_ptr(),
                      _signs4(x.device, fmt).data_ptr(),
                      _signs(x.device).data_ptr(), dec.data_ptr(),
                      last.data_ptr(), B, T2, variant)
    return dec.permute(1, 2, 0), last


def viterbi_traceback_words_cuda(words: torch.Tensor, last: torch.Tensor,
                                 nbits: int) -> torch.Tensor:
    """K4: (words int32 [W, 64, B], last int32 [B]) -> bits int32
    [B, nbits]."""
    if not (words.is_cuda and last.is_cuda):
        raise ValueError(f"viterbi_traceback_words_cuda: CUDA tensors "
                         f"required, got {words.device}, {last.device}")
    T2 = -(-(nbits + conv.K - 1) // 2)
    W = -(-T2 // _PAIRS_PER_WORD)
    if (words.dtype != torch.int32 or last.dtype != torch.int32
            or words.dim() != 3 or words.shape[:2] != (W, 64)
            or tuple(last.shape) != (words.shape[2],) or nbits < 0):
        raise ValueError(f"viterbi_traceback_words_cuda: bad words "
                         f"{words.dtype} {tuple(words.shape)} / last "
                         f"{last.dtype} {tuple(last.shape)} for nbits={nbits}")
    B = words.shape[2]
    dec = words.permute(2, 0, 1).contiguous()    # a view of K3's output
    if dec.data_ptr() % 16:                      # K4 copies 16-byte chunks
        dec = dec.clone()
    last = last.contiguous()
    bits = torch.empty((B, nbits), dtype=torch.int32, device=words.device)
    if B == 0 or nbits == 0:
        return bits
    _build.launch("k4", ENTRIES, "dabjax_viterbi_traceback_words",
                  words.device, dec.data_ptr(), last.data_ptr(),
                  bits.data_ptr(), B, T2, nbits)
    return bits


def _sass_counts(name: str) -> dict:
    """{"total", "SHFL", "VOTE"}: SASS instructions (no NOPs) of the
    kernel whose mangled name matches ``name`` in the built library."""
    from dabjax_torch.tools.vpu_probe import _sass_lengths
    return {"total": _sass_lengths(name)[()],
            **{op: _sass_lengths(name, (op,)).get((), 0)
               for op in ("SHFL", "VOTE")}}


def forward_sass_counts() -> dict:
    """:func:`_sass_counts` of K1; its tile of TILE steps is unrolled, so
    a count over TILE is nearly the count a step."""
    return _sass_counts(r"forward_acsEPK")


#: K3's template arguments by word format, as they appear in its mangled
#: name: word 0's metric type (i: int32, f: float) and the float core
_WORDS_KERNELS = {"i8mxu": r"forward_acs_wordsIi.*Lb0E",
                  "i8": r"forward_acs_wordsIf.*Lb0E",
                  "f32": r"forward_acs_wordsIf.*Lb1E"}


def forward_words_sass_counts(fmt: str) -> dict:
    """:func:`_sass_counts` of K3 in the word format ``fmt``.  Word 0's
    pair step is a rolled loop; the core's tile of TILE steps and its word
    pack are unrolled, so the counts are nearly those of one tile and one
    word 0 step."""
    return _sass_counts(_WORDS_KERNELS[fmt])


def rotl5(x, k: int):
    """Rotate the 5-bit value(s) ``x`` left by ``k`` (any integer)."""
    k %= 5
    return ((x << k) | (x >> (5 - k))) & 31


@functools.lru_cache(maxsize=None)
def decision_positions() -> np.ndarray:
    """[TILE, 64] int64: where K1 keeps state s's decision of step t, as
    ``32 * word + bit`` at row ``t % TILE``.

    K1 never moves a path metric to the lane of its state: the lane that
    holds states p and p + 32 computes 2p and 2p + 1 in place, so the
    5-bit lane index of a state pair rotates one bit a step, and one
    shuffle a tile puts it back.  The decisions stay where they are made:
    word ``s & 1`` (the half of the lane's register), bit
    ``rotr5(s >> 1, (t % TILE) % PHASES)`` (the lane).  K2 walks in these
    coordinates; they are the port's own, between K1 and K2 only."""
    s = np.arange(64)
    return np.stack([32 * (s & 1) + rotl5(s >> 1, -(j % PHASES))
                     for j in range(TILE)]).astype(np.int64)


def _positions(T: int, device) -> torch.Tensor:
    """[T, 64]: :func:`decision_positions` of steps 0 .. T - 1."""
    pos = torch.as_tensor(decision_positions(), device=device)
    return pos[torch.arange(T, device=device) % TILE]


def pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """bool [B, T, 64] decisions (by state) -> K1's decision words int32
    [B, T, 2] (the inverse of :func:`unpack_decisions`)."""
    B, T, _ = dec.shape
    inverse = _positions(T, dec.device).argsort(dim=1)     # position -> state
    placed = dec.to(torch.int64).gather(2, inverse.expand(B, T, 64))
    shifts = torch.arange(32, device=dec.device, dtype=torch.int64)
    w = (placed.reshape(B, T, 2, 32) << shifts).sum(dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """K1's decision words int32 [B, T, 2] -> bool [B, T, 64] by state
    (the layout of :func:`dabjax_torch.fec.viterbi.viterbi_forward_torch`)."""
    B, T, _ = dec.shape
    shifts = torch.arange(32, device=dec.device, dtype=torch.int32)
    bits = ((dec[..., None] >> shifts) & 1).reshape(B, T, 64)
    return bits.gather(2, _positions(T, dec.device).expand(B, T, 64)
                       ).to(torch.bool)

