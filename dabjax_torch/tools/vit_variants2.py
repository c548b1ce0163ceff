"""The radix-4 word forward with stages stripped, on the card (the port of
``tools/vit_variants2.py``).

Modes strip successive stages of K3's float-metric, int8-stream variant
(SOFT_FMT "i8") to localise the cost of a pair step.  With path metrics
pm float32 from 0 / -1e9, branch metrics bm = S4 . x (exact integers)
and m[r] = pm[r >> 2] + bm[r] (one round-to-nearest float add) over the
256 rows r = e*64 + n, bit or branch j of word w of state n is:

* ``dot_store``: bm[n] > 0; pm is never updated (branch metrics and the
  word store, no ACS);
* ``repadd``: m[64 + n] > 0, with pm[n] <- m[n] (+ the predecessor add);
* ``maxtree``: a > b, with a = max(m00, m10), b = max(m01, m11) and
  pm <- max(a, b) (+ the 3-max selection, no decision extraction);
* ``full``: K3's 2-bit branch e = (d0 << 1) | d1 at bits 2j..2j+1, over
  every one of the Tp2 pair steps of the zero-padded input (no T2 mask).

:func:`forward_words_stage_cuda` runs the kernel (``csrc/probes.cu``),
:func:`forward_words_stage_torch` is its plain version; both take the
pair-step soft of :func:`padded_pair_soft` [B, Tp2, 8] int8 and return
words int32 [W, 64, B].  ``main()`` times every mode, kernel and plain,
at the main-path shape (4428 codewords of 2304 bits) and prints ms and
coded Mb/s (4 * B * nbits / t).  The TPU probe's lane-block sweep
(``lb``) is a TPU tiling and has no counterpart here.

    python -m dabjax_torch.tools.vit_variants2
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi_cuda

__all__ = ["MODES", "padded_pair_soft", "forward_words_stage_cuda",
           "forward_words_stage_torch", "mask_padding", "reset_launches",
           "main"]

#: the stages, in the order they are added (the kernel's ``stage`` code)
MODES = ("dot_store", "repadd", "maxtree", "full")
#: launches of the stage-stripped forward kernel since the last reset
LAUNCHES = 0

_PAIRS_PER_WORD = 16
#: pair steps whose branch metrics are formed in one matmul
_CHUNK = 64


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def padded_pair_soft(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) -> int8 [B, Tp2, 8]: the "i8" pair-step
    soft of ``viterbi_cuda.pair_soft`` with zero pair steps up to Tp2, a
    whole number of words, as the TPU probe's input is padded."""
    x = viterbi_cuda.pair_soft(soft, nbits, "i8")
    pad = -x.shape[1] % _PAIRS_PER_WORD
    return torch.nn.functional.pad(x, (0, 0, 0, pad)).contiguous()


def _check_input(x: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if (x.dtype != torch.int8 or x.dim() != 3 or x.shape[2] != 8
            or x.shape[1] == 0 or x.shape[1] % _PAIRS_PER_WORD):
        raise ValueError(f"need int8 [B, Tp2, 8] with Tp2 a positive "
                         f"multiple of {_PAIRS_PER_WORD}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def forward_words_stage_cuda(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The kernel: pair-step soft int8 [B, Tp2, 8] -> words int32
    [W, 64, B] of ``mode`` (a view of the kernel's [B, W, 64] output)."""
    global LAUNCHES
    viterbi_cuda._require(x, torch.int8, 3, "forward_words_stage_cuda")
    _check_input(x, mode)
    B, Tp2, _ = x.shape
    dec = torch.empty((B, Tp2 // _PAIRS_PER_WORD, 64), dtype=torch.int32,
                      device=x.device)
    if B:
        lib = _build.load_library()
        signs = viterbi_cuda._signs4(x.device, "i8")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.dabjax_probe_forward_words_stage(
                x.data_ptr(), signs.data_ptr(), dec.data_ptr(), B, Tp2,
                MODES.index(mode), stream)
            LAUNCHES += 1
        viterbi_cuda._check(rc, "forward_words_stage_cuda")
    return dec.permute(1, 2, 0)


def forward_words_stage_torch(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of :func:`forward_words_stage_cuda`: a loop over pair
    steps on [B, 256] tensors, on the tensor's device."""
    _check_input(x, mode)
    B, Tp2, _ = x.shape
    dev = x.device
    # |bm| <= 8 * 127 < 2^11: the float32 matmul is exact, TF32 or not
    S4 = torch.as_tensor(viterbi_cuda.radix4_signs().T.astype(np.float32),
                         device=dev)                       # [8, 256]
    pm = torch.full((B, 64), -1e9, dtype=torch.float32, device=dev)
    pm[:, 0] = 0
    width = 2 if mode == "full" else 1
    words = torch.zeros((B, Tp2 // _PAIRS_PER_WORD, 64), dtype=torch.int64,
                        device=dev)
    for c0 in range(0, Tp2, _CHUNK):
        bms = x[:, c0: c0 + _CHUNK].to(torch.float32) @ S4  # [B, c, 256]
        for j in range(bms.shape[1]):
            bm = bms[:, j]
            if mode == "dot_store":
                v = bm[:, :64] > 0
            else:
                m = pm.repeat_interleave(4, dim=1) + bm    # pm[r >> 2] + bm[r]
                if mode == "repadd":
                    pm, v = m[:, :64], m[:, 64:128] > 0
                else:
                    m00, m01 = m[:, 0:64], m[:, 64:128]
                    m10, m11 = m[:, 128:192], m[:, 192:256]
                    a = torch.maximum(m00, m10)
                    b = torch.maximum(m01, m11)
                    if mode == "maxtree":
                        pm, v = torch.maximum(a, b), a > b
                    else:
                        d1 = b > a
                        pm = torch.where(d1, b, a)
                        d0 = torch.where(d1, m11 > m01, m10 > m00)
                        v = (d0.to(torch.int64) << 1) | d1.to(torch.int64)
            tau = c0 + j
            words[:, tau // _PAIRS_PER_WORD] |= (
                v.to(torch.int64) << (width * (tau % _PAIRS_PER_WORD)))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).permute(1, 2, 0)


def mask_padding(words: torch.Tensor, T2: int) -> torch.Tensor:
    """``full`` words with the slots of pair steps >= T2 set to 0, as K3
    leaves them (it never computes those steps)."""
    r = T2 - _PAIRS_PER_WORD * (words.shape[0] - 1)   # pairs in the last word
    if r >= _PAIRS_PER_WORD:
        return words
    out = words.clone()
    out[-1] &= (1 << (2 * r)) - 1
    return out


def main() -> int:
    if not tools.have_card("vit_variants2"):
        return 1
    dev = torch.device("cuda", 0)
    B, nbits = tools.CODEWORDS, tools.NBITS
    x = padded_pair_soft(torch.from_numpy(tools.soft_bits(B, nbits)).to(dev),
                         nbits)
    coded = 4 * B * nbits
    for mode in MODES:
        for impl, fn, reps in (("kernel", forward_words_stage_cuda, 10),
                               ("plain", forward_words_stage_torch, 1)):
            ms = tools.cuda_ms(lambda: fn(x, mode), reps)
            print(f"{mode:9s} {impl:6s}: {ms:8.3f} ms "
                  f"{coded / ms / 1e3:8.1f} Mb/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
