"""The radix-4 word forward without its prep, on the card (the port of
``tools/vit_split2.py``): the clamp-and-cast prep, the kernel alone on
prepped input, and the whole forward, timed apart.

* prep: :func:`prep`, ``viterbi_cuda.pair_soft(soft, nbits, "i8")``
  (clamp to +-127, int8 cast, pair steps); the TPU probe's lane transpose
  has no counterpart;
* kernel only: :func:`kernel_only`, K3 in its "i8" variant
  (``viterbi_cuda.viterbi_forward_words_cuda(x, "i8")``), the
  hand-written counterpart of the ``_forward_kernel(T2, "i8")`` the
  probe launches;
* full forward: :func:`full_forward`,
  ``fec.viterbi.viterbi_forward_words`` under SOFT_FMT "i8";
* plain: ``fec.viterbi.viterbi_forward_words_torch(soft, nbits, "i8")``,
  the kernel's plain version.

``main()`` prints the ms of each, with coded Mb/s (4 * B * nbits / t)
for the three forwards, at the main-path shape (4428 codewords of 2304
bits).

    python -m dabjax_torch.tools.vit_split2
"""

from __future__ import annotations

import sys

import torch

from dabjax_torch import tools
from dabjax_torch.fec import viterbi, viterbi_cuda

__all__ = ["prep", "kernel_only", "full_forward", "main"]


def prep(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """``soft`` (..., 4*(nbits+6)) -> K3's "i8" input [B, T2, 8] int8."""
    return viterbi_cuda.pair_soft(soft, nbits, "i8")


def kernel_only(x: torch.Tensor):
    """K3 "i8" on prepped input -> (words int32 [W, 64, B], last [B])."""
    return viterbi_cuda.viterbi_forward_words_cuda(x, "i8")


def full_forward(soft: torch.Tensor, nbits: int):
    """``viterbi_forward_words`` under SOFT_FMT "i8", restored after."""
    old = viterbi_cuda.SOFT_FMT
    viterbi_cuda.SOFT_FMT = "i8"
    try:
        return viterbi.viterbi_forward_words(soft, nbits)
    finally:
        viterbi_cuda.SOFT_FMT = old


def main() -> int:
    if not tools.have_card("vit_split2"):
        return 1
    dev = torch.device("cuda", 0)
    B, nbits = tools.CODEWORDS, tools.NBITS
    soft = torch.from_numpy(tools.soft_bits(B, nbits)).to(dev)
    x = prep(soft, nbits)
    coded = 4 * B * nbits
    ms = tools.cuda_ms(lambda: prep(soft, nbits), 10)
    print(f"prep i8:     {ms:8.3f} ms", flush=True)
    for name, fn, reps in (
            ("kernel only", lambda: kernel_only(x), 10),
            ("full fwd", lambda: full_forward(soft, nbits), 10),
            ("plain fwd", lambda: viterbi.viterbi_forward_words_torch(
                soft, nbits, "i8"), 1)):
        ms = tools.cuda_ms(fn, reps)
        print(f"{name + ':':12s} {ms:8.3f} ms  {coded / ms / 1e3:8.1f} Mb/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
