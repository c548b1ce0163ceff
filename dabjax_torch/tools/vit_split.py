"""The per-step-plane forward split into its prep and its kernel, on the
card (the port of ``tools/vit_split.py``).

* prep: :func:`preprocess`, the float32 ksplit input [B, Tp2, 16] of
  ``vit_variants.plane_soft`` (the probe's ``preprocess``, without its
  lane transpose and lane padding);
* kernel: :func:`fwd`, ``vit_variants.forward_plane_cuda`` in mode
  ``full`` with the chunk's steps unrolled or not (the probe's
  ``make_fwd`` with ``unroll``: a Python-unrolled chunk loop against a
  ``fori_loop``);
* plain: ``vit_variants.forward_plane_torch``, the kernel's plain
  version.

``main()`` prints the prep ms at chunk 8 and 16, then the kernel ms
(with coded Mb/s, 4 * B * nbits / t) for unroll 0 and 1 at each chunk,
then one plain line, at the main-path shape (4428 codewords of 2304
bits).  The probe's sweep over the lane block (``lb``) is a TPU tiling
and is left out.

    python -m dabjax_torch.tools.vit_split
"""

from __future__ import annotations

import sys

import torch

from dabjax_torch import tools
from dabjax_torch.tools import vit_variants

__all__ = ["preprocess", "fwd", "main"]


def preprocess(soft: torch.Tensor, nbits: int,
               chunk: int = 8) -> torch.Tensor:
    """``soft`` (B, 4*(nbits+6)) -> the ksplit input float32
    [B, Tp2, 16]."""
    return vit_variants.plane_soft(soft, nbits, chunk, ksplit=True)


def fwd(x: torch.Tensor, T2: int, chunk: int = 8,
        unroll: bool = False) -> torch.Tensor:
    """The kernel in mode ``full`` on prepped input -> int8
    [Tp2, 64, B]."""
    return vit_variants.forward_plane_cuda(x, T2, "full", chunk, unroll)


def main() -> int:
    if not tools.have_card("vit_split"):
        return 1
    dev = torch.device("cuda", 0)
    B, nbits = tools.CODEWORDS, tools.NBITS
    T2, _ = vit_variants.pair_steps(nbits)
    soft = torch.from_numpy(tools.soft_bits(B, nbits)).to(dev)
    coded = 4 * B * nbits
    for chunk in vit_variants.CHUNKS:
        ms = tools.cuda_ms(lambda: preprocess(soft, nbits, chunk), 10)
        print(f"preprocess chunk={chunk}: {ms:8.3f} ms", flush=True)
        x = preprocess(soft, nbits, chunk)
        for unroll in (False, True):
            ms = tools.cuda_ms(lambda: fwd(x, T2, chunk, unroll), 10)
            print(f"  kernel C={chunk:2d} unroll={int(unroll)}: {ms:8.3f} ms "
                  f"{coded / ms / 1e3:8.1f} Mb/s", flush=True)
    x = preprocess(soft, nbits)
    ms = tools.cuda_ms(
        lambda: vit_variants.forward_plane_torch(x, T2, "full"), 1)
    print(f"  plain C= 8: {ms:8.3f} ms {coded / ms / 1e3:8.1f} Mb/s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
