"""Hopper probes: the TPU measurement harnesses of ``tools/`` on the card.

Each module mirrors a probe of ``tools/`` by name and measures on one
CUDA card what that probe measured on the TPU, with a hand-written
kernel (``dabjax_torch/csrc/probes.cu`` or ``chains.cu``, or the
production kernel the probe launched) beside its plain torch version.
They answer questions about the Viterbi kernels' costs (what each stage
of a pair step costs, what the prep before the kernel costs, what a
streaming copy and a decision-plane store reach, what a per-step int8
decision plane costs against packed words, what one elementwise op costs
by dtype); none of them is on the receiver's path.

Run one on a card as ``python -m dabjax_torch.tools.<name>``: it prints
one line per case (ms, and Mb/s or GB/s) and exits non-zero when there is
no card.  Times are CUDA events around repeated launches after a
warm-up.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

#: the main-path MSC shape: 12 subchannels x 369 logical frames of a
#: 96-frame batch, 2304 bits each (96 kbit/s)
CODEWORDS = 12 * 369
NBITS = 24 * 96


def soft_bits(codewords: int = CODEWORDS, nbits: int = NBITS,
              seed: int = 0) -> np.ndarray:
    """Integer soft bits in [-127, 127], float32 [codewords,
    4 * (nbits + 6)], from ``seed`` (the TPU probes' input)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, size=(codewords, 4 * (nbits + 6)),
                        dtype=np.int8).astype(np.float32)


def have_card(name: str) -> bool:
    """True when a CUDA card is present; else says so on stderr."""
    if torch.cuda.is_available():
        return True
    print(f"{name}: no CUDA card (torch.cuda.is_available() is false); "
          "the probes measure the card only", file=sys.stderr)
    return False


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
