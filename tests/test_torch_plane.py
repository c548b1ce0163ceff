"""Lane models of the redesigned forward probes against their plain
versions on the CPU.

``vit_variants.forward_plane_lanes_torch`` is the ``full`` plane kernel's
own arithmetic and layout (``csrc/probes.cu`` P4): its first 16 pair
steps by the float radix-4 loop from 0 / -1e9, then K1's u16x2 core on
int8 trellis steps with its renormalisation a tile, and the un-rotation
of each pair's two votes into plane bytes.  The ``full`` stage of the
stage-stripped probe (P1) is K3 "i8" on its zero-padded input, so K3's
lane model, ``viterbi.viterbi_forward_words_lanes_torch``, is held to
that stage's plain words.  The plain versions are those that the card
holds the kernels to, and which ``tests/test_torch_probes.py`` holds to
the TPU probes of ``tools/`` in interpret mode.  The inputs are integer soft
bits in [-127, 127]: coded under moderate noise, near ties and pure
noise, one codeword of each.
"""

import numpy as np
import pytest
import torch

from dabjax_torch.fec import conv, viterbi, viterbi_cuda
from dabjax_torch.tools import vit_variants as vv
from dabjax_torch.tools import vit_variants2 as vv2

torch.set_num_threads(1)


def _soft(nbits, seed, bound=127):
    """float32 [3, 4*(nbits+6)]: a coded codeword with noise of sd 40, one
    with sd 80 (near ties) and one of pure noise, rounded and clipped to
    +-``bound``."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, nbits), np.uint8)
    coded = np.stack([conv.encode(b) for b in bits]).astype(np.float32)
    clean = (coded * 2 - 1) * 100
    sigma = np.array([40.0, 80.0, 0.0])[:, None]
    soft = np.clip(clean + np.round(rng.standard_normal(clean.shape) * sigma),
                   -bound, bound)
    soft[2] = rng.integers(-bound, bound + 1, soft.shape[1])
    return torch.from_numpy(soft.astype(np.float32))


@pytest.mark.parametrize("ksplit", [True, False], ids=["ksplit", "k8"])
@pytest.mark.parametrize("chunk", vv.CHUNKS)
@pytest.mark.parametrize("nbits", [100, 101, 768, 2304])
def test_plane_model_equals_plain(nbits, chunk, ksplit):
    """The ``full`` plane kernel's model equals the plain version byte for
    byte, the padding rows t >= T2 included (0 in both)."""
    soft = _soft(nbits, seed=nbits + chunk)
    T2, Tp2 = vv.pair_steps(nbits, chunk)
    x = vv.plane_soft(soft, nbits, chunk, ksplit)
    got = vv.forward_plane_lanes_torch(x, T2, chunk)
    want = vv.forward_plane_torch(x, T2, "full", chunk)
    assert got.shape == (Tp2, 64, 3)
    assert torch.equal(got, want)
    assert bool(got[:T2].any()) and not bool(got[T2:].any())


@pytest.mark.parametrize("nbits", [101, 768])
def test_plane_model_packs_to_k3_words(nbits):
    """The model's plane, 16 pair steps a word, is K3 "i8"'s words, as
    the card checks the kernel's."""
    soft = _soft(nbits, seed=3 * nbits)
    T2, _ = vv.pair_steps(nbits)
    plane = vv.forward_plane_lanes_torch(vv.plane_soft(soft, nbits), T2)
    words, _ = viterbi.viterbi_forward_words_lanes_torch(soft, nbits, "i8")
    assert torch.equal(vv.pack_words(plane), words)


def test_plane_model_needs_int8_soft():
    """Soft values past the int8 range break the kernel's precondition:
    the model converts them to int8 as the kernel does and then differs
    from the float plain version (which the wrapper's docstring says)."""
    nbits = 768
    soft = _soft(nbits, seed=11, bound=200)
    T2, _ = vv.pair_steps(nbits)
    x = vv.plane_soft(soft, nbits)
    assert not torch.equal(vv.forward_plane_lanes_torch(x, T2),
                           vv.forward_plane_torch(x, T2, "full"))


@pytest.mark.parametrize("nbits", [100, 101, 768, 2304])
def test_stage_model_equals_plain(nbits):
    """The ``full`` stage runs K3 "i8" on the zero-padded input, whose T2
    is Tp2 (no mask): K3's lane model on the soft bits padded to Tp2 pair
    steps equals the plain stage words over every pair step, and K3's
    words below the true T2."""
    soft = _soft(nbits, seed=5 * nbits)
    x = vv2.padded_pair_soft(soft, nbits)
    Tp2 = x.shape[1]
    padded = torch.nn.functional.pad(soft, (0, 8 * Tp2 - soft.shape[1]))
    assert torch.equal(viterbi_cuda.pair_soft(padded, 2 * Tp2 - 6, "i8"), x)
    got, _ = viterbi.viterbi_forward_words_lanes_torch(padded, 2 * Tp2 - 6,
                                                       "i8")
    assert torch.equal(got, vv2.forward_words_stage_torch(x, "full"))
    T2 = -(-(nbits + 6) // 2)
    k3, _ = viterbi.viterbi_forward_words_torch(soft, nbits, "i8")
    assert torch.equal(vv2.mask_padding(got, T2), k3)
