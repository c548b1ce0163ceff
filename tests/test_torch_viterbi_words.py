"""The port's radix-4 decision words against dabjax's viterbi_forward_words
(the Pallas ``_forward_kernel``, interpret mode) in each word format
(i8mxu, i8, f32), and the plain word traceback against viterbi_decode_np.

Words are compared with the JAX words of the same format, element for
element: the int32 and float formats differ where the float -1e9 start
rounds.  Bits are compared with the numpy reference decoder, bit for bit.
"""

import numpy as np
import pytest
import torch

import dabjax.fec.viterbi_pallas as VP
from dabjax.fec import conv
from dabjax.fec.viterbi import viterbi_decode_np
from dabjax_torch import _build
from dabjax_torch.fec import viterbi, viterbi_cuda

torch.set_num_threads(1)

WORD_FORMATS = ("i8mxu", "i8", "f32")


def _cases(nbits, seed, per_case=3, saturated=False):
    """Coded (noise sd 40), near-tie (sd 80) and pure-noise integer soft
    bits in +-127, ``per_case`` codewords each, stacked; with
    ``saturated``, two more codewords, all +127 and all -127."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (2 * per_case, nbits), np.uint8)
    coded = np.stack([conv.encode(b) for b in bits]).astype(np.float32)
    clean = (coded * 2 - 1) * 100
    sd = np.repeat([40.0, 80.0], per_case)[:, None]
    noisy = clean + np.round(rng.standard_normal(clean.shape) * sd)
    noise = rng.integers(-127, 128, (per_case, clean.shape[1]))
    rows = [noisy, noise]
    if saturated:
        rows.append(np.repeat([[127.0], [-127.0]], clean.shape[1], axis=1))
    return np.clip(np.concatenate(rows), -127, 127).astype(np.float32)


def _jax(fn, soft, nbits, fmt):
    old = VP.SOFT_FMT
    VP.SOFT_FMT = fmt
    try:
        VP.viterbi_decode_pallas.clear_cache()
        VP.viterbi_forward_words.clear_cache()
        return np.asarray(fn(soft, nbits, interpret=True))
    finally:
        VP.SOFT_FMT = old
        VP.viterbi_decode_pallas.clear_cache()
        VP.viterbi_forward_words.clear_cache()


def _jax_words(soft, nbits, fmt):
    words = _jax(VP.viterbi_forward_words, soft, nbits, fmt)
    return words[..., : soft.shape[0]]             # drop the lane padding


def _port_words(soft, nbits, fmt):
    words, last = viterbi.viterbi_forward_words_torch(
        torch.from_numpy(soft), nbits, fmt)
    bits = viterbi.viterbi_traceback_words_torch(words, last, nbits)
    _hold_lane_models(soft, nbits, fmt, words, last)
    return words.numpy(), bits.numpy()


def _hold_lane_models(soft, nbits, fmt, words, last):
    """The models of K3 and K4 (their own arithmetic) against the plain
    versions' words and ``last``, and K4's walk against the plain
    traceback, on the same input."""
    lw, ll = viterbi.viterbi_forward_words_lanes_torch(
        torch.from_numpy(soft), nbits, fmt)
    np.testing.assert_array_equal(lw.numpy(), words.numpy())
    np.testing.assert_array_equal(ll.numpy(), last.numpy())
    np.testing.assert_array_equal(
        viterbi.viterbi_traceback_words_lanes_torch(words, last, nbits),
        viterbi.viterbi_traceback_words_torch(words, last, nbits))


@pytest.mark.parametrize("nbits", [100, 101, 250, 251, 768])
@pytest.mark.parametrize("fmt", WORD_FORMATS)
def test_words_match_dabjax(fmt, nbits):
    """Plain version and the kernels' lane models against dabjax's words
    and the numpy decoder: one tile to several, odd and even nbits,
    coded, near-tie, pure-noise and saturated codewords."""
    soft = _cases(nbits, seed=nbits, saturated=True)
    _build.LAUNCHES.clear()
    words, bits = _port_words(soft, nbits, fmt)
    T2 = -(-(nbits + 6) // 2)
    assert words.shape == (-(-T2 // 16), 64, soft.shape[0])
    np.testing.assert_array_equal(words, _jax_words(soft, nbits, fmt))
    np.testing.assert_array_equal(bits, viterbi_decode_np(soft, nbits))
    # CPU tensors never reach a kernel
    assert _build.LAUNCHES["k3"] == 0
    assert _build.LAUNCHES["k4"] == 0


def test_f32_does_not_saturate():
    """Soft beyond +-127: "f32" casts without clipping and "i8" clips, in
    dabjax and in the port (plain version and lane models) alike, so their
    words and bits differ."""
    _beyond_int8(100, seed=300)


def test_f32_does_not_saturate_over_tiles():
    """As above over several tiles of the kernels' core, odd nbits."""
    _beyond_int8(251, seed=551)


def _beyond_int8(nbits, seed):
    rng = np.random.default_rng(seed)
    soft = rng.integers(-300, 301, (4, 4 * (nbits + 6))).astype(np.float32)
    w_f32, b_f32 = _port_words(soft, nbits, "f32")
    w_i8, b_i8 = _port_words(soft, nbits, "i8")
    np.testing.assert_array_equal(w_f32, _jax_words(soft, nbits, "f32"))
    np.testing.assert_array_equal(w_i8, _jax_words(soft, nbits, "i8"))
    assert not np.array_equal(w_f32, w_i8)
    np.testing.assert_array_equal(b_f32, viterbi_decode_np(soft, nbits))
    np.testing.assert_array_equal(
        b_i8, viterbi_decode_np(np.clip(soft, -127, 127), nbits))


def test_format_groups():
    """i8mxu words equal i8lane words, i8 words equal f32 words on
    in-contract input, and the two groups differ only in word 0."""
    nbits = 100
    soft = _cases(nbits, seed=7)
    w_mxu, _ = _port_words(soft, nbits, "i8mxu")
    w_i8, _ = _port_words(soft, nbits, "i8")
    w_f32, _ = _port_words(soft, nbits, "f32")
    np.testing.assert_array_equal(w_mxu, _jax_words(soft, nbits, "i8lane"))
    np.testing.assert_array_equal(w_i8, w_f32)
    differ = w_mxu != w_i8
    assert differ.any() and not differ[1:].any()


def test_odd_length_traceback_repairs_dabjax():
    """With an odd step count (odd nbits) dabjax's radix-4 decode starts
    its walk after the zero-soft padding step and departs from the
    radix-2 reference on pure noise; the port's word traceback starts
    after the true last step and equals it, from the same words."""
    nbits = 101
    rng = np.random.default_rng(1)
    soft = rng.integers(-127, 128, (16, 4 * (nbits + 6))).astype(np.float32)
    want = viterbi_decode_np(soft, nbits)
    jax_bits = _jax(VP.viterbi_decode_pallas, soft, nbits, "i8mxu")
    assert (jax_bits != want).any(axis=1).sum() > 0
    words, bits = _port_words(soft, nbits, "i8mxu")
    np.testing.assert_array_equal(words, _jax_words(soft, nbits, "i8mxu"))
    np.testing.assert_array_equal(bits, want)


@pytest.mark.parametrize("fmt", viterbi_cuda.FORMATS)
def test_cpu_dispatch_per_format(fmt, monkeypatch):
    """viterbi_forward_words/viterbi_decode on CPU tensors under each
    SOFT_FMT: the plain version in that format's layout, no launch."""
    nbits = 40
    soft = torch.from_numpy(_cases(nbits, seed=40, per_case=1))
    monkeypatch.setattr(viterbi_cuda, "SOFT_FMT", fmt)
    _build.LAUNCHES.clear()
    dec, last = viterbi.viterbi_forward_words(soft, nbits)
    if fmt in viterbi_cuda.WORD_FORMATS:
        want, want_last = viterbi.viterbi_forward_words_torch(soft, nbits,
                                                              fmt)
        np.testing.assert_array_equal(last.numpy(), want_last.numpy())
        bits = viterbi.viterbi_traceback_words(dec, last, nbits)
        np.testing.assert_array_equal(bits.numpy(),
                                      viterbi_decode_np(soft.numpy(), nbits))
    else:
        assert last is None
        want = viterbi_cuda.pack_decisions(viterbi.viterbi_forward_torch(
            soft.reshape(3, nbits + 6, 4)))
    np.testing.assert_array_equal(dec.numpy(), want.numpy())
    np.testing.assert_array_equal(viterbi.viterbi_decode(soft, nbits).numpy(),
                                  viterbi_decode_np(soft.numpy(), nbits))
    assert [_build.LAUNCHES[k] for k in ("k1", "k2", "k3", "k4")] == [0] * 4


@pytest.mark.parametrize("fmt", viterbi_cuda.FORMATS)
def test_cpu_decode_follows_the_format_clip(fmt, monkeypatch):
    """Soft beyond +-127 on a CPU tensor: every format but "f32" clips to
    +-127 before decoding, as the kernels' inputs do on the card."""
    nbits = 40
    rng = np.random.default_rng(301)
    soft = rng.integers(-300, 301, (2, 4 * (nbits + 6))).astype(np.float32)
    monkeypatch.setattr(viterbi_cuda, "SOFT_FMT", fmt)
    ref = soft if fmt == "f32" else np.clip(soft, -127, 127)
    got = viterbi.viterbi_decode(torch.from_numpy(soft), nbits)
    np.testing.assert_array_equal(got.numpy(), viterbi_decode_np(ref, nbits))


def test_word_wrappers_refuse_cpu_tensors_and_bad_formats(monkeypatch):
    x = torch.zeros((1, 53, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.viterbi_forward_words_cuda(x, "i8mxu")
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.viterbi_traceback_words_cuda(
            torch.zeros((4, 64, 1), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 100)
    with pytest.raises(ValueError, match="word format"):
        viterbi_cuda.pair_soft(torch.zeros((1, 4 * 106)), 100, "i8lane")
    monkeypatch.setattr(viterbi_cuda, "SOFT_FMT", "bf16")
    with pytest.raises(ValueError, match="SOFT_FMT"):
        viterbi.viterbi_forward_words(torch.zeros((1, 4 * 106)), 100)


def test_pair_soft_layout():
    """Pair step t holds trellis steps 2t and 2t+1; an odd step count
    gets one zero step; int8 formats clip, f32 does not."""
    soft = torch.arange(4 * 107, dtype=torch.float32).reshape(1, -1) - 200
    x = viterbi_cuda.pair_soft(soft, 101, "i8")
    assert x.dtype == torch.int8 and tuple(x.shape) == (1, 54, 8)
    np.testing.assert_array_equal(x[0, :53].reshape(-1).numpy(),
                                  np.clip(soft[0].numpy(), -127, 127)[:424])
    assert not x[0, 53, 4:].any()
    xf = viterbi_cuda.pair_soft(soft, 101, "f32")
    assert xf.dtype == torch.float32 and float(xf.max()) == 4 * 107 - 201
