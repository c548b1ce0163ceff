"""The last pieces of dabjax's host plane in the port, held to dabjax's on
the same numpy inputs: the LUT atan2 of ``fastmath`` and the numpy forms
of the CRC16 gate (``check_crc16_bits`` on numpy input, any length, and
``check_crc16_inverted_bits``)."""

import numpy as np
import pytest
import torch

from dabjax import fastmath as fastmath_j
from dabjax.fec import crc as crc_j
from dabjax_torch import fastmath
from dabjax_torch.fec import crc


def test_comp_atan2_matches_dabjax():
    """The inputs of dabjax's own test (tests/test_io_devices.py)."""
    rng = np.random.default_rng(11)
    y = rng.standard_normal(5000).astype(np.float32)
    x = rng.standard_normal(5000).astype(np.float32)
    got = fastmath.comp_atan2(y, x)
    assert got.dtype == np.float32
    assert got.tobytes() == fastmath_j.comp_atan2(y, x).tobytes()
    assert np.max(np.abs(got - np.arctan2(y, x))) < 4e-3
    for yy, xx in ((0.0, 1.0), (1.0, 0.0), (0.0, -1.0), (0.0, 0.0),
                   (-1.0, -1.0)):
        assert fastmath.comp_atan2(yy, xx) == fastmath_j.comp_atan2(yy, xx)
    assert fastmath.ATAN_TABLE_SIZE == fastmath_j.ATAN_TABLE_SIZE


def _words(n_msg: int, seed: int):
    """Words of ``n_msg`` message bits with their CRC appended (inverted
    and not); every other word has four bits flipped."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (6, n_msg)).astype(np.uint8)
    out = {}
    for inverted in (True, False):
        w = crc_j.crc16_append_bits(msg, inverted=inverted)
        w[::2, rng.integers(0, n_msg + 16, 4)] ^= 1
        out[inverted] = w
    return out


@pytest.mark.parametrize("n_msg", [240, 2048, 4096])
def test_numpy_crc_gate_matches_dabjax(n_msg):
    """Numpy input goes to the numpy form, also above the 2064 bits the
    tensor form takes, and returns numpy."""
    for inverted, w in _words(n_msg, n_msg).items():
        want = crc_j.check_crc16_bits(w, inverted=inverted)
        got = crc.check_crc16_bits(w, inverted=inverted)
        assert isinstance(got, np.ndarray) and got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
        assert want[1::2].all() and not want[::2].any()
        if inverted:
            np.testing.assert_array_equal(
                crc.check_crc16_inverted_bits(w),
                crc_j.check_crc16_inverted_bits(w))
        if n_msg + 16 <= 16 + (1 << 11):      # the tensor form agrees
            np.testing.assert_array_equal(
                crc.check_crc16_bits(torch.from_numpy(w.astype(np.int32)),
                                     inverted=inverted).numpy(), want)


def test_tensor_crc_gate_keeps_its_range():
    w = _words(4096, 1)[True]
    with pytest.raises(ValueError, match="exact matmul range"):
        crc.check_crc16_bits(torch.from_numpy(w.astype(np.int32)))
    t = torch.from_numpy(_words(240, 2)[True].astype(np.int32))
    got = crc.check_crc16_inverted_bits(t)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(
        got.numpy(), crc_j.check_crc16_inverted_bits(t.numpy()))
