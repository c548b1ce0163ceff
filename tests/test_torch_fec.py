"""dabjax_torch FEC ops against dabjax on the same numpy inputs: the
depuncture gather, energy dispersal, the CRC16 gate and the plain torch
Viterbi (which must equal viterbi_decode_np and the Pallas kernel run in
interpret mode, bit for bit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dabjax.fec import conv, crc as crc_np, prbs as prbs_np
from dabjax.fec import puncture as punct_np
from dabjax.fec.viterbi import viterbi_decode_np
from dabjax.fec.viterbi_pallas import viterbi_decode_pallas
from dabjax_torch.fec import crc, prbs, puncture, viterbi, viterbi_cuda

torch.set_num_threads(1)

_EEP = ([("A", br, lvl) for br in (8, 96, 384) for lvl in (1, 2, 3, 4)]
        + [("B", br, lvl) for br in (32, 64, 192) for lvl in (1, 2, 3, 4)])
_PROFILES = ([("UEP",) + k for k in sorted(punct_np.UEP_PROFILES)]
             + [("EEP",) + e for e in _EEP] + [("FIC",)])


def _profile(case):
    if case[0] == "UEP":
        return punct_np.uep_profile(case[1], case[2])
    if case[0] == "EEP":
        return punct_np.eep_profile(case[2], case[3], case[1])
    return [21, 3], [16, 15]


@pytest.mark.parametrize("case", _PROFILES, ids=lambda c: "-".join(map(str, c)))
def test_depuncture_profile_matches_dabjax(case):
    lengths, pis = _profile(case)
    n_tx = punct_np.punctured_length(lengths, pis)
    rng = np.random.default_rng(n_tx)
    # 8 trailing values beyond the profile (UEP padding) must be ignored
    soft = rng.integers(-127, 128, (2, n_tx + 8)).astype(np.float32)
    want = np.asarray(punct_np.depuncture_profile(jnp.asarray(soft),
                                                  lengths, pis))
    got = puncture.depuncture_profile(torch.from_numpy(soft), lengths, pis)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        punct_np.depuncture(soft[:, :n_tx],
                            punct_np.puncture_mask(lengths, pis)))


def test_disperse_and_crc_match_dabjax():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (3, 4, 768)).astype(np.int32)
    got = prbs.disperse(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), prbs_np.disperse(bits))
    # FIB-shaped words: half carry their (inverted) CRC, half are corrupt
    msg = rng.integers(0, 2, (8, 240)).astype(np.uint8)
    fibs = crc_np.crc16_append_bits(msg, inverted=True).astype(np.int32)
    fibs[::2, rng.integers(0, 256, 4)] ^= 1
    want = crc_np.check_crc16_bits(fibs, inverted=True)
    got = crc.check_crc16_bits(torch.from_numpy(fibs), inverted=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1::2].all()
    np.testing.assert_array_equal(
        crc.check_crc16_bits(torch.from_numpy(fibs), inverted=False).numpy(),
        crc_np.check_crc16_bits(fibs, inverted=False))


def _coded_soft(rng, shape, nbits, amp, noise):
    bits = rng.integers(0, 2, shape + (nbits,), np.uint8)
    coded = np.apply_along_axis(conv.encode, -1, bits.reshape(-1, nbits))
    soft = (coded.astype(np.float32) * 2 - 1) * amp
    soft += np.round(rng.standard_normal(soft.shape) * noise)
    return bits, np.clip(soft, -127, 127).reshape(shape + (-1,))


def _viterbi_case(name):
    """The inputs of tests/test_viterbi_pallas.py, case by case."""
    if name == "ties":
        return 768, _coded_soft(np.random.default_rng(99), (6,), 768,
                                100, 80)[1]
    if name == "punctured":
        rng = np.random.default_rng(7)
        soft = _coded_soft(rng, (2,), 768, 127, 0)[1]
        soft[rng.random(soft.shape) < 0.3] = 0.0
        return 768, soft
    if name.startswith("noise"):
        nbits = int(name[5:])
        rng = np.random.default_rng(1)
        return nbits, rng.integers(-127, 128, (4, 4 * (nbits + 6))).astype(
            np.float32)
    nbits, shape = {"coded100": (100, ()), "coded768": (768, (4,)),
                    "coded2304": (2304, (3, 2))}[name]
    rng = np.random.default_rng(nbits)
    if shape:
        return nbits, _coded_soft(rng, shape, nbits, 100, 40)[1]
    return nbits, _coded_soft(rng, (1,), nbits, 100, 40)[1][0]


@pytest.mark.parametrize("name", ["ties", "punctured", "noise768",
                                  "noise2304", "coded100", "coded768",
                                  "coded2304"])
def test_plain_viterbi_bit_exact(name):
    nbits, soft = _viterbi_case(name)
    want = viterbi_decode_np(soft, nbits)
    pallas = np.asarray(viterbi_decode_pallas(soft, nbits, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    viterbi_cuda.reset_launches()
    got = viterbi.viterbi_decode(torch.from_numpy(soft), nbits)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes the plain version: no kernel launch
    assert viterbi_cuda.FORWARD_LAUNCHES == 0
    assert viterbi_cuda.TRACEBACK_LAUNCHES == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers raise on a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.viterbi_forward_cuda(torch.zeros((1, 106, 4),
                                                      dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.viterbi_traceback_cuda(
            torch.zeros((1, 106, 2), dtype=torch.int32), 100)
    with pytest.raises(ValueError, match="soft length"):
        viterbi.viterbi_decode(torch.zeros((1, 4 * 105)), 100)


def test_decision_word_layout_round_trips():
    """The kernel's decision words (bit s % 32 of word s // 32 is state
    s's decision) unpack to the plain forward ACS layout."""
    rng = np.random.default_rng(3)
    soft = rng.integers(-127, 128, (3, 40, 4)).astype(np.int8)
    dec = viterbi.viterbi_forward_torch(torch.from_numpy(soft)).numpy()
    weights = (1 << np.arange(32, dtype=np.int64))
    words = np.stack([(dec[..., 32 * w: 32 * w + 32] * weights).sum(-1)
                      for w in range(2)], axis=-1)
    words = words.astype(np.uint32).view(np.int32)
    got = viterbi_cuda.unpack_decisions(torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy(), dec)
