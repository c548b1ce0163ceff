"""The default forward path of the port: the int8 cast of the MSC chain in
front of its gathers, and the arithmetic and decision layout of the
forward kernel (K1) and the traceback (K2), on the CPU.

Every comparison is of integers: no tolerance.  The MSC chain is held to
dabjax's ``decode_subchannel`` on the same numpy input; K1's lane model
(16-bit metrics, renormalised once a tile) to the int32 plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dabjax.fec import prbs as prbs_jax, puncture as puncture_jax
from dabjax.fec import viterbi_pallas
from dabjax.msc.deinterleave import time_deinterleave as deinterleave_jax
from dabjax.msc import subchannel as subch_jax
from dabjax_torch.fec import conv, puncture, viterbi, viterbi_cuda as vc
from dabjax_torch.fec.viterbi import viterbi_decode_np
from dabjax_torch.msc import subchannel as subch
from dabjax_torch.msc.deinterleave import time_deinterleave
from dabjax_torch.runtime import pipeline

torch.set_num_threads(1)

_GEOM = dict(subch_id=1, start_addr=0, length_cus=6, bitrate=8,
             protection="EEP-A", prot_level=3)
_T = 18                                   # CIFs: 3 logical frames


@pytest.fixture
def soft_fmt():
    """Set the port's and dabjax's SOFT_FMT together; both jit caches are
    cleared around it."""
    def set_fmt(fmt):
        jax.clear_caches()
        vc.SOFT_FMT = fmt
        viterbi_pallas.SOFT_FMT = fmt
    yield set_fmt
    vc.SOFT_FMT = "i8lane"
    viterbi_pallas.SOFT_FMT = "i8lane"
    jax.clear_caches()


def _msc_input(kind):
    """[2, _T, 384] float32 soft values of two 8 kbit/s subchannels."""
    rng = np.random.default_rng(11)
    n = _GEOM["length_cus"] * 64
    if kind == "in_contract":
        return rng.integers(-127, 128, (2, _T, n)).astype(np.float32)
    if kind == "beyond_127":
        return rng.integers(-300, 301, (2, _T, n)).astype(np.float32)
    return (rng.standard_normal((2, _T, n)) * 90).astype(np.float32)


def _dabjax_chain(x_np):
    """dabjax's decode_subchannel with its Pallas decoder in interpret
    mode (on the CPU its dispatch takes the float lax.scan decoder, which
    has no int8 stream), under the SOFT_FMT the fixture set."""
    lengths, pis = puncture_jax.eep_profile(_GEOM["bitrate"],
                                            _GEOM["prot_level"], "A")
    full = puncture_jax.depuncture_profile(
        deinterleave_jax(jnp.asarray(x_np)), lengths, pis)
    bits = viterbi_pallas.viterbi_decode_pallas(full, 24 * _GEOM["bitrate"],
                                                interpret=True)
    return np.asarray(prbs_jax.disperse(bits))


def _cast_last(x, g):
    """The chain with the clip and cast where it was: after the gathers."""
    lengths, pis = subch.subch_profile(g.protection, g.bitrate, g.prot_level)
    full = puncture.depuncture_profile(time_deinterleave(x), lengths, pis)
    assert full.dtype == torch.float32
    return subch.prbs.disperse(viterbi.viterbi_decode(full, 24 * g.bitrate))


@pytest.mark.parametrize("kind", ["in_contract", "beyond_127",
                                  "non_integer"])
@pytest.mark.parametrize("fmt", ["i8lane", "i8mxu"])
def test_msc_chain_hoisted_cast(fmt, kind, soft_fmt):
    """The MSC chain with the int8 cast in front of its gathers equals the
    chain with the cast at the end, and dabjax's decode_subchannel."""
    soft_fmt(fmt)
    g = subch.SubchGeometry(**_GEOM)
    x_np = _msc_input(kind)
    x = torch.from_numpy(x_np)
    cast = subch.msc_soft(x)
    assert cast.dtype == torch.int8
    np.testing.assert_array_equal(
        cast.numpy(), np.trunc(np.clip(x_np, -127, 127)).astype(np.int8))
    got = subch.decode_subchannel(x, g)
    assert torch.equal(subch.decode_subchannel(cast, g), got)
    assert torch.equal(_cast_last(x, g), got)
    np.testing.assert_array_equal(got.numpy(), _dabjax_chain(x_np))
    if kind == "in_contract":
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            subch_jax.decode_subchannel(jnp.asarray(x_np),
                                        subch_jax.SubchGeometry(**_GEOM))))


def test_msc_chain_f32_does_not_clip(soft_fmt):
    """Under "f32" the stream stays float and unclipped, as before: the
    bits are those of the numpy decoder on the unclipped stream (and
    differ from the clipped stream's)."""
    soft_fmt("f32")
    g = subch.SubchGeometry(**_GEOM)
    x_np = _msc_input("beyond_127")
    x = torch.from_numpy(x_np)
    assert subch.msc_soft(x) is x
    lengths, pis = subch.subch_profile(g.protection, g.bitrate, g.prot_level)
    full = puncture.depuncture_profile(time_deinterleave(x), lengths, pis)
    want = viterbi_decode_np(full.numpy(), 24 * g.bitrate)
    got = subch.decode_subchannel(x, g)
    np.testing.assert_array_equal(
        got.numpy(), subch.prbs.disperse(torch.from_numpy(
            want.astype(np.int32))).numpy())
    clipped = viterbi_decode_np(np.clip(full.numpy(), -127, 127),
                                24 * g.bitrate)
    assert (clipped != want).any()
    np.testing.assert_array_equal(got.numpy(), _dabjax_chain(x_np))


def test_ensemble_decoder_casts_the_block_once(soft_fmt):
    """``EnsembleDecoder.fused`` and ``decode`` give the bits of the
    float chain; the carried history stays float32."""
    from dabjax_torch.constants import get_mode
    soft_fmt("i8lane")
    p = get_mode(1)
    geoms = [subch.SubchGeometry(1, 0, 6, 8, "EEP-A", 3),
             subch.SubchGeometry(2, 12, 6, 8, "EEP-A", 3)]
    rng = np.random.default_rng(5)
    cifs = torch.from_numpy(rng.integers(-200, 201, (_T, 55296))
                            .astype(np.float32))
    dec = subch.EnsembleDecoder(geoms, p, device="cpu")
    by_id = dec.decode(cifs)
    hist, rest = cifs[:15], cifs[15:]
    merged, new_hist, meta = dec.fused(hist, rest,
                                       torch.zeros(0, dtype=torch.uint8))
    assert new_hist.dtype == torch.float32
    assert torch.equal(new_hist, cifs[-15:])
    (bucket, shape), = meta
    packed = merged.reshape(shape).numpy()
    for i, g in enumerate(bucket):
        x = cifs[:, g.start_addr * 64:(g.start_addr + g.length_cus) * 64]
        want = _cast_last(x, g).numpy()
        np.testing.assert_array_equal(by_id[g.subch_id], want)
        np.testing.assert_array_equal(
            np.unpackbits(packed[i], axis=-1), want)


@pytest.mark.parametrize("fn", ["step", "pair_i8mxu", "pair_i8"])
def test_soft_prep_passes_int8_through(fn):
    """``step_soft`` / ``pair_soft`` return an int8 input unchanged (the
    same storage where it is contiguous) and still clamp a float input."""
    nbits = 100
    rng = np.random.default_rng(2)
    x8 = torch.from_numpy(rng.integers(-128, 128, (3, 4 * 106))
                          .astype(np.int8))
    xf = torch.from_numpy(rng.integers(-300, 301, (3, 4 * 106))
                          .astype(np.float32)) + 0.75
    if fn == "step":
        prep, shape = (lambda t: vc.step_soft(t, nbits)), (3, 106, 4)
    else:
        prep = lambda t: vc.pair_soft(t, nbits, fn[5:])
        shape = (3, 53, 8)
    got = prep(x8)
    assert got.dtype == torch.int8 and tuple(got.shape) == shape
    assert got.data_ptr() == x8.data_ptr()
    assert torch.equal(got.reshape(3, -1), x8)       # -128 is not clamped
    # a strided int8 view is copied, not cast
    wide = torch.stack([x8, x8], dim=-1)[..., 0]
    assert not wide.is_contiguous()
    assert torch.equal(prep(wide).reshape(3, -1), x8)
    clamped = prep(xf)
    assert clamped.dtype == torch.int8
    np.testing.assert_array_equal(
        clamped.reshape(3, -1).numpy(),
        np.trunc(np.clip(xf.numpy(), -127, 127)).astype(np.int8))


def test_pair_soft_f32_keeps_floats():
    xf = torch.full((1, 4 * 107), 300.5)
    out = vc.pair_soft(xf, 101, "f32")
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 54, 8)
    assert float(out[0, 0, 0]) == 300.5 and float(out[0, -1, -1]) == 0.0


def _soft(kind, B, nbits, seed):
    rng = np.random.default_rng(seed)
    T = nbits + 6
    if kind == "pure_noise":
        return rng.integers(-127, 128, (B, 4 * T)).astype(np.float32)
    if kind in ("all_plus", "all_minus"):
        return np.full((B, 4 * T), 127.0 if kind == "all_plus" else -127.0,
                       np.float32)
    coded = np.stack([conv.encode(b) for b in
                      rng.integers(0, 2, (B, nbits), np.uint8)])
    clean = (coded.astype(np.float32) * 2 - 1) * 100
    sigma = 40 if kind == "coded" else 80
    return np.clip(clean + np.round(rng.standard_normal(clean.shape)
                                    * sigma), -127, 127)


def test_decision_positions_are_a_permutation():
    pos = vc.decision_positions()
    assert pos.shape == (vc.TILE, 64)
    assert (np.sort(pos, axis=1) == np.arange(64)).all()
    # state 0 never moves: the traceback starts there in every phase
    assert (pos[:, 0] == 0).all()
    rng = np.random.default_rng(0)
    dec = torch.from_numpy(rng.integers(0, 2, (2, 75, 64)).astype(bool))
    words = vc.pack_decisions(dec)
    assert words.dtype == torch.int32 and tuple(words.shape) == (2, 75, 2)
    assert torch.equal(vc.unpack_decisions(words), dec)


@pytest.mark.parametrize("kind", ["coded", "near_tie", "pure_noise"])
@pytest.mark.parametrize("nbits", [100, 101, 768, 2304])
def test_plain_forward_and_traceback_in_the_kernel_layout(nbits, kind):
    """Plain forward -> K1's decision words -> both tracebacks (the plain
    one through ``unpack_decisions``, and K2's own rotated walk) equal the
    numpy decoder."""
    soft = _soft(kind, 3, nbits, seed=nbits)
    want = viterbi_decode_np(soft, nbits)
    s = vc.step_soft(torch.from_numpy(soft), nbits)
    words = vc.pack_decisions(viterbi.viterbi_forward_torch(s))
    np.testing.assert_array_equal(
        viterbi.viterbi_traceback_torch(vc.unpack_decisions(words),
                                        nbits).numpy(), want)
    np.testing.assert_array_equal(
        viterbi.viterbi_traceback_lanes_torch(words, nbits).numpy(), want)


@pytest.mark.parametrize("kind", ["pure_noise", "all_plus", "all_minus",
                                  "near_tie"])
@pytest.mark.parametrize("nbits", [100, 101, 2304, 9216])
def test_int16_lane_model_equals_int32_forward(nbits, kind):
    """K1's arithmetic (two unsigned 16-bit metrics a word, wrapping
    32-bit sums, the kernel's start values, one renormalisation a tile of
    32 steps, the in-place butterfly) decides exactly as the int32 plain
    version, ties included."""
    soft = _soft(kind, 2, nbits, seed=7 * nbits)
    s = vc.step_soft(torch.from_numpy(soft), nbits)
    want = vc.pack_decisions(viterbi.viterbi_forward_torch(s))
    got = viterbi.viterbi_forward_lanes_torch(s)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_butterfly_signs_symmetry():
    """K1 scores a butterfly's four branches from one row of signs."""
    signs = viterbi.branch_signs()
    r = np.arange(128)
    assert (signs[r ^ 1] == -signs).all() and (signs[r ^ 64] == -signs).all()
    np.testing.assert_array_equal(vc.butterfly_signs(),
                                  signs[np.arange(32) * 2])


def test_stage_prefixes_follow_the_main_path(soft_fmt):
    """``pipeline_stages``' prep prefix hands the forward an int8 stream
    under i8lane and a float stream under f32."""
    from dabjax_torch.constants import get_mode
    p = get_mode(1)
    geoms = [subch.SubchGeometry(0, 0, 6, 8, "EEP-A", 3)]
    rows = pipeline.example_rows(p, 5, device="cpu")
    seen = []
    real = viterbi.viterbi_forward_words

    def spy(full, nbits):
        seen.append(full.dtype)
        return real(full, nbits)

    for fmt, dtype in (("i8lane", torch.int8), ("f32", torch.float32)):
        soft_fmt(fmt)
        seen.clear()
        viterbi.viterbi_forward_words = spy
        try:
            fns = pipeline.pipeline_stages(p, geoms, device="cpu")
            assert np.isfinite(float(fns["viterbi_forward"](rows)))
        finally:
            viterbi.viterbi_forward_words = real
        # the MSC decode, then the FIC decode (float in every format)
        assert seen == [dtype, torch.float32], (fmt, seen)
