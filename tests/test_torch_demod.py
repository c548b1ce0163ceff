"""dabjax_torch OFDM demod and acquisition against dabjax, Modes I-IV, on
the same golden IQ (noise, a 3-carrier-plus-170 Hz CFO, a timing offset).

Tolerances: torch and XLA sum their FFTs in different orders, so a soft
bit on a rounding edge may round the other way; at most 0.1 % of the soft
bits may differ, by 1 only.  Fine CFO within 0.01 Hz, SNR within 1e-3 dB;
integer outputs (acquisition, PRS timing, coarse CFO) must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dabjax.constants import get_mode
from dabjax.ofdm import acquisition as acq_jax, demod as demod_jax
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator
from dabjax_torch.ofdm import acquisition, demod

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[1, 2, 3, 4])
def golden(request):
    mode = request.param
    p = get_mode(mode)
    svc = [ServiceSpec(label="DEMOD", sid=0x2001, subch_id=1, start_addr=0,
                       bitrate=64, protection="EEP-A", prot_level=2,
                       kind="DAB")]
    iq = Modulator(mode=mode, services=svc).iq(
        3, snr_db=20.0, cfo_hz=3 * p.carrier_diff + 170.0,
        sample_offset=777, seed=mode)
    return p, iq


def test_acquisition_exact(golden):
    p, iq = golden
    u0 = acq_jax.acquire(iq, p)
    assert u0 is not None
    assert acquisition.acquire(iq, p, device="cpu") == u0
    x = iq[: p.T_F + p.T_null + p.T_u]
    ej, fj = acq_jax.find_null(jnp.asarray(x), p)
    et, ft = acquisition.find_null(torch.from_numpy(x), p)
    assert int(et) == int(ej) and bool(ft) == bool(float(fj))
    # PRS timing on windows that start before, at and after the PRS
    wins = np.stack([iq[u0 + d: u0 + d + p.T_u] for d in (-40, 0, 25)])
    ij, oj = acq_jax.prs_sync(jnp.asarray(wins), p)
    it, ot = acquisition.prs_sync(torch.from_numpy(wins), p)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj) > 0)


def test_demod_soft_bits_and_estimates(golden):
    p, iq = golden
    u0 = acq_jax.acquire(iq, p)
    need = demod_jax.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(2)])
    rows_t = torch.from_numpy(rows)
    fine_j = np.asarray(demod_jax.fine_cfo_estimate(jnp.asarray(rows), p))
    fine_t = demod.fine_cfo_estimate(rows_t, p).numpy()
    np.testing.assert_allclose(fine_t, fine_j, rtol=0, atol=0.01)

    cfo = (fine_j + 3 * p.carrier_diff).astype(np.float32)
    sj, s0j = demod_jax.demodulate_frames_cfo(jnp.asarray(rows),
                                              jnp.asarray(cfo), p)
    st, s0t = demod.demodulate_frames_cfo(rows_t, torch.from_numpy(cfo), p)
    sj, st = np.asarray(sj), st.numpy()
    assert st.shape == sj.shape == (2, p.L - 1, 2 * p.K)
    diff = np.abs(st - sj)
    assert diff.max() <= 1.0
    assert np.mean(diff > 0) <= 1e-3
    np.testing.assert_allclose(demod.snr_estimate(s0t, p).numpy(),
                               np.asarray(demod_jax.snr_estimate(s0j, p)),
                               rtol=0, atol=1e-3)

    # coarse CFO from the unrotated PRS spectrum: the 3-carrier offset
    _, s0j = demod_jax.demodulate_frames(jnp.asarray(rows), p)
    _, s0t = demod.demodulate_frames(rows_t, p)
    cj = np.asarray(demod_jax.coarse_cfo_estimate(s0j, p))
    np.testing.assert_array_equal(demod.coarse_cfo_estimate(s0t, p).numpy(),
                                  cj)
    if p.mode != 3:   # Mode III's +-35 search runs past the band edge
        assert (cj == 3).all()

    mixed_j = np.asarray(demod_jax.apply_cfo(jnp.asarray(rows[:, :p.T_u]),
                                             jnp.asarray(cfo)))
    mixed_t = demod.apply_cfo(torch.from_numpy(rows[:, :p.T_u]),
                              torch.from_numpy(cfo)).numpy()
    np.testing.assert_allclose(mixed_t, mixed_j, rtol=0, atol=1e-4)


def test_zero_input_gives_zero_soft_bits():
    """All-zero IQ: the subnormal epsilon keeps rsqrt finite (no NaN)."""
    p = get_mode(2)
    rows = torch.zeros((1, demod.min_frame_samples(p)), dtype=torch.complex64)
    soft, _ = demod.demodulate_frames(rows, p)
    assert torch.isfinite(soft).all() and not soft.any()
