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


def _u8_rows(iq, p, u0, frames):
    """uint8 (re, im) pair rows of ``frames`` frames from ``u0`` on, as an
    SDR's 8-bit samples: round(128 x + 128), clipped."""
    need = demod.min_frame_samples(p)
    x = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                  for f in range(frames)])
    pairs = np.stack([x.real, x.imag], axis=-1) * 128.0 + 128.0
    return torch.from_numpy(np.clip(np.round(pairs), 0, 255).astype(np.uint8))


def _block_frames_before(rows, coarse_hz, p, kind):
    """``BlockFn.frames`` as it was written before the demod became one
    entry point: the plain chain, inline."""
    from dabjax_torch.fic.fic_decoder import decode_fic
    from dabjax_torch.msc.cif import cifs_from_soft
    from dabjax_torch.msc.subchannel import pack_bits_u8
    if kind == "u8":
        x = (rows.to(torch.float32) - 128.0) * (1.0 / 128.0)
    else:
        x = rows.to(torch.float32)
    x = torch.view_as_complex(x.contiguous())
    fine = demod.fine_cfo_estimate(x, p)
    cfo = fine + coarse_hz
    soft, spec0 = demod.demodulate_frames_cfo(x, cfo, p)
    prs_rows = demod.apply_cfo(x[:, : p.T_u], cfo)
    fibs, fic_ok = decode_fic(soft[:, : p.fic_symbols, :], p)
    t_off, t_ok = acquisition.prs_sync(prs_rows, p)
    return {"snr": demod.snr_estimate(spec0, p), "fine": fine,
            "coarse": demod.coarse_cfo_estimate(spec0, p),
            "t_off": t_off, "t_ok": t_ok, "fic_ok": fic_ok,
            "spectrum": torch.abs(torch.roll(spec0, p.T_u // 2, dims=-1)),
            "constel": soft[:1, p.fic_symbols, :],
            "fib_bytes": pack_bits_u8(fibs[..., :240]),
            "cifs": cifs_from_soft(soft, p)}, soft


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_block_frames_on_cpu_as_before(golden, kind):
    """On the CPU ``BlockFn.frames`` runs the plain chain and gives every
    output it gave before, bit for bit; its CIF block is
    ``cifs_from_soft(soft)``; the kernels' counters stay at 0."""
    from dabjax_torch.msc.cif import cifs_from_soft
    from dabjax_torch.ofdm import demod_cuda
    from dabjax_torch.runtime.receiver import BlockFn
    p, iq = golden
    u0 = acq_jax.acquire(iq, p)
    rows = _u8_rows(iq, p, u0, 2)
    if kind == "f32":
        rows = (rows.to(torch.float32) - 128.0) / 128.0
    coarse = torch.full((2,), float(3 * p.carrier_diff))
    demod_cuda.reset_launches()
    got = BlockFn(p, kind, device="cpu").frames(rows, coarse)
    want, soft = _block_frames_before(rows, coarse, p, kind)
    assert (demod_cuda.GUARD_LAUNCHES, demod_cuda.MIX_LAUNCHES,
            demod_cuda.SOFT_LAUNCHES) == (0, 0, 0)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(got["cifs"], cifs_from_soft(soft, p))
    assert bool(got["fic_ok"].all())


def test_demodulate_rows_on_cpu_is_the_plain_chain(golden):
    """``demodulate_rows`` on CPU rows of each kind is
    ``demodulate_rows_torch``: the plain chain, with no kernel counted."""
    from dabjax_torch.ofdm import demod_cuda
    p, iq = golden
    u0 = acq_jax.acquire(iq, p)
    u8 = _u8_rows(iq, p, u0, 2)
    f32 = (u8.to(torch.float32) - 128.0) / 128.0
    coarse = torch.zeros(2)
    demod_cuda.reset_launches()
    for kind, rows in (("u8", u8), ("f32", f32),
                       ("c64", torch.view_as_complex(f32))):
        got = demod.demodulate_rows(rows, coarse, p, kind)
        want = demod.demodulate_rows_torch(rows, coarse, p, kind)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got.cifs.shape == (2 * p.cifs_per_frame, 55296)
        assert got.fic.shape == (2, p.fic_symbols, 2 * p.K)
    assert (demod_cuda.GUARD_LAUNCHES, demod_cuda.MIX_LAUNCHES,
            demod_cuda.SOFT_LAUNCHES) == (0, 0, 0)


def test_demod_entry_checks_rows_on_cpu():
    """The row checks raise on the CPU too: an unknown kind, a dtype or
    shape that does not fit the kind, a row shorter than a frame, no
    frames; the kernels' wrappers refuse a CPU tensor."""
    from dabjax_torch.ofdm import demod_cuda
    p = get_mode(1)
    need = demod.min_frame_samples(p)
    rows = torch.zeros((2, need, 2), dtype=torch.uint8)
    coarse = torch.zeros(2)
    bad = [(rows, "u16"), (rows.to(torch.float32), "u8"),
           (rows, "f32"), (rows[:, :-1], "u8"), (rows[:0], "u8"),
           (torch.zeros((2, need, 3), dtype=torch.uint8), "u8"),
           (torch.zeros((2, need), dtype=torch.complex128), "c64"),
           (torch.zeros((2, need, 2), dtype=torch.complex64), "c64")]
    for r, kind in bad:
        with pytest.raises(ValueError):
            demod.demodulate_rows(r, coarse, p, kind)
    for call in (lambda: demod_cuda.guard_corr(rows, p, "u8"),
                 lambda: demod_cuda.mix_windows(rows, coarse, p, "u8",
                                                demod.FS),
                 lambda: demod_cuda.dqpsk_soft(
                     torch.zeros((2, p.L, p.T_u), dtype=torch.complex64),
                     coarse, p, demod.FS,
                     torch.zeros((2, p.fic_symbols, 2 * p.K)),
                     torch.zeros((2, p.L - 1 - p.fic_symbols, 2 * p.K)))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
