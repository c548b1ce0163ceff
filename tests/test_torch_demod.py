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
    from dabjax_torch import _build
    from dabjax_torch.runtime.receiver import BlockFn
    p, iq = golden
    u0 = acq_jax.acquire(iq, p)
    rows = _u8_rows(iq, p, u0, 2)
    if kind == "f32":
        rows = (rows.to(torch.float32) - 128.0) / 128.0
    coarse = torch.full((2,), float(3 * p.carrier_diff))
    _build.LAUNCHES.clear()
    got = BlockFn(p, kind, device="cpu").frames(rows, coarse)
    want, soft = _block_frames_before(rows, coarse, p, kind)
    assert [_build.LAUNCHES[k] for k in ("guard_corr", "mix_windows",
                                         "dqpsk_soft")] == [0, 0, 0]
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(got["cifs"], cifs_from_soft(soft, p))
    assert bool(got["fic_ok"].all())


def test_demodulate_rows_on_cpu_is_the_plain_chain(golden):
    """``demodulate_rows`` on CPU rows of each kind is
    ``demodulate_rows_torch``: the plain chain, with no kernel counted."""
    from dabjax_torch import _build
    p, iq = golden
    u0 = acq_jax.acquire(iq, p)
    u8 = _u8_rows(iq, p, u0, 2)
    f32 = (u8.to(torch.float32) - 128.0) / 128.0
    coarse = torch.zeros(2)
    _build.LAUNCHES.clear()
    for kind, rows in (("u8", u8), ("f32", f32),
                       ("c64", torch.view_as_complex(f32))):
        got = demod.demodulate_rows(rows, coarse, p, kind)
        want = demod.demodulate_rows_torch(rows, coarse, p, kind)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got.cifs.shape == (2 * p.cifs_per_frame, 55296)
        assert got.fic.shape == (2, p.fic_symbols, 2 * p.K)
    assert [_build.LAUNCHES[k] for k in ("guard_corr", "mix_windows",
                                         "dqpsk_soft")] == [0, 0, 0]


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


def _coarse_spectra(p, iq, seed):
    """complex64 PRS spectra [14, T_u]: two frames of the golden IQ, the
    PRS reference shifted by -35, -34, -1, 0, 1, 34 and 35 carriers
    under noise, and five of complex noise alone."""
    from dabjax_torch.ofdm import tables
    u0 = acq_jax.acquire(iq, p)
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(2)])
    _, s0 = demod.demodulate_frames(torch.from_numpy(rows), p)
    rng = np.random.default_rng(seed)

    def noise(n):
        return rng.standard_normal((n, p.T_u)) \
            + 1j * rng.standard_normal((n, p.T_u))

    ref = tables.phase_ref_bins(p.mode, p.T_u, p.K)
    shifts = (-35, -34, -1, 0, 1, 34, 35)
    shifted = np.stack([np.roll(ref, s) for s in shifts]) + 0.3 * noise(7)
    return torch.cat([s0, torch.from_numpy(
        np.concatenate([shifted, noise(5)]).astype(np.complex64))])


def test_coarse_cfo_on_cpu_is_the_plain_chain(golden):
    """On a CPU tensor ``coarse_cfo_estimate`` is
    ``coarse_cfo_estimate_torch`` and equals dabjax's filter, frame by
    frame, on real PRS spectra, shifted references (the search's ends
    included; Mode III's clamped edge) and noise; no kernel counted."""
    from dabjax_torch import _build
    p, iq = golden
    spec = _coarse_spectra(p, iq, seed=p.mode)
    _build.LAUNCHES.clear()
    got = demod.coarse_cfo_estimate(spec, p)
    want = demod.coarse_cfo_estimate_torch(spec, p)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(demod_jax.coarse_cfo_estimate(
            jnp.asarray(spec.numpy()), p)))
    if p.mode != 3:   # Mode III's +-35 search runs past the band edge
        assert got[2:9].tolist() == [-35, -34, -1, 0, 1, 34, 35]
    assert _build.LAUNCHES["coarse_cfo"] == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrapper's checks and
    its launch arguments, without one."""
    is_cuda = property(lambda self: True)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_coarse_cfo_wrapper_refuses_bad_input(mode):
    """``demod_cuda.coarse_cfo`` raises before any launch on a CPU
    tensor, a dtype other than complex64, a row of another length than
    T_u, rows whose bins are not contiguous or are a conjugate view,
    more than 65535 frames (a meta tensor: no memory) and a search it
    cannot take."""
    from dabjax_torch import _build
    from dabjax_torch.ofdm import demod_cuda
    p = get_mode(mode)
    spec = torch.zeros((4, p.T_u), dtype=torch.complex64)
    bad = {"CUDA": spec,
           "complex64": [spec.to(torch.complex128), spec.real,
                         spec[0], spec[:, :-1], spec.repeat(1, 2),
                         spec[:0]],
           "contiguous": [torch.zeros((4, 2 * p.T_u),
                                      dtype=torch.complex64)[:, ::2],
                          torch.zeros((p.T_u, 4),
                                      dtype=torch.complex64).t(),
                          spec.conj()],
           "65535": torch.empty((65536, p.T_u), dtype=torch.complex64,
                                device="meta").as_subclass(_OnCard)}
    _build.LAUNCHES.clear()
    for match, cases in bad.items():
        for case in cases if isinstance(cases, list) else [cases]:
            with pytest.raises(ValueError, match=match):
                demod_cuda.coarse_cfo(case.as_subclass(_OnCard)
                                      if match != "CUDA" else case, p)
    for search in (-1, demod_cuda.MAX_SEARCH + 1):
        with pytest.raises(ValueError, match="search"):
            demod_cuda.coarse_cfo(spec.as_subclass(_OnCard), p, search)
    assert _build.LAUNCHES["coarse_cfo"] == 0


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_coarse_cfo_entry_is_declared_and_launched(mode, monkeypatch):
    """``ENTRIES`` declares the kernel's C entry, and the wrapper hands
    ``_build.launch`` one argument of the declared kind for each:
    the spectrum, its row stride (a row view of the FFT's [F, L, T_u]
    output is taken as it is), F, T_u, K, the search, the reference
    products and the int32 output."""
    import ctypes
    from dabjax_torch.ofdm import demod_cuda
    p = get_mode(mode)
    want = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    assert demod_cuda.ENTRIES["dabjax_demod_coarse_cfo"] == want
    calls = []
    monkeypatch.setattr(demod_cuda._build, "launch",
                        lambda *a: calls.append(a))
    spec = torch.zeros((3, p.L, p.T_u), dtype=torch.complex64)[:, 0]
    out = demod_cuda.coarse_cfo(spec.as_subclass(_OnCard), p)
    (key, entries, name, device, *args), = calls
    assert (key, name, device) == ("coarse_cfo", "dabjax_demod_coarse_cfo",
                                   torch.device("cpu"))
    assert entries is demod_cuda.ENTRIES
    ref = demod._coarse_ref(p.mode, p.T_u, p.K, torch.device("cpu"))
    assert args == [spec.data_ptr(), p.L * p.T_u, 3, p.T_u, p.K, 35,
                    ref.data_ptr(), out.data_ptr()]
    for arg, ctype in zip(args, want):
        ctype(arg)
    assert out.dtype == torch.int32 and out.shape == (3,)
    assert p.K % 3 == 0     # the kernel's carriers a lane at a time
