"""The harness cut by transmission mode, on the CPU at small size: the
loop, the reference, ``judge`` and the block-graph bound for Modes I, II
and IV (120 CIFs a loop: 30, 120 and 60 frames), and Mode III refused."""

import numpy as np
import pytest

from dabbench import run
from dabbench.common import reference_of
from dabbench.drivers.core import judge
from dabbench.gen import loop
from dabbench.gen.constants import get_mode
from dabbench.gen.fic.fib import EnsembleDB
from dabbench.gen.fic_layout import fic_codewords_per_frame
from dabbench.reference.receiver import HISTORY, Reference, loop_rows
from dabbench.tests.conftest import small_config

MODES = [1, 2, 4]


def mode_config(mode: int, n: int = 3) -> dict:
    """``small_config``'s first ``n`` services in transmission mode
    ``mode``."""
    return dict(small_config(n=n), mode=mode)


@pytest.fixture(scope="module", params=MODES)
def rendered(request):
    """A two-service loop of one mode at seed 11."""
    return loop.make_loop(mode_config(request.param), 11)


@pytest.mark.parametrize("mode", MODES)
def test_loop_is_one_payload_period_and_seeded(mode):
    cfg = mode_config(mode)
    a = loop.make_loop(cfg, 2 ** 31 + 5)
    p = a.p
    per = loop.period(p)
    assert per.frames * p.cifs_per_frame == loop.PERIOD_CIFS
    assert per.start * p.cifs_per_frame == loop.START_CIF
    assert a.u8.shape == (per.frames * p.T_F, 2)
    assert a.u8.dtype == np.uint8
    for s in cfg["services"]:
        for c in range(0, loop.PERIOD_CIFS, 11):
            assert np.array_equal(a.payload_bytes(s["subch"], c),
                                  a.payload_bytes(s["subch"],
                                                  c + loop.PERIOD_CIFS))
    b = loop.make_loop(cfg, 2 ** 31 + 5)
    assert a.u8.tobytes() == b.u8.tobytes()
    c = loop.make_loop(cfg, 2 ** 31 + 6)
    assert a.u8.shape == c.u8.shape and a.u8.tobytes() != c.u8.tobytes()
    offsets = {loop.start_offset(cfg, 2 ** 31 + 5, k) for k in range(64)}
    assert offsets <= {f * p.T_F for f in range(per.frames)}


def test_two_passes_of_the_loop_decode_to_the_payload(rendered):
    """The loop played twice, decoded by the reference: every PRS found,
    every FIB CRC passes, FIG 0/0 counts the CIFs of the frame it heads
    (``cifs_per_frame`` a frame), and every logical frame across the seam
    is the transmitted payload."""
    lp, cfg = rendered, rendered.cfg
    ref = Reference(cfg, "cpu")
    p, per = lp.p, loop.period(lp.p)
    two = np.concatenate([lp.u8, lp.u8])
    cifs, fibs, ok = [], [], []
    for f0 in range(0, 2 * per.frames, 10):
        d = ref.demod(loop_rows(two, p, range(f0, min(f0 + 10,
                                                      2 * per.frames))))
        assert (d["t_off"] == 0).all() and d["t_ok"].all()
        assert (d["coarse"] == 0).all()
        fib, fic_ok = ref.fic(d["soft"])
        fibs.append(fib)
        ok.append(fic_ok)
        cifs.append(ref.cifs(d["soft"]))
    ok, fibs = np.concatenate(ok), np.concatenate(fibs)
    assert ok.shape == (2 * per.frames, 3 * fic_codewords_per_frame(p))
    assert ok.all()
    for f, row in enumerate(fibs):
        db = EnsembleDB()
        db.process_fib_bytes(row[0].tobytes())
        want = (per.start + f % per.frames) * p.cifs_per_frame
        assert db.cif_count == want % 5000
    cifs = np.concatenate(cifs)
    assert cifs.shape[0] == 2 * loop.PERIOD_CIFS
    frames = ref.msc(cifs, cfg["services"])
    for s in cfg["services"]:
        got = frames[s["subch"]]
        assert got.shape == (2 * loop.PERIOD_CIFS - HISTORY,
                             3 * s["bitrate"])
        for t in range(got.shape[0]):       # across the seam at CIF 120
            assert np.array_equal(got[t], lp.payload_bytes(s["subch"], t))


def test_judge_passes_the_references_own_reading(rendered):
    """The reference's reading of one period, handed to ``judge`` as the
    port's blob of a block two periods long, counts nothing bad; with a
    subchannel missing, ``cifs_per_frame`` logical frames a frame."""
    lp = rendered
    p, per = lp.p, loop.period(lp.p)
    ref = reference_of(lp, "cpu")
    F = 2 * per.frames
    f = np.arange(F) % per.frames
    port = {k: ref[k][f] for k in ("snr", "fine", "coarse", "t_off",
                                   "t_ok", "fic_ok", "fib")}
    port["spectrum"] = ref["spectra"][f].mean(axis=0)
    port["constel"] = ref["constel"][0]
    port["frames"] = {sid: fr[np.arange(p.cifs_per_frame * F) % fr.shape[0]]
                      for sid, fr in ref["frames"].items()}
    c = judge(port, ref, p, F, 0)
    assert c.correct, c.values
    assert all(v == 0 for v in c.values.values()), c.values
    sid = next(iter(port["frames"]))
    del port["frames"][sid]
    assert judge(port, ref, p, F, 0).values["frames_bad"] \
        == p.cifs_per_frame * F


@pytest.mark.parametrize("mode", MODES)
def test_blockgraph_bound_counts_the_modes_cifs(mode):
    """Mode I's 360 frames, II's 1440 and IV's 720 are one 34.56 s block
    of 1440 CIFs: the same row, CIF and FIB bytes, so the same bound."""
    from dabjax_torch.ofdm.demod import min_frame_samples
    p = get_mode(mode)
    F = 12 * loop.period(p).frames
    n_fib = 3 * fic_codewords_per_frame(p)
    shapes = {"F": F, "need": int(min_frame_samples(p)), "T_u": p.T_u,
              "L": p.L, "K": p.K, "cifs_per_frame": p.cifs_per_frame,
              "cif_bits": 55296, "n_fib": n_fib}
    bound = run.read_layer_metric("blockgraph_roofline").bound_s(shapes)
    assert F * shapes["need"] * 2 == 139_282_560
    assert bound == pytest.approx((139_282_560 + 1440 * 55296 + 1440 * 3
                                   * 30) / 3.35e12, rel=1e-12)


def test_mode_iii_is_refused():
    cfg = mode_config(3)
    for call in (lambda: loop.period(get_mode(3)),
                 lambda: loop.make_loop(cfg, 0),
                 lambda: loop.start_offset(cfg, 0, 0)):
        with pytest.raises(ValueError, match="coarse-CFO search"):
            call()
