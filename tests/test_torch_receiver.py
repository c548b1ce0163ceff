"""The dabjax_torch Receiver against dabjax's: the same fixture as
tests/test_receiver_e2e.py through both, a mid-stream hand-over of the
stream state from a dabjax Receiver, an all-zero input, and the port's
independence from jax (checked in a subprocess with jax blocked)."""

import copy
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dabjax.io.sources import NullSource, SyntheticSource
from dabjax.runtime.config import ReceiverConfig
from dabjax.runtime.receiver import Receiver as JaxReceiver
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator
from dabjax_torch import testing
from dabjax_torch.runtime.receiver import Receiver
from test_receiver_e2e import (BITRATE_MP2, BITRATE_PLUS, _dabplus_payloads,
                               _mp2_payloads)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _e2e_source():
    services = [
        ServiceSpec(label="PLUSRADIO", sid=0x6001, subch_id=4, start_addr=0,
                    bitrate=BITRATE_PLUS, protection="EEP-A", prot_level=3,
                    kind="DAB+"),
        ServiceSpec(label="CLASSIC", sid=0x6002, subch_id=8, start_addr=120,
                    bitrate=BITRATE_MP2, protection="EEP-A", prot_level=3,
                    kind="DAB"),
    ]
    plus_payload, _ = _dabplus_payloads()
    mod = Modulator(mode=1, services=services,
                    payloads={4: plus_payload, 8: _mp2_payloads(40)})
    return SyntheticSource(mod, snr_db=30.0, lead_in=4321)


@pytest.fixture(scope="module")
def both():
    rj = JaxReceiver(_e2e_source(), ReceiverConfig(frames_per_block=4))
    rj.run(3)
    rt = Receiver(_e2e_source(), ReceiverConfig(frames_per_block=4),
                  device="cpu")
    rt.run(3)
    yield rj, rt
    rj.close()
    rt.close()


def test_receiver_matches_dabjax(both):
    rj, rt = both
    mj, mt = rj.metrics, rt.metrics
    assert mt.synced and mt.fic_ratio == mj.fic_ratio == 1.0
    assert sorted(rt.db.service_labels()) == sorted(rj.db.service_labels())
    assert (mt.au_ok, mt.au_bad) == (mj.au_ok, mj.au_bad)
    assert mt.au_ok >= 9 and mt.au_bad == 0
    assert mt.mp2_frames_ok == mj.mp2_frames_ok >= 10
    assert mt.mp2_frames_bad == mj.mp2_frames_bad == 0
    assert rt.audio[4].aac.aus == rj.audio[4].aac.aus
    assert (rt._u0, rt._frame_len) == (rj._u0, rj._frame_len)
    assert abs(mt.snr_db - mj.snr_db) < 1e-3


def test_stream_state_hand_over():
    """A port Receiver that takes over a dabjax Receiver's stream state
    mid-stream decodes the next block as dabjax does."""
    svc = [ServiceSpec(label="HANDOVER", sid=0x6401, subch_id=3,
                       start_addr=10, bitrate=64, protection="EEP-A",
                       prot_level=2, kind="DAB")]
    cfg = ReceiverConfig(frames_per_block=4, decode_audio=False)

    def source():
        return SyntheticSource(Modulator(mode=1, services=svc), snr_db=25.0,
                               lead_in=1500)

    rj = JaxReceiver(source(), cfg)
    rj.run(2)
    rt = Receiver(source(), cfg, device="cpu")
    rt.db = copy.deepcopy(rj.db)
    rt.load_stream_state({
        "cif_hist": np.asarray(rj._cif_hist), "hist_valid": rj._hist_valid,
        "u0": rj._u0, "frame_len": rj._frame_len,
        "coarse_hz": rj._coarse_hz})
    state = rt.stream_state()
    np.testing.assert_array_equal(state["cif_hist"], np.asarray(rj._cif_hist))
    assert state["u0"] == rj._u0 and state["hist_valid"] == 15

    bj, bt = rj.stage(), rt.stage()
    assert (bt.n_taps, bt.n_fib, bt.warmup) == (bj.n_taps, bj.n_fib, 0)
    assert [s for _, s in bt.buckets] == [s for _, s in bj.buckets]
    big_j, big_t = np.asarray(bj.merged), bt.merged.numpy()
    assert big_t.shape == big_j.shape
    # FIB payloads and logical-frame bytes: exact
    np.testing.assert_array_equal(big_t[4 * bt.n_taps:],
                                  big_j[4 * bj.n_taps:])
    taps_j = big_j[: 4 * bj.n_taps].view(np.float32)
    taps_t = big_t[: 4 * bt.n_taps].view(np.float32)
    F = cfg.frames_per_block
    # coarse CFO, PRS offsets, their flags and the FIC CRC flags: exact
    np.testing.assert_array_equal(taps_t[2 * F: 5 * F + F * bt.n_fib],
                                  taps_j[2 * F: 5 * F + F * bj.n_fib])
    np.testing.assert_allclose(taps_t[:2 * F], taps_j[:2 * F], atol=1e-3)
    rj.consume(bj)
    rt.consume(bt)
    assert rt.metrics.fic_crc_ok == 4 * F * 3
    assert rt.stream_state()["u0"] == rj._u0
    # the block holds CIFs 32..47 after 15 of history (CIFs 17..31):
    # output row t is transmitted logical frame 17 + t
    frames = big_t[4 * bt.n_taps + F * bt.n_fib * 30:].reshape(
        bt.buckets[0][1])[0]
    mod = Modulator(mode=1, services=svc)
    assert frames.shape == (16, 3 * 64)
    for t in range(frames.shape[0]):
        np.testing.assert_array_equal(
            frames[t], np.packbits(mod.payload_bits(3, 17 + t)))


def test_null_source_stays_finite():
    """No signal: acquisition fails cleanly; a forced block over all-zero
    IQ gives finite taps and zero soft bits (no NaN from the subnormal
    epsilon of the DQPSK normalisation)."""
    rt = Receiver(NullSource(), ReceiverConfig(frames_per_block=2),
                  device="cpu")
    m = rt.run(1)
    assert not m.synced and m.frames == 0
    rt._u0 = float(rt._buf_base)
    blk = rt.stage()
    cifs_zero = rt._cif_hist
    assert torch.isfinite(cifs_zero).all() and not cifs_zero.any()
    rt.consume(blk)
    assert np.isfinite(rt.metrics.snr_db)
    assert np.isfinite(rt.metrics.constellation).all()
    assert rt.metrics.fic_crc_ok == 0


def test_modulator_stand_in_only_without_jax():
    """With jax present the helper must leave dabjax's FIC decoder
    module alone (its tests use decode_fic)."""
    assert testing.jax_available()
    testing.golden_modulator(mode=2)
    from dabjax.fic import fic_decoder
    assert hasattr(fic_decoder, "decode_fic")


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                      # import jax now raises
import dabjax_torch
from dabjax_torch import testing
mods = [m.name for m in pkgutil.walk_packages(dabjax_torch.__path__,
                                              "dabjax_torch.")]
for m in mods:
    importlib.import_module(m)
assert not testing.jax_available()
from dabjax.tx.fig import ServiceSpec
mod = testing.golden_modulator(mode=2, services=[ServiceSpec(
    label="NOJAX", sid=0x6501, subch_id=1, start_addr=0, bitrate=64,
    protection="EEP-A", prot_level=2, kind="DAB")])
iq = mod.iq(2)
import numpy as np, torch
from dabjax_torch.runtime.pipeline import frame_pipeline
from dabjax_torch.ofdm.demod import min_frame_samples
p = mod.p
u0 = p.T_null + p.T_g
rows = np.stack([iq[u0: u0 + min_frame_samples(p)]]).view(np.float32)
rows = torch.from_numpy(rows.reshape(1, -1, 2))
_, _, ok, _ = frame_pipeline(p, device="cpu")(rows)
assert bool(ok.all())
new = {"dabjax_torch.cli", "dabjax_torch.__main__",
       "dabjax_torch.parallel.multihost", "dabjax_torch.runtime.scan",
       "dabjax_torch.runtime.profiling", "dabjax_torch.tools",
       "dabjax_torch.tools.vit_variants2", "dabjax_torch.tools.vit_split2",
       "dabjax_torch.tools.hbm_probe", "dabjax_torch.tools.vit_variants",
       "dabjax_torch.tools.vit_split", "dabjax_torch.tools.vpu_probe",
       "dabjax_torch.tools.vpu_probe2"}
assert new <= set(mods), new - set(mods)
from dabjax_torch.fec import viterbi, viterbi_cuda
from dabjax.fec.viterbi import viterbi_decode_np
soft = np.random.default_rng(0).integers(-127, 128, (2, 4 * 27))
for fmt in ("i8mxu", "i8", "f32"):
    viterbi_cuda.SOFT_FMT = fmt
    dec, last = viterbi.viterbi_forward_words(torch.from_numpy(soft), 21)
    bits = viterbi.viterbi_traceback_words(dec, last, 21)
    assert (bits.numpy() == viterbi_decode_np(soft, 21)).all(), fmt
import contextlib, io
from dabjax_torch import cli
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert cli.main(["scan", "5A=null", "--blocks", "1"]) == 1
assert "5A: no signal" in out.getvalue()
from dabjax_torch.parallel.multihost import MultiReceiver
from dabjax.io.sources import NullSource
bank = MultiReceiver({"5A": NullSource()}, None, device="cpu")
assert not bank.run(1)["5A"].synced
bank.close()
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k == "jax" or k.startswith("jax.")
                                or k.startswith("jaxlib"))]
assert not loaded, loaded
print("OK", len(mods))
"""


def test_port_imports_no_jax():
    for path in (REPO / "dabjax_torch").rglob("*.py"):
        assert not re.search(r"^\s*(import|from) jax\b", path.read_text(),
                             re.MULTILINE), path
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")
