"""The port stands alone: no module of ``dabjax_torch`` (nor
``chip_smoke.py``) imports ``dabjax`` or ``bench``; with both jax and
dabjax unimportable, in a process whose spawned children see the same,
the port renders golden IQ, decodes it and runs its audio workers; and its
copy of dabjax's host plane gives what dabjax's gives: byte-identical IQ
from the modulator, and the same ensemble database, counters, PCM and data
objects from the Receiver, on the benchmark's mixed MP2 / DAB+ ensemble
with a packet-mode data service beside it."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from dabjax.io.sources import SyntheticSource as JaxSyntheticSource
from dabjax.runtime.config import ReceiverConfig as JaxReceiverConfig
from dabjax.runtime.receiver import Receiver as JaxReceiver
from dabjax.tx import fig as jax_fig
from dabjax.tx import pad as jax_pad
from dabjax.tx.modulator import Modulator as JaxModulator
from dabjax_torch import testing
from dabjax_torch.io.sources import SyntheticSource
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import Receiver
from dabjax_torch.tx import fig, pad

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_dabjax_and_no_bench():
    files = sorted((REPO / "dabjax_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 80
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("dabjax", "bench", "jax")]
    assert not bad, bad


_BLOCKED = r"""
import importlib, pkgutil, sys
import dabjax_torch
mods = [m.name for m in pkgutil.walk_packages(dabjax_torch.__path__,
                                              "dabjax_torch.")]
for m in mods:
    importlib.import_module(m)
for name in ("jax", "dabjax"):
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise AssertionError(f"{name} is importable")
from dabjax_torch import testing
from dabjax_torch.io.sources import SyntheticSource
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import Receiver
services = testing.bench_services("mixed")
payloads = {s.subch_id: (testing.mp2_payload_gen(0) if s.kind == "MP2"
                         else testing.dabplus_payload_gen(s.bitrate, 0))
            for s in services}
mod = testing.golden_modulator(mode=1, services=services, payloads=payloads)
counts = []
for workers in (0, 1):
    rx = Receiver(SyntheticSource(mod, snr_db=30.0, lead_in=1000),
                  ReceiverConfig(frames_per_block=4, audio_workers=workers),
                  device="cpu")
    try:
        m = rx.run(3)
    finally:
        rx.close()
    counts.append((m.fic_ratio, m.au_ok, m.au_bad, m.mp2_frames_ok,
                   m.mp2_frames_bad, m.superframes_ok, m.superframes_bad,
                   m.rs_corrected))
assert counts[0] == counts[1], counts
assert counts[0][0] == 1.0 and counts[0][1] > 0 and counts[0][3] > 0, counts
loaded = [k for k in sys.modules if k.split(".")[0] in ("jax", "dabjax")
          and sys.modules[k] is not None]
assert not loaded, loaded
print("OK", len(mods), counts[0])
"""


def test_port_runs_with_jax_and_dabjax_unimportable(tmp_path):
    """The subprocess, and the audio worker it spawns, find a ``jax`` and a
    ``dabjax`` package on ``PYTHONPATH`` whose import raises, and run in
    a directory outside the repository."""
    for name in ("jax", "dabjax"):
        (tmp_path / "block" / name).mkdir(parents=True)
        (tmp_path / "block" / name / "__init__.py").write_text(
            f"raise ImportError('{name} blocked for this test')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path / "block"),
                                           str(REPO)]))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK"), res.stdout


# ------------------------------------------------------ host-plane parity

PKT_BODY = b"StandalonePacket" * 20


def _packet_payload(pad_mod):
    """A packet-mode MOT object (DSCTy 60), one 96-byte packet per CIF,
    built with ``pad_mod`` (dabjax's or the port's ``tx.pad``)."""
    dgs = pad_mod.build_mot_object_datagroups(0x56, "obj.bin", PKT_BODY,
                                              content_type=2, subtype=3,
                                              seg_size=48)
    stream = pad_mod.packetize_datagroups(dgs, address=1, packet_len=96)
    n_pkts = len(stream) // 96

    def payload(cif_index: int) -> np.ndarray:
        k = cif_index % n_pkts
        return np.unpackbits(np.frombuffer(stream[k * 96: (k + 1) * 96],
                                           np.uint8))

    return payload


def _ensemble(fig_mod, pad_mod, mp2_gen, plus_gen):
    """The benchmark's mixed ensemble plus a 32 kbit/s packet service."""
    services = [fig_mod.ServiceSpec(**dataclasses.asdict(s))
                for s in testing.bench_services("mixed")]
    services.append(fig_mod.ServiceSpec(
        label="DATASVC", sid=0x8204, subch_id=9, start_addr=216, bitrate=32,
        protection="EEP-A", prot_level=3, kind="packet", dscty=60,
        packet_address=1))
    payloads = {s.subch_id: mp2_gen(0) if s.kind == "MP2"
                else plus_gen(s.bitrate, 0) for s in services[:3]}
    payloads[9] = _packet_payload(pad_mod)
    return services, payloads


def _plain(v):
    """Dataclasses, containers and scalars of either package as plain
    values (the two packages' dataclasses never compare equal)."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


@pytest.fixture(scope="module")
def both():
    services, payloads = _ensemble(fig, pad, testing.mp2_payload_gen,
                                   testing.dabplus_payload_gen)
    mod_t = testing.golden_modulator(mode=1, services=services,
                                     payloads=payloads)
    services, payloads = _ensemble(jax_fig, jax_pad, bench._mp2_payload_gen,
                                   bench._dabplus_payload_gen)
    mod_j = JaxModulator(mode=1, services=services, payloads=payloads)
    rt = Receiver(SyntheticSource(mod_t, snr_db=30.0, lead_in=1234),
                  ReceiverConfig(frames_per_block=4), device="cpu")
    rj = JaxReceiver(JaxSyntheticSource(mod_j, snr_db=30.0, lead_in=1234),
                     JaxReceiverConfig(frames_per_block=4))
    rt.run(4)
    rj.run(4)
    yield dict(mod_t=mod_t, mod_j=mod_j, rt=rt, rj=rj)
    rt.close()
    rj.close()


def test_modulator_iq_is_byte_identical(both):
    iq_t = both["mod_t"].iq(6, snr_db=20.0, seed=5)
    iq_j = both["mod_j"].iq(6, snr_db=20.0, seed=5)
    assert iq_t.dtype == iq_j.dtype and iq_t.shape == iq_j.shape
    assert iq_t.tobytes() == iq_j.tobytes()


def test_receiver_ensemble_db_matches(both):
    db_t, db_j = both["rt"].db, both["rj"].db
    assert type(db_t).__module__ == "dabjax_torch.fic.fib"
    assert _plain(vars(db_t)) == _plain(vars(db_j))
    assert db_t.data_for_data_service("DATASVC").subch_id == 9


def _service_sums(rx):
    """dabjax's per-service decoder counters summed over its services
    (dabjax's own ``Metrics`` keeps only the last service's: the port
    sums them, ROADMAP Q3)."""
    plus = [a.superframe for a in rx.audio.values() if a.superframe]
    mp2 = [a.mp2 for a in rx.audio.values() if a.mp2]
    return {"superframes_ok": sum(d.superframes_ok for d in plus),
            "superframes_bad": sum(d.superframe_errors for d in plus),
            "rs_corrected": sum(d.rs_corrected for d in plus),
            "mp2_frames_ok": sum(d.frames_ok for d in mp2),
            "mp2_frames_bad": sum(d.frames_bad for d in mp2)}


def test_receiver_counters_and_pcm_match(both):
    rt, rj = both["rt"], both["rj"]
    mt, mj = rt.metrics, rj.metrics
    fields = ("synced", "fic_crc_ok", "fic_crc_bad", "au_ok", "au_bad",
              "frames")
    assert ({f: getattr(mt, f) for f in fields}
            == {f: getattr(mj, f) for f in fields})
    sums = _service_sums(rj)
    assert {f: getattr(mt, f) for f in sums} == sums
    assert sums["superframes_ok"] > max(
        a.superframe.superframes_ok for a in rj.audio.values() if a.superframe)
    assert mt.fic_ratio == 1.0 and mt.au_ok > 0 and mt.mp2_frames_ok > 0
    assert sorted(rt.audio) == sorted(rj.audio) == [1, 2, 3]
    for subch in rt.audio:
        pcm_t = np.concatenate(rt.audio[subch].pcm)
        pcm_j = np.concatenate(rj.audio[subch].pcm)
        assert pcm_t.size > 0 and pcm_t.tobytes() == pcm_j.tobytes()


def test_receiver_routes_the_same_data_objects(both):
    rt, rj = both["rt"], both["rj"]
    assert sorted(rt.data_handlers) == sorted(rj.data_handlers) == [9]
    objs_t = rt.data_handlers[9].handler.objects
    objs_j = rj.data_handlers[9].handler.objects
    assert [(o.name, o.body) for o in objs_t] == \
        [(o.name, o.body) for o in objs_j]
    assert objs_t and objs_t[0].body == PKT_BODY
