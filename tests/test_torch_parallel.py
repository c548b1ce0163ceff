"""The port's multi-device path against dabjax's on the CPU: the same
numpy rows through dabjax's sharded step on the 8 virtual CPU devices of
``tests/conftest.py`` and the port's on a (2, 4) mesh of ``cpu`` x 8, and
the same streams through ``Receiver(mesh=...)`` of both packages and the
port's single-device ``Receiver`` (the sizes of tests/test_parallel.py).
"""

import numpy as np
import pytest
import torch

import jax

from dabjax.io.sources import SyntheticSource as JaxSyntheticSource
from dabjax.parallel import mesh as jax_mesh
from dabjax.parallel import sharding as jax_sharding
from dabjax.runtime.config import ReceiverConfig as JaxReceiverConfig
from dabjax.runtime.receiver import Receiver as JaxReceiver
from dabjax.tx import fig as jax_fig
from dabjax.tx.modulator import Modulator as JaxModulator
from dabjax_torch.constants import get_mode
from dabjax_torch.devices import resolve
from dabjax_torch.io.sources import SyntheticSource
from dabjax_torch.msc.cif import cifs_from_soft
from dabjax_torch.msc.deinterleave import HISTORY
from dabjax_torch.msc.subchannel import (EnsembleDecoder, SubchGeometry,
                                         decode_subchannel, msc_soft)
from dabjax_torch.ofdm import demod
from dabjax_torch.parallel.dryrun import FrameCapture, dryrun_multichip
from dabjax_torch.parallel.mesh import Mesh, make_mesh, pick_grid
from dabjax_torch.parallel.sharding import (make_sharded_inputs,
                                            sharded_ensemble_step)
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import Receiver
from dabjax_torch.tx import fig
from dabjax_torch.tx.modulator import Modulator
from test_torch_standalone import _plain

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID = (2, 4)


def _cpu_mesh():
    return make_mesh(8, GRID, devices=[CPU] * 8)


def _services(spec):
    """tests/test_parallel.py's 4 x 96 kbit/s EEP-A ensemble."""
    return [spec(label=f"SVC{i}", sid=0x7000 + i, subch_id=i,
                 start_addr=i * 100, bitrate=96, protection="EEP-A",
                 prot_level=3, kind="DAB+") for i in range(4)]


@pytest.mark.parametrize("max_subch", [1, 2, 3, 4])
def test_pick_grid_matches_dabjax(max_subch):
    for n in range(1, 17):
        assert pick_grid(n, max_subch) == jax_mesh.pick_grid(n, max_subch)


def test_make_mesh_places_positions_as_given():
    mesh = _cpu_mesh()
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("time", "subch")
    assert mesh.shape == {"time": 2, "subch": 4} and mesh.size == 8
    assert mesh.home == CPU and mesh.positions() == [CPU] * 8
    assert make_mesh(devices=["cpu"] * 6).shape == {"time": 2, "subch": 3}
    with pytest.raises(ValueError):
        make_mesh(8, (3, 3), devices=[CPU] * 8)
    with pytest.raises(ValueError):
        make_mesh(8, devices=[CPU] * 4)


def test_make_mesh_without_devices_needs_the_cards():
    """Without ``devices`` the mesh is one card a position: more positions
    than cards raise, never repeat a card or fall back to the CPU."""
    n_cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError):
        make_mesh(n_cards + 1)
    if n_cards == 0:
        with pytest.raises(RuntimeError):
            make_mesh()
    else:
        mesh = make_mesh(n_cards)
        assert len(set(mesh.positions())) == n_cards
        assert all(d.type == "cuda" for d in mesh.positions())


def test_bare_cuda_names_the_current_card(monkeypatch):
    """A bare "cuda" resolves to the current card, so a mesh built from
    "cuda" has an indexed home and the home checks compare "cuda" and
    "cuda:0" as one device."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve("cuda") == torch.device("cuda", 0)
    assert resolve(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert resolve("cpu") == CPU
    mesh = make_mesh(2, (1, 2), devices=["cuda"] * 2)
    assert mesh.home == torch.device("cuda", 0)
    assert mesh.positions() == [torch.device("cuda", 0)] * 2


@pytest.fixture(scope="module")
def step_run():
    """Mode I, 8 frames (16 CIFs a time row) through both sharded steps
    and the port's single-device pieces."""
    p = get_mode(1)
    mod = Modulator(mode=1, services=_services(fig.ServiceSpec))
    iq = mod.iq(8, snr_db=None)
    u0 = p.T_null + p.T_g
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(8)])
    geoms = [SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                           s.bitrate, s.protection, s.prot_level)
             for s in _services(fig.ServiceSpec)]
    starts = np.array([g.start_addr for g in geoms], np.int32)

    mesh_j = jax_mesh.make_mesh(8, GRID)
    step_j = jax_sharding.sharded_ensemble_step(mesh_j, p, geoms[0])
    fic_j, bits_j = jax.block_until_ready(step_j(
        *jax_sharding.make_sharded_inputs(mesh_j, rows, starts)))

    mesh = _cpu_mesh()
    step = sharded_ensemble_step(mesh, p, geoms[0])
    fic_t, bits_t = step(*make_sharded_inputs(mesh, rows, starts))

    x = torch.view_as_complex(torch.from_numpy(
        rows.view(np.float32).reshape(8, need, 2)))
    fine = demod.fine_cfo_estimate(x, p)
    cifs = cifs_from_soft(demod.demodulate_frames_cfo(x, fine, p)[0], p)
    return dict(p=p, mod=mod, geoms=geoms, cifs=cifs, mesh=mesh,
                fic_j=float(fic_j), bits_j=np.asarray(bits_j),
                fic_t=fic_t, bits_t=bits_t.numpy())


def test_sharded_step_matches_dabjax(step_run):
    r = step_run
    assert r["fic_t"].shape == () and r["fic_t"].dtype == torch.float32
    assert float(r["fic_t"]) == r["fic_j"] == 1.0
    bits = r["bits_t"]
    assert bits.shape == r["bits_j"].shape == (4, 32, 24 * 96)
    np.testing.assert_array_equal(bits[:, 15:], r["bits_j"][:, 15:])
    for i, g in enumerate(r["geoms"]):
        for t in range(17):
            np.testing.assert_array_equal(
                bits[i, 15 + t], r["mod"].payload_bits(g.subch_id, t))


def test_sharded_step_warmup_and_halo(step_run):
    """Row 0 decodes over a zero history; row 1 over row 0's last 15
    CIFs, so its first 15 outputs are the single-device decode's."""
    r = step_run
    geoms, cifs, bits = r["geoms"], r["cifs"], r["bits_t"]
    T_row = cifs.shape[0] // GRID[0]
    idx = torch.tensor([[g.start_addr * 64 + j for j in
                         range(g.length_cus * 64)] for g in geoms])

    def decode(block):
        return decode_subchannel(msc_soft(block)[:, idx].transpose(0, 1),
                                 geoms[0]).numpy()

    zero = torch.zeros((HISTORY, cifs.shape[1]))
    np.testing.assert_array_equal(
        bits[:, :T_row], decode(torch.cat([zero, cifs[:T_row]])))
    single = EnsembleDecoder(geoms, r["p"], device=CPU).decode(cifs)
    want = np.stack([single[g.subch_id] for g in geoms])   # CIFs 15..31
    np.testing.assert_array_equal(bits[:, 15:], want)
    halo = slice(T_row, T_row + HISTORY)
    np.testing.assert_array_equal(
        bits[:, halo], want[:, T_row - HISTORY: T_row])
    # the bucket decode split over the mesh gives the same bits
    sharded = EnsembleDecoder(geoms[:3], r["p"], r["mesh"],
                              device=CPU).decode(cifs)
    for g in geoms[:3]:
        np.testing.assert_array_equal(sharded[g.subch_id], single[g.subch_id])


def test_sharded_step_rejects_a_short_shard(step_run):
    r = step_run
    mesh = make_mesh(8, (8, 1), devices=[CPU] * 8)   # 4 CIFs a row
    rows = np.zeros((8, demod.min_frame_samples(r["p"])), np.complex64)
    step = sharded_ensemble_step(mesh, r["p"], r["geoms"][0])
    with pytest.raises(ValueError, match="halo"):
        step(*make_sharded_inputs(mesh, rows, np.zeros(4, np.int64)))
    with pytest.raises(ValueError):
        make_sharded_inputs(r["mesh"], rows[:7], np.zeros(4, np.int64))


def _mixed(spec):
    """tests/test_parallel.py's two-bucket ensemble."""
    return ([spec(label=f"BIG{i}", sid=0x7100 + i, subch_id=i,
                  start_addr=i * 120, bitrate=96, protection="EEP-A",
                  prot_level=3, kind="DAB+") for i in range(2)]
            + [spec(label=f"SML{i}", sid=0x7110 + i, subch_id=4 + i,
                    start_addr=400 + i * 40, bitrate=32,
                    protection="EEP-B", prot_level=3, kind="DAB+")
               for i in range(3)])


def _factory(store):
    return lambda db, subch_id: store.setdefault(subch_id, FrameCapture())


@pytest.fixture(scope="module")
def receivers():
    """Two 8-frame blocks through the port's single-device and mesh
    Receivers, block by block, and through dabjax's mesh Receiver, at
    30 dB SNR (on clean IQ every frame's PRS spectrum is the same, and
    a spectrum mean over the wrong frames would not show)."""
    cfg = ReceiverConfig(mode=1, frames_per_block=8, decode_audio=False,
                         decode_data=True)
    store = {"single": {}, "mesh": {}, "jax": {}}

    def source():
        return SyntheticSource(Modulator(mode=1, services=_mixed(
            fig.ServiceSpec)), snr_db=30.0, lead_in=300)

    r1 = Receiver(source(), cfg, _factory(store["single"]), device=CPU)
    r2 = Receiver(source(), cfg, _factory(store["mesh"]), mesh=_cpu_mesh(),
                  device=CPU)
    blocks = []
    for _ in range(2):
        b1, b2 = r1.stage(), r2.stage()
        blocks.append((b1, b2, b1.merged.numpy(), b2.merged.numpy()))
        r1.consume(b1)
        r2.consume(b2)
    rj = JaxReceiver(
        JaxSyntheticSource(JaxModulator(mode=1, services=_mixed(
            jax_fig.ServiceSpec)), snr_db=30.0, lead_in=300),
        JaxReceiverConfig(mode=1, frames_per_block=8, decode_audio=False,
                          decode_data=True),
        data_handler_factory=_factory(store["jax"]),
        mesh=jax_mesh.make_mesh(8, GRID))
    rj.run(2)
    yield dict(r1=r1, r2=r2, rj=rj, blocks=blocks, store=store)
    for rx in (r1, r2, rj):
        rx.close()


def test_receiver_mesh_frames_match_single_and_dabjax(receivers):
    r1, r2, rj = receivers["r1"], receivers["r2"], receivers["rj"]
    single, mesh, ref = (receivers["store"][k]
                         for k in ("single", "mesh", "jax"))
    assert r1.metrics.fic_ratio == r2.metrics.fic_ratio == 1.0
    assert rj.metrics.fic_ratio == 1.0
    assert sorted(single) == sorted(mesh) == sorted(ref) == [0, 1, 4, 5, 6]
    for k in single:
        a, b, c = (np.stack(s[k].frames) for s in (single, mesh, ref))
        assert a.shape[0] > 0
        np.testing.assert_array_equal(b, a, err_msg=f"subch {k}")
        np.testing.assert_array_equal(b, c, err_msg=f"subch {k}")
    assert _plain(vars(r2.db)) == _plain(vars(r1.db)) == _plain(vars(rj.db))


def test_receiver_mesh_blob_matches_single(receivers):
    """The mesh blob has the single-device layout: float taps within
    1e-3, FIB bytes and every real subchannel's frame bytes equal; the
    bucket shapes count the pad rows (8 a bucket on 8 positions)."""
    for b1, b2, big1, big2 in receivers["blocks"]:
        assert (b2.n_taps, b2.n_fib, b2.warmup) == (b1.n_taps, b1.n_fib,
                                                   b1.warmup)
        n = 4 * b1.n_taps
        np.testing.assert_allclose(big2[:n].view(np.float32),
                                   big1[:n].view(np.float32), atol=1e-3)
        fib = b1.F * b1.n_fib * 30
        np.testing.assert_array_equal(big2[n: n + fib], big1[n: n + fib])
        assert [s[0] for _, s in b1.buckets] == [len(g) for g, _ in
                                                 b1.buckets]
        assert [s[0] for _, s in b2.buckets] == [8] * len(b1.buckets)
        off1, off2 = n + fib, n + fib
        for (g1, s1), (g2, s2) in zip(b1.buckets, b2.buckets):
            assert g1 == g2 and s1[1:] == s2[1:]
            a = big1[off1: off1 + int(np.prod(s1))].reshape(s1)
            b = big2[off2: off2 + int(np.prod(s2))].reshape(s2)
            np.testing.assert_array_equal(b[: s1[0]], a)
            np.testing.assert_array_equal(b[s1[0]:], np.broadcast_to(
                a[:1], (s2[0] - s1[0],) + s1[1:]))   # pads repeat row 0
            off1 += a.size
            off2 += b.size
        assert off1 == big1.size and off2 == big2.size
    # the first block comes before the FIC names the subchannels
    assert [len(g) for g, _ in receivers["blocks"][-1][0].buckets] == [2, 3]


def test_receiver_mesh_rejects_bad_setup():
    mesh = _cpu_mesh()
    src = SyntheticSource(Modulator(mode=1, services=_mixed(
        fig.ServiceSpec)[:1]))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        Receiver(src, ReceiverConfig(frames_per_block=12), mesh=mesh,
                 device=CPU)
    with pytest.raises(ValueError, match="home"):
        Receiver(src, ReceiverConfig(frames_per_block=8), mesh=mesh,
                 device="meta")
    with pytest.raises(ValueError, match="home"):
        EnsembleDecoder([], get_mode(1), mesh, device="meta")


def test_dryrun_multichip_on_cpu_mesh(capsys):
    line = dryrun_multichip(8, devices=[CPU] * 8)
    assert capsys.readouterr().out.strip() == line
    assert line == ("dryrun_multichip OK: mesh=(2, 4) fic_ratio=1.000 "
                    "bits=(8, 32, 768) payload=EXACT "
                    "receiver_mesh=bit-identical (4 subchannels)")
