"""The port's channel bank (MultiReceiver, run_channels) against lone
port receivers and against dabjax's MultiReceiver on the same sources,
with the bank's one device-to-host copy per block period counted."""

import os

import numpy as np
import pytest
import torch

from dabjax.io.sources import SyntheticSource
from dabjax.runtime.config import ReceiverConfig
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator
from dabjax_torch.parallel import multihost
from dabjax_torch.parallel.multihost import MultiReceiver, run_channels
from dabjax_torch.runtime.receiver import Receiver
from test_receiver_e2e import (BITRATE_MP2, BITRATE_PLUS, _dabplus_payloads,
                               _mp2_payloads)

torch.set_num_threads(1)

CFG = ReceiverConfig(mode=1, frames_per_block=4)
# the Metrics fields that time the host, which no two runs share
TIMED = {"audio_decode_seconds"}


def _source(seed, mode=1):
    """One DAB+ and one MP2 service; ``seed`` moves the start addresses
    and the stream's lead-in."""
    svc = [ServiceSpec(label=f"BANKPLUS{seed}", sid=0x7100 + seed,
                       subch_id=4, start_addr=8 * seed, bitrate=BITRATE_PLUS,
                       protection="EEP-A", prot_level=3, kind="DAB+"),
           ServiceSpec(label=f"BANKMP2{seed}", sid=0x7200 + seed,
                       subch_id=8, start_addr=8 * seed + 120,
                       bitrate=BITRATE_MP2, protection="EEP-A", prot_level=3,
                       kind="DAB")]
    payloads = {4: _dabplus_payloads()[0], 8: _mp2_payloads(40)}
    mod = Modulator(mode=mode, services=svc, payloads=payloads)
    return SyntheticSource(mod, snr_db=30.0, lead_in=700 * seed)


def _metrics(m):
    return {k: v for k, v in m.as_dict().items()
            if k not in TIMED | {"spectrum", "constellation"}}


def _counts(m):
    """The integer counters and flags of a Metrics (exact across ports)."""
    return {k: v for k, v in _metrics(m).items() if not isinstance(v, float)}


@pytest.fixture(scope="module")
def port_bank():
    """The port's 2-channel bank over 3 blocks: per-channel metrics, the
    DAB+ service's AAC AUs, and the byte count of every device-to-host
    pull."""
    bank = MultiReceiver({"5A": _source(1), "12C": _source(2)}, CFG,
                         device="cpu")
    pulls = []
    pull = bank._pull

    def counted(blob):
        pulls.append(int(blob.shape[0]))
        return pull(blob)

    bank._pull = counted
    try:
        got = bank.run(3)
        aus = {k: rx.audio[4].aac.aus for k, rx in bank.rx.items()}
    finally:
        bank.close()
    return got, aus, pulls


def test_bank_matches_lone_receivers_with_one_pull_per_step(port_bank):
    got, aus, pulls = port_bank
    assert len(pulls) == 3
    for i, chan in enumerate(("5A", "12C")):
        rx = Receiver(_source(i + 1), CFG, device="cpu")
        try:
            want = rx.run(3)
            assert aus[chan] == rx.audio[4].aac.aus
        finally:
            rx.close()
        assert got[chan].fic_ratio == 1.0
        assert got[chan].au_ok > 0 and got[chan].mp2_frames_ok > 0
        assert _metrics(got[chan]) == _metrics(want)
        np.testing.assert_array_equal(got[chan].spectrum, want.spectrum)


def test_bank_matches_dabjax_bank(port_bank):
    """dabjax's MultiReceiver on the same sources: the same counters and
    AAC AUs per channel; float metrics and the PRS spectrum within the
    float32 rounding of two FFT implementations."""
    from dabjax.parallel.multihost import MultiReceiver as JaxMultiReceiver
    got, aus, _ = port_bank
    bank = JaxMultiReceiver({"5A": _source(1), "12C": _source(2)}, CFG)
    try:
        want = bank.run(3)
        want_aus = {k: rx.audio[4].aac.aus for k, rx in bank.rx.items()}
    finally:
        bank.close()
    for chan in ("5A", "12C"):
        assert aus[chan] == want_aus[chan]
        assert _counts(got[chan]) == _counts(want[chan])
        for k, v in _metrics(want[chan]).items():
            if isinstance(v, float):
                assert got[chan].as_dict()[k] == pytest.approx(
                    v, rel=1e-4, abs=1e-3), k
        np.testing.assert_allclose(got[chan].spectrum, want[chan].spectrum,
                                   rtol=1e-4, atol=1e-4)


def test_run_channels_local_matches_lone_receivers():
    """One process owns every channel (init_distributed is a no-op) and
    decodes them as one bank, as a lone receiver each would."""
    factories = {"12C": lambda: _source(1, 2), "5A": lambda: _source(2, 2)}
    cfg = ReceiverConfig(mode=2, frames_per_block=4, decode_audio=False,
                         decode_data=False)
    got = run_channels(factories, n_blocks=2, receiver_config=cfg,
                       num_processes=1, device="cpu")
    assert set(got) == {"12C", "5A"}
    for chan, make in factories.items():
        rx = Receiver(make(), cfg, device="cpu")
        try:
            want = rx.run(2)
        finally:
            rx.close()
        m = got[chan]
        assert m.synced and m.fic_ratio == 1.0
        assert _metrics(m) == _metrics(want)


@pytest.mark.parametrize("process_id,owned", [(0, 2), (1, 1)])
def test_run_channels_share_of_a_process(process_id, owned, monkeypatch):
    """Of 3 channels over 2 processes, process 0 owns 2 (decoded as a
    bank) and process 1 owns 1 (a lone receiver)."""
    banks = []
    init = MultiReceiver.__init__

    def spy(self, sources, *args, **kw):
        banks.append(sorted(sources))
        init(self, sources, *args, **kw)

    monkeypatch.setattr(MultiReceiver, "__init__", spy)
    factories = {"12C": lambda: _source(1, 2), "5A": lambda: _source(2, 2),
                 "7D": lambda: _source(3, 2)}
    cfg = ReceiverConfig(mode=2, frames_per_block=4, decode_audio=False,
                         decode_data=False)
    got = run_channels(factories, n_blocks=1, receiver_config=cfg,
                       num_processes=2, process_id=process_id,
                       coordinator=None, device="cpu")
    mine = multihost.assign_channels(list(factories), 2, process_id)
    assert sorted(got) == mine and len(mine) == owned
    assert banks == ([mine] if owned > 1 else [])
    for m in got.values():
        assert m.synced and m.fic_ratio == 1.0


_JOIN = r"""
import sys
import torch
import torch.distributed as dist
from dabjax_torch.parallel.multihost import init_distributed
init_distributed(sys.argv[1], 2, int(sys.argv[2]))
x = torch.tensor([int(sys.argv[2]) + 1])
dist.all_reduce(x)
print(dist.get_world_size(), int(x))
dist.destroy_process_group()
"""


def test_init_distributed_joins_a_process_group():
    """Two processes on this host join one group through a tcp://
    address; a single process stays a no-op."""
    import socket
    import subprocess
    import sys
    import torch.distributed as dist

    init_distributed = multihost.init_distributed
    init_distributed("localhost:1", 1, 0)
    assert not dist.is_initialized()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def join():
        """One rendezvous on a free port: [(rc, stdout, stderr)] or None
        when it did not finish in time."""
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _JOIN, f"localhost:{port}", str(rank)],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in (0, 1)]
        try:
            return [(p,) + p.communicate(timeout=40) for p in procs]
        except subprocess.TimeoutExpired:
            return None
        finally:
            for p in procs:
                p.kill()
                p.wait()

    # the free port may be taken by another process before rank 0 binds
    # it: then the rendezvous fails or stalls, and is made again on a new
    # port
    for _ in range(3):
        res = join()
        if res and all(p.returncode == 0 for p, _, _ in res):
            break
    assert res is not None, "rendezvous did not finish"
    for p, out, err in res:
        assert p.returncode == 0, err
        assert out.split() == ["2", "3"]
