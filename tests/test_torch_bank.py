"""The port's channel bank (MultiReceiver, run_channels) against lone
port receivers and against dabjax's MultiReceiver on the same sources,
with the bank's one device-to-host copy per block period counted and its
spans (``bank_stage``, ``bank_pull``, ``bank_consume``) read."""

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
BANK = ("bank_stage", "bank_pull", "bank_consume")
# the Metrics fields that time the host, which no two runs share
TIMED = {"audio_decode_seconds"}


class _Budget:
    """A source that runs dry after ``n`` samples."""

    sample_rate = 2_048_000

    def __init__(self, src, n):
        self.src, self.left = src, n

    def read(self, n):
        take = min(n, self.left)
        self.left -= take
        return self.src.read(take)


def _source(seed, mode=1, frames=None):
    """One DAB+ and one MP2 service; ``seed`` moves the start addresses
    and the stream's lead-in; with ``frames`` the stream runs dry after
    the lead-in and that many mode I frames (a 4-frame block each 4)."""
    svc = [ServiceSpec(label=f"BANKPLUS{seed}", sid=0x7100 + seed,
                       subch_id=4, start_addr=8 * seed, bitrate=BITRATE_PLUS,
                       protection="EEP-A", prot_level=3, kind="DAB+"),
           ServiceSpec(label=f"BANKMP2{seed}", sid=0x7200 + seed,
                       subch_id=8, start_addr=8 * seed + 120,
                       bitrate=BITRATE_MP2, protection="EEP-A", prot_level=3,
                       kind="DAB")]
    payloads = {4: _dabplus_payloads()[0], 8: _mp2_payloads(40)}
    mod = Modulator(mode=mode, services=svc, payloads=payloads)
    src = SyntheticSource(mod, snr_db=30.0, lead_in=700 * seed)
    if frames is None:
        return src
    return _Budget(src, 700 * seed + frames * mod.p.T_F)


def _metrics(m):
    return {k: v for k, v in m.as_dict().items()
            if k not in TIMED | {"spectrum", "constellation"}}


def _counts(m):
    """The integer counters and flags of a Metrics (exact across ports)."""
    return {k: v for k, v in _metrics(m).items() if not isinstance(v, float)}


#: bank cases: {channel: (seed, frames)} and the block periods run.  Two
#: endless channels over 3 periods; three channels at three start
#: offsets that run dry after 3, 4 and 5 blocks, so that periods 4 and 5
#: stage fewer channels and period 6 stages none.
BANKS = {"2ch": ({"5A": (1, None), "12C": (2, None)}, 3),
         "3ch": ({"5A": (1, 12), "12C": (2, 16), "7D": (3, 20)}, 6)}


def _recorded(rx):
    """Record the logical frames ``rx`` routes: [(subch, frame bytes)]."""
    routed = []
    route = rx._route_rows

    def _route_rows(subch_id, frames, warmup):
        routed.extend((subch_id, f.tobytes()) for f in frames[warmup:])
        return route(subch_id, frames, warmup)

    rx._route_rows = _route_rows
    return routed


@pytest.fixture(scope="module", params=sorted(BANKS))
def port_bank(request):
    """A port bank run over its case's periods: per-channel metrics, the
    DAB+ service's AAC AUs, each channel's routed frames, the byte count
    of every device-to-host pull, what each step progressed, and the
    bank's spans."""
    chans, periods = BANKS[request.param]
    bank = MultiReceiver({c: _source(seed, frames=fr)
                          for c, (seed, fr) in chans.items()}, CFG,
                         device="cpu")
    routed = {c: _recorded(rx) for c, rx in bank.rx.items()}
    pulls, steps = [], []
    pull, step = bank._pull, bank.step

    def counted(blob):
        pulls.append(int(blob.shape[0]))
        return pull(blob)

    def stepped():
        steps.append(step())
        return steps[-1]

    bank._pull, bank.step = counted, stepped
    try:
        got = bank.run(periods)
        aus = {k: rx.audio[4].aac.aus for k, rx in bank.rx.items()}
    finally:
        bank.close()
    return dict(chans=chans, periods=periods, got=got, aus=aus,
                routed=routed, pulls=pulls, steps=steps,
                spans=bank.profiler.stages)


def test_bank_matches_lone_receivers_with_one_pull_per_step(port_bank):
    b = port_bank
    staged = [s for s in b["steps"] if any(s.values())]
    assert len(b["pulls"]) == len(staged)
    for chan, (seed, fr) in b["chans"].items():
        rx = Receiver(_source(seed, frames=fr), CFG, device="cpu")
        routed = _recorded(rx)
        try:
            want = rx.run(b["periods"])
            assert b["aus"][chan] == rx.audio[4].aac.aus
        finally:
            rx.close()
        got = b["got"][chan]
        assert routed and b["routed"][chan] == routed, chan
        assert got.fic_ratio == 1.0
        assert got.au_ok > 0 and got.mp2_frames_ok > 0
        assert _metrics(got) == _metrics(want)
        np.testing.assert_array_equal(got.spectrum, want.spectrum)


def test_bank_opens_its_spans_once_a_staging_period(port_bank):
    """Each bank span once a period that stages a channel, none on a
    period that stages nothing; ``bank_stage`` counts the channels
    staged and ``bank_pull`` the joined blobs' bytes."""
    b = port_bank
    staged = [s for s in b["steps"] if any(s.values())]
    spans = b["spans"]
    assert {n: spans[n].calls for n in BANK} == \
        {n: len(staged) for n in BANK}
    assert spans["bank_stage"].items == sum(sum(s.values()) for s in staged)
    assert spans["bank_pull"].items == sum(b["pulls"]) > 0
    assert spans["bank_consume"].items == 0
    if b["periods"] > len(staged):
        # the 3-channel case: fewer channels in its last periods, then
        # a period that stages none
        assert [sum(s.values()) for s in b["steps"]] == [3, 3, 3, 2, 1, 0]


def test_bank_spans_lie_on_the_trace_clock(tmp_path):
    """Under ``device_trace`` each bank span is a ``user_annotation``
    once a period, and the channels' ``stage_host`` and ``consume_host``
    lie inside ``bank_stage`` and ``bank_consume``."""
    import json
    from dabjax_torch.runtime.profiling import device_trace
    cfg = ReceiverConfig(mode=1, frames_per_block=4, decode_audio=False)
    bank = MultiReceiver({"5A": _source(1), "12C": _source(2)}, cfg,
                         device="cpu")
    try:
        bank.step()
        with device_trace(str(tmp_path)) as prof:
            for _ in range(2):
                assert all(bank.step().values())
    finally:
        bank.close()
    with open(prof.trace_path) as f:
        spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
                 for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]

    def within(name, parent):
        outer = [s for s in spans if s[0] == parent]
        inner = [s for s in spans if s[0] == name]
        return len(inner) == 4 and all(
            any(a <= s[1] and s[2] <= b for _, a, b in outer)
            for s in inner)

    assert {n: sum(s[0] == n for s in spans) for n in BANK} == \
        {n: 2 for n in BANK}
    assert within("stage_host", "bank_stage")
    assert within("consume_host", "bank_consume")


def test_bank_matches_dabjax_bank(port_bank):
    """dabjax's MultiReceiver on the same sources: the same counters and
    AAC AUs per channel; float metrics and the PRS spectrum within the
    float32 rounding of two FFT implementations."""
    from dabjax.parallel.multihost import MultiReceiver as JaxMultiReceiver
    b = port_bank
    bank = JaxMultiReceiver({c: _source(seed, frames=fr)
                             for c, (seed, fr) in b["chans"].items()}, CFG)
    try:
        want = bank.run(b["periods"])
        want_aus = {k: rx.audio[4].aac.aus for k, rx in bank.rx.items()}
    finally:
        bank.close()
    for chan in b["chans"]:
        got = b["got"][chan]
        assert b["aus"][chan] == want_aus[chan]
        assert _counts(got) == _counts(want[chan])
        for k, v in _metrics(want[chan]).items():
            if isinstance(v, float):
                assert got.as_dict()[k] == pytest.approx(
                    v, rel=1e-4, abs=1e-3), k
        np.testing.assert_allclose(got.spectrum, want[chan].spectrum,
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
