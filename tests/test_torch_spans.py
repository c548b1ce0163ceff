"""The receiver's spans (``runtime/profiling.py`` ``SPANS``, less the
channel bank's ``bank_*`` spans): one of each a block once locked, at
their layers' extents, and on the profiler's clock under
``device_trace`` (and only there), on a port ``Receiver`` reading the
port's own modulator on the CPU."""

import contextlib
import json

import pytest
import torch

from dabjax_torch.runtime import profiling
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.profiling import SPANS, StageProfiler, device_trace
from dabjax_torch.runtime.receiver import Receiver
from dabjax_torch.testing import LoopSource, golden_modulator
from dabjax_torch.tx.fig import ServiceSpec

torch.set_num_threads(1)

#: the receiver's spans; the rest of SPANS are the bank's
RECEIVER = tuple(n for n in SPANS if not n.startswith("bank_"))


class _Count:
    def __init__(self):
        self.frames = 0

    def add_logical_frame(self, bits):
        self.frames += 1


@pytest.fixture(scope="module")
def rx():
    services = [ServiceSpec(label="SPANPLUS", sid=0x7001, subch_id=1,
                            start_addr=0, bitrate=32, protection="EEP-A",
                            prot_level=3, kind="DAB+"),
                ServiceSpec(label="SPANMP2", sid=0x7002, subch_id=2,
                            start_addr=40, bitrate=32, protection="EEP-A",
                            prot_level=3, kind="DAB")]
    iq = golden_modulator(mode=1, services=services).frames(24)
    r = Receiver(LoopSource(iq),
                 ReceiverConfig(frames_per_block=2, decode_audio=False,
                                decode_data=True),
                 data_handler_factory=lambda db, sid: _Count(),
                 device="cpu")
    # lock, and run on until every block reads the source (acquisition
    # reads frames ahead)
    for _ in range(12):
        locked, before = r._u0 is not None, _calls(r, "source")
        r.step()
        if locked and len(r.db.services) == 2 \
                and _calls(r, "source") > before:
            break
    assert r.metrics.synced and len(r.db.services) == 2
    yield r
    r.close()


def _calls(r, name):
    st = r.profiler.stages.get(name)
    return st.calls if st is not None else 0


def _run(r, n):
    r.profiler.stages.clear()
    for _ in range(n):
        assert r.step()


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"]
    ops = [(e["name"], e["ts"]) for e in events if e.get("cat") == "cpu_op"]
    return spans, ops


def _inside(t, spans, name):
    return any(n == name and a <= t <= b for n, a, b in spans)


def _count(spans, name):
    return sum(1 for s in spans if s[0] == name)


def test_spans_are_named_once():
    assert len(set(SPANS)) == len(SPANS) == 11
    assert len(RECEIVER) == 8
    assert {"stage_host", "pull", "pull_wait", "consume_host"} \
        <= set(RECEIVER)
    assert set(SPANS) - set(RECEIVER) == {"bank_stage", "bank_pull",
                                          "bank_consume"}


def test_each_span_once_a_block(rx):
    n = 3
    _run(rx, n)
    st = rx.profiler.stages
    assert {name: st[name].calls for name in RECEIVER} == \
        {name: n for name in RECEIVER}
    # the nested spans are parts of their parents
    assert st["blockgraph"].seconds <= st["stage_host"].seconds
    assert st["route"].seconds <= st["consume_host"].seconds


def test_device_trace_puts_spans_on_the_trace_clock(rx, tmp_path):
    """Each span once a block as a ``user_annotation``; ``blockgraph``
    inside ``stage_host``, ``route`` inside ``consume_host``; the block
    graph's FFTs and every op of ``BlockFn`` start in ``blockgraph``, every
    op of ``fused`` in ``msc``."""
    n = 2
    block_fn, decoder = rx._block_fn, rx._decoder

    def marked(fn, mark):
        def call(*args, **kwargs):
            with torch.profiler.record_function(mark):
                return fn(*args, **kwargs)
        return call

    block_fn.frames = marked(block_fn.frames, "test.frames")
    block_fn.assemble = marked(block_fn.assemble, "test.assemble")
    decoder.fused = marked(decoder.fused, "test.fused")
    try:
        rx.profiler.stages.clear()
        with device_trace(str(tmp_path)) as prof:
            for _ in range(n):
                assert rx.step()
    finally:
        del block_fn.frames, block_fn.assemble, decoder.fused
    assert rx._decoder is decoder
    assert not profiling._recording
    spans, ops = _annotations(prof.trace_path)
    assert {name: _count(spans, name) for name in RECEIVER} == \
        {name: n for name in RECEIVER}
    for name, parent in (("blockgraph", "stage_host"),
                         ("route", "consume_host")):
        for s in spans:
            if s[0] == name:
                assert _inside(s[1], spans, parent) \
                    and _inside(s[2], spans, parent)
    ffts = [t for name, t in ops if name.startswith("aten::_fft")]
    assert ffts and all(_inside(t, spans, "blockgraph") for t in ffts)
    for mark, span in (("test.frames", "blockgraph"),
                       ("test.assemble", "blockgraph"),
                       ("test.fused", "msc")):
        marks = [s for s in spans if s[0] == mark]
        assert len(marks) == n
        for _, a, b in marks:
            assert _inside(a, spans, span) and _inside(b, spans, span)
            inner = [t for name, t in ops
                     if name.startswith("aten::") and a <= t <= b]
            assert inner and all(_inside(t, spans, span) for t in inner)


def test_recording_is_restored_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError):
        with device_trace(str(tmp_path)):
            assert profiling._recording
            raise ValueError("body")
    assert not profiling._recording


def test_spans_record_nothing_outside_device_trace(rx, tmp_path):
    """A plain profile sees no receiver span: the program opens ranges
    only inside ``device_trace``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert rx.step()
    path = str(tmp_path / "plain.json")
    prof.export_chrome_trace(path)
    spans, _ = _annotations(path)
    assert not [s for s in spans if s[0] in SPANS]


def test_benchmark_wrapper_opens_each_span_once(rx, tmp_path):
    """The benchmark's traced run (a plain profile, the receiver's
    ``stage`` wrapped by ``dabbench.common.traced_profiler``) sees each
    span once a block, never doubled."""
    from torch.profiler import ProfilerActivity, profile
    from dabbench.common import traced_profiler
    from dabbench.trace import Spans
    n = 2
    own = rx.profiler
    rx.profiler = StageProfiler()
    try:
        traced_profiler(rx, Spans(True))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n):
                assert rx.step()
        st = rx.profiler.stages
        assert {name: st[name].calls for name in RECEIVER} == \
            {name: n for name in RECEIVER}
    finally:
        rx.profiler = own
    path = str(tmp_path / "harness.json")
    prof.export_chrome_trace(path)
    spans, _ = _annotations(path)
    assert {name: _count(spans, name) for name in RECEIVER} == \
        {name: n for name in RECEIVER}


def test_stage_keeps_its_signature():
    prof = StageProfiler()
    with prof.stage("x", 5.0):
        pass
    with prof.stage("x", items=3.0):
        pass
    with contextlib.suppress(RuntimeError):
        with prof.stage("x"):
            raise RuntimeError
    st = prof.stages["x"]
    assert (st.calls, st.items) == (3, 8.0) and st.seconds >= 0.0
    assert "x" in prof.report().splitlines()[1]


def test_stage_takes_items_in_its_body_and_drops():
    """A body may set its span's items once it knows them, or drop the
    span, which is then not counted (a bank period that stages
    nothing)."""
    prof = StageProfiler()
    with prof.stage("x", 2.0) as span:
        span.items = 7.0
    with prof.stage("x") as span:
        span.drop()
    with prof.stage("y") as span:
        span.drop()
    assert (prof.stages["x"].calls, prof.stages["x"].items) == (1, 7.0)
    assert "y" not in prof.stages


# -------------------------------------------------------- span records

def _profiled(body):
    """The records made while ``body`` runs under a plain profile."""
    from torch.profiler import ProfilerActivity, profile
    profiling.clear_records()
    with profile(activities=[ProfilerActivity.CPU]):
        body()
    assert profiling.overflow() == 0
    return profiling.records()


def _steps(r, n):
    def body():
        for _ in range(n):
            assert r.step()
    return body


def _by_block(recs, names=RECEIVER):
    """{block: {name: [record]}} of the records named in ``names``."""
    out = {}
    for rec in recs:
        if rec.name in names:
            out.setdefault(rec.block, {}).setdefault(rec.name, []).append(rec)
    return out


def test_no_record_is_made_outside_a_profiler(rx):
    import gc
    profiling.clear_records()
    _run(rx, 2)
    with StageProfiler().stage("x"):
        gc.collect()
    assert profiling.records() == [] and profiling.overflow() == 0


def test_each_block_records_each_receiver_span_once(rx):
    """A locked block gives one record of each receiver span, all with
    the block's number and the receiver's tag; the blocks are numbered
    in turn."""
    n = 3
    blocks = _by_block(_profiled(_steps(rx, n)))
    assert len(blocks) == n and None not in blocks
    first = min(blocks)
    assert sorted(blocks) == list(range(first, first + n))
    for names in blocks.values():
        assert {name: len(recs) for name, recs in names.items()} == \
            {name: 1 for name in RECEIVER}
        assert {rec.owner for recs in names.values() for rec in recs} == \
            {rx._chan_tag}


def test_record_parents_are_the_spans_open_around_them(rx):
    recs = _profiled(_steps(rx, 2))
    by_id = {rec.id: rec for rec in recs}
    want = {"blockgraph": "stage_host", "route": "consume_host",
            "pull_wait": "pull"}
    for rec in recs:
        if rec.name in want:
            parent = by_id[rec.parent]
            assert parent.name == want[rec.name]
            assert parent.block == rec.block
            assert parent.start_ns <= rec.start_ns <= rec.end_ns \
                <= parent.end_ns
        elif rec.name in RECEIVER:
            assert rec.parent == -1, rec.name


def test_records_lie_on_the_device_trace_clock(rx, tmp_path):
    """Under ``device_trace`` each record's start and end, in Unix
    microseconds, are its ``record_function`` event's ``ts`` +
    ``baseTimeNanoseconds`` / 1000 and that plus ``dur``, within 1 ms."""
    profiling.clear_records()
    with device_trace(str(tmp_path)) as prof:
        for _ in range(2):
            assert rx.step()
    recs = [r for r in profiling.records() if r.name in RECEIVER]
    with open(prof.trace_path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"] / 1e3
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e.get("name") in RECEIVER),
                    key=lambda e: e["ts"])
    assert len(events) == len(recs) == 2 * len(RECEIVER)
    for name in RECEIVER:
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        theirs = [e for e in events if e["name"] == name]
        for rec, e in zip(mine, theirs, strict=True):
            assert abs(rec.start_ns / 1e3 - (e["ts"] + base)) < 1e3
            assert abs(rec.end_ns / 1e3 - (e["ts"] + e["dur"] + base)) < 1e3


def test_collection_in_a_span_is_recorded_under_it():
    import gc
    prof = StageProfiler()

    def body():
        with prof.stage("outer"):
            gc.collect()

    recs = _profiled(body)
    outer = [r for r in recs if r.name == "outer"]
    full = [r for r in recs if r.name == "gc" and r.items == 2.0]
    assert len(outer) == 1 and len(full) == 1
    assert full[0].parent == outer[0].id
    assert (full[0].owner, full[0].block) == (None, None)
    assert outer[0].start_ns <= full[0].start_ns <= full[0].end_ns \
        <= outer[0].end_ns


def test_records_carry_owner_and_block_and_drop_with_the_span():
    prof = StageProfiler(owner="bank", block=7)

    def body():
        with prof.stage("kept", 3.0):
            with prof.stage("dropped") as span:
                span.drop()

    recs = [r for r in _profiled(body) if r.name != "gc"]
    assert [(r.name, r.owner, r.block, r.items, r.parent) for r in recs] \
        == [("kept", "bank", 7, 3.0, -1)]


def test_ring_keeps_the_newest_and_counts_what_it_lost(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    monkeypatch.setattr(profiling, "_ring", [None] * 8)
    prof = StageProfiler()

    def body():
        for k in range(13):
            with prof.stage("s", float(k)):
                pass

    from torch.profiler import ProfilerActivity, profile
    profiling.clear_records()
    with profile(activities=[ProfilerActivity.CPU]):
        body()
    spans = [r.items for r in profiling.records() if r.name == "s"]
    lost = profiling.overflow()
    assert lost >= 5 and len(profiling.records()) == 8
    assert spans == [float(k) for k in range(13)][-len(spans):]
    profiling.clear_records()
    assert profiling.records() == [] and profiling.overflow() == 0


def test_records_are_made_once_under_the_benchmark_wrapper(rx):
    from dabbench.common import traced_profiler
    from dabbench.trace import Spans
    own = rx.profiler
    rx.profiler = StageProfiler(owner=own.owner)
    try:
        traced_profiler(rx, Spans(True))
        blocks = _by_block(_profiled(_steps(rx, 2)))
    finally:
        rx.profiler = own
    assert len(blocks) == 2
    for names in blocks.values():
        assert {name: len(recs) for name, recs in names.items()} == \
            {name: 1 for name in RECEIVER}


def test_reads_while_acquiring_carry_no_block():
    """A fresh receiver's first block: the source's reads while it
    acquires carry no block; its first block is numbered 0."""
    iq = golden_modulator(mode=1, services=[
        ServiceSpec(label="ACQ", sid=0x7003, subch_id=1, start_addr=0,
                    bitrate=32, protection="EEP-A", prot_level=3,
                    kind="DAB+")]).frames(24)
    r = Receiver(LoopSource(iq), ReceiverConfig(frames_per_block=2,
                                                decode_audio=False),
                 device="cpu")
    try:
        recs = _profiled(_steps(r, 1))
    finally:
        r.close()
    sources = [rec.block for rec in recs if rec.name == "source"]
    assert sources[0] is None
    assert {rec.block for rec in recs
            if rec.name in ("stage_host", "pull", "pull_wait",
                            "consume_host")} == {0}


def test_bank_records_carry_the_period():
    """A bank's spans carry its period's number and the owner "bank";
    each channel's spans its own tag and block, ``stage_host`` under
    ``bank_stage`` and ``consume_host`` under ``bank_consume``."""
    from dabjax_torch.parallel.multihost import MultiReceiver
    services = [ServiceSpec(label="BANKREC", sid=0x7004, subch_id=1,
                            start_addr=0, bitrate=32, protection="EEP-A",
                            prot_level=3, kind="DAB+")]
    iq = golden_modulator(mode=1, services=services).frames(24)
    bank = MultiReceiver({"a": LoopSource(iq), "b": LoopSource(iq)},
                         ReceiverConfig(frames_per_block=2,
                                        decode_audio=False), device="cpu")
    try:
        bank.step()

        def body():
            for _ in range(2):
                assert all(bank.step().values())

        recs = _profiled(body)
        tags = {r.profiler.owner for r in bank.rx.values()}
    finally:
        bank.close()
    by_id = {rec.id: rec for rec in recs}
    periods = _by_block([r for r in recs if r.owner == "bank"],
                        ("bank_stage", "bank_pull", "bank_consume"))
    assert sorted(periods) == [1, 2]
    for names in periods.values():
        assert {n: len(v) for n, v in names.items()} == \
            {"bank_stage": 1, "bank_pull": 1, "bank_consume": 1}
    chan = [r for r in recs if r.name in ("stage_host", "consume_host")]
    assert len(chan) == 2 * 2 * 2 and {r.owner for r in chan} == tags
    for rec in chan:
        parent = by_id[rec.parent]
        assert parent.owner == "bank"
        assert parent.name == {"stage_host": "bank_stage",
                               "consume_host": "bank_consume"}[rec.name]


@pytest.mark.cuda
def test_receiver_records_on_the_card(tmp_path):
    """On a card, a locked receiver's blocks under ``device_trace``: each
    receiver span once a block, ``pull_wait`` inside ``pull`` (the
    stream's sync waited for the block), no capture once its graphs
    replay, and each record within 1 ms of its event on the trace's
    clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dabjax_torch.testing import bench_services
    dev = torch.device("cuda", 0)
    iq = golden_modulator(mode=1, services=bench_services("mixed")).frames(24)
    r = Receiver(LoopSource(iq),
                 ReceiverConfig(frames_per_block=4, decode_audio=False,
                                decode_data=True), device=dev)
    try:
        for _ in range(8):
            assert r.step()
        captured = profiling.PROCESS.stages["capture"].calls
        profiling.clear_records()
        with device_trace(str(tmp_path)) as prof:
            for _ in range(3):
                assert r.step()
        assert profiling.PROCESS.stages["capture"].calls == captured
    finally:
        r.close()
    recs = profiling.records()
    assert not [x for x in recs if x.name == "capture"]
    blocks = _by_block(recs)
    assert len(blocks) == 3
    for names in blocks.values():
        assert {name: len(v) for name, v in names.items()} == \
            {name: 1 for name in RECEIVER}
        wait, pull = names["pull_wait"][0], names["pull"][0]
        assert pull.start_ns <= wait.start_ns <= wait.end_ns <= pull.end_ns
    with open(prof.trace_path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"] / 1e3
    for name in RECEIVER:
        mine = sorted((x for x in recs if x.name == name),
                      key=lambda x: x.start_ns)
        theirs = sorted((e for e in trace["traceEvents"]
                         if e.get("cat") == "user_annotation"
                         and e.get("name") == name), key=lambda e: e["ts"])
        for rec, e in zip(mine, theirs, strict=True):
            assert abs(rec.start_ns / 1e3 - (e["ts"] + base)) < 1e3
            assert abs(rec.end_ns / 1e3 - (e["ts"] + e["dur"] + base)) < 1e3
