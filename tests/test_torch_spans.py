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
    assert len(set(SPANS)) == len(SPANS) == 10
    assert len(RECEIVER) == 7
    assert {"stage_host", "pull", "consume_host"} <= set(RECEIVER)
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
