"""The readers of the receiver's spans in the live cell: the four host
ms a block (``program_spans``) and the two launch counts a block (kernels
placed in ``blockgraph`` / ``msc`` by the trace), each ``None`` when its
span is absent, as on a program that does not open it."""

import pytest

from dabbench import run
from dabbench.common import LayerContext
from dabbench.trace import Trace

HOST = {"source_ms.live": "source",
        "blockgraph_issue_ms.live": "blockgraph",
        "msc_issue_ms.live": "msc",
        "route_ms.live": "route"}
LAUNCHES = {"blockgraph_launches.live": "blockgraph",
            "msc_launches.live": "msc"}


def _ctx(blocks=4, program_spans=None, trace=None):
    return LayerContext(trace=trace, blocks=blocks, periods=blocks,
                        signal_s=blocks * 4 * 0.096,
                        program_spans=program_spans or {}, counters={},
                        shapes={"F": 4}, cfg={}, wl={})


def _trace(blocks, spans=("stage_host", "blockgraph", "msc", "pull",
                          "consume_host")):
    """``blocks`` blocks, each with its spans in turn (1 ms apart) and,
    in each span, one kernel more than in the last (stage_host 1,
    blockgraph 2, msc 3, ...), plus a copy that is no kernel."""
    device, host = [], []
    for b in range(blocks):
        for k, name in enumerate(spans):
            t = b * 10_000.0 + k * 1_000.0
            host.append((name, t, 900.0))
            for i in range(k + 1):
                device.append(("kern", "kernel", t + 10.0 * i, 5.0, name))
            device.append(("Memcpy", "gpu_memcpy", t, 5.0, name))
    device.append(("kern", "kernel", 0.0, 5.0, None))
    return Trace(device=device, spans=host,
                 window=(0.0, blocks * 10_000.0))


@pytest.mark.parametrize("metric", sorted(HOST))
def test_host_reader_is_its_span_ms_a_block(metric):
    mod = run.read_layer_metric(metric)
    assert mod.UNIT == "ms/block"
    spans = {"stage_host": 0.5, "consume_host": 0.25, HOST[metric]: 0.03}
    assert mod.read(_ctx(blocks=4, program_spans=spans)) == \
        pytest.approx(7.5)
    assert mod.read(_ctx(blocks=4, program_spans={
        "stage_host": 0.5, "consume_host": 0.25})) is None
    assert mod.read(_ctx(blocks=0, program_spans=spans)) is None


@pytest.mark.parametrize("metric", sorted(LAUNCHES))
def test_launch_reader_counts_its_spans_kernels_a_block(metric):
    mod = run.read_layer_metric(metric)
    assert mod.UNIT == "launches/block"
    want = {"blockgraph": 2, "msc": 3}[LAUNCHES[metric]]
    assert mod.read(_ctx(blocks=3, trace=_trace(3))) == want
    # the parent's trace: the receiver's old spans only
    old = _trace(3, spans=("stage_host", "pull", "consume_host"))
    assert mod.read(_ctx(blocks=3, trace=old)) is None
    assert mod.read(_ctx(blocks=3, trace=None)) is None
    assert mod.read(_ctx(blocks=0, trace=_trace(3))) is None


def test_launch_readers_add_up_to_launches_live():
    """Every kernel of a block lies in ``blockgraph`` or ``msc`` when the
    receiver issues nothing elsewhere."""
    trace = _trace(2, spans=("stage_host", "blockgraph", "msc"))
    trace.device = [e for e in trace.device
                    if e[4] in ("blockgraph", "msc")]
    ctx = _ctx(blocks=2, trace=trace)
    total = run.read_layer_metric("launches.live").read(ctx)
    parts = sum(run.read_layer_metric(m).read(ctx) for m in LAUNCHES)
    assert parts == total == 5
