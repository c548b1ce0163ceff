"""The upload cell's readers on synthetic traces, and, on the card, the
port's upload path that the cell drives (``Receiver._block`` on pinned
host rows)."""

import json

import pytest
import torch

from dabbench import run
from dabbench.common import LayerContext
from dabbench.peaks import PCIE_H2D_BYTES_S
from dabbench.trace import Trace

OVERLAP = "upload_overlap_pct.core_upload"
ROOFLINE = "upload_roofline.core_upload"
#: one core block's rows: 360 frames of 193,448 u8 pairs
SHAPES = {"F": 360, "need": 193_448}


def _ctx(device, blocks=1):
    trace = Trace(device=device, spans=[], window=(0.0, 100_000.0))
    return LayerContext(trace=trace, blocks=blocks, periods=blocks,
                        signal_s=blocks * 34.56, program_spans={},
                        counters={}, shapes=SHAPES, cfg={}, wl={})


def _copy(ts, dur, name="Memcpy HtoD (Pinned -> Device)"):
    return (name, "gpu_memcpy", ts, dur, "blockgraph")


def _kernel(ts, dur):
    return ("kern", "kernel", ts, dur, "blockgraph")


@pytest.mark.parametrize("kernels,want", [
    ([_kernel(200.0, 100.0)], 0.0),                    # after the copy
    ([_kernel(0.0, 400.0)], 100.0),                    # the copy under it
    ([_kernel(150.0, 400.0)], 50.0),                   # half under
    ([_kernel(100.0, 30.0), _kernel(120.0, 30.0),      # overlapping kernels
      _kernel(180.0, 10.0)], 60.0),                    # count once
], ids=["before", "under", "half", "union"])
def test_overlap_is_the_copy_time_under_kernels(kernels, want):
    ctx = _ctx([_copy(100.0, 100.0), *kernels])
    assert run.read_layer_metric(OVERLAP).read(ctx) == pytest.approx(want)


def test_readers_leave_out_a_window_with_no_upload():
    ctx = _ctx([_kernel(0.0, 10.0),
                _copy(20.0, 10.0, "Memcpy DtoH (Device -> Pinned)")])
    assert run.read_layer_metric(OVERLAP).read(ctx) is None
    assert run.read_layer_metric(ROOFLINE).read(ctx) is None
    assert run.read_layer_metric(ROOFLINE).read(_ctx([], 0)) is None


def test_roofline_is_the_rows_at_the_link_peak_over_the_copy_time():
    bound_us = SHAPES["F"] * SHAPES["need"] * 2 / PCIE_H2D_BYTES_S * 1e6
    # two blocks, each uploaded in two copies of twice the bound in all
    device = [_copy(k * 20_000.0 + h * bound_us, bound_us)
              for k in range(2) for h in range(2)]
    ctx = _ctx(device + [_kernel(50_000.0, 10.0)], blocks=2)
    assert run.read_layer_metric(ROOFLINE).read(ctx) == pytest.approx(50.0)


@pytest.fixture(scope="module")
def upload_driver():
    """The upload cell's driver on the card, at the cell's size, set up
    (two warm blocks: the graph captured)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dabbench.drivers.core_upload import Driver
    from dabbench.gen.loop import load_config
    from dabbench.trace import Spans
    wl = run.load_workload("dabplus12_eep3a.core_upload")
    d = Driver(load_config(wl["config"]), wl, 2 ** 31 + 77,
               torch.device("cuda:0"), Spans(False))
    d.setup()
    yield d
    d.release()


@pytest.mark.cuda
def test_host_rows_decode_as_device_rows(upload_driver):
    from dabjax_torch.runtime.receiver import BlockFn
    d = upload_driver
    plain = BlockFn(d.p, "u8", device=d.dev)
    coarse = torch.zeros(d.F, dtype=torch.float32, device=d.dev)
    for rows in d.rows:
        assert rows.is_pinned()
        cifs, blob = d.rx._block(rows)
        got = (cifs.clone(), blob.clone())
        want = plain(rows.to(d.dev), coarse)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_alternating_host_buffers_replay_one_graph(upload_driver):
    from dabjax_torch import _build
    from dabjax_torch.runtime.receiver import BlockFn
    d = upload_driver
    graph = d.rx._block_fn._graph
    replay = graph._replay
    assert replay is not None
    counts = []
    for k in range(4):
        before = _build.LAUNCHES.copy()
        d.rx._block(d.rows[k % 2])
        counts.append(_build.LAUNCHES - before)
        assert graph._replay is replay          # never captured again
    dev_rows = d.rows[0].to(d.dev)
    coarse = torch.zeros(d.F, dtype=torch.float32, device=d.dev)
    plain = BlockFn(d.p, "u8", device=d.dev)
    for _ in range(3):                          # eager, capture, replay
        before = _build.LAUNCHES.copy()
        plain.frames(dev_rows, coarse)
    assert all(c == _build.LAUNCHES - before for c in counts)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_block_makes_one_host_to_device_copy(upload_driver, tmp_path):
    """One copy a block, of the block's rows: 139,282,560 bytes at the
    cell's size, by the trace's own byte counts."""
    from torch.profiler import ProfilerActivity, profile
    d = upload_driver
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for rows in d.rows:
            d.rx._block(rows)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    assert len(copies) == 2, [e["name"] for e in copies]
    row_bytes = d.F * d.need * 2
    assert row_bytes == 139_282_560
    assert [e["args"]["bytes"] for e in copies] == [row_bytes] * 2
