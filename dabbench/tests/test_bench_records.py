"""The readers of the program's span records (``profiling.records``):
each on a synthetic set of records, and ``None`` when the ring
overflowed, when it holds no record of the cell's spans, and on a
program that keeps no records."""

import pytest

from dabbench import run
from dabbench.common import LayerContext
from dabjax_torch.runtime import profiling
from dabjax_torch.runtime.profiling import SpanRecord

LIVE = ("pull_wait_ms.live", "tail_pull_wait_ms.live", "tail_host_ms.live",
        "gc_ms.live", "graph_captures")
BANK = ("gc_ms.bank32", "graph_captures")
MS = 1_000_000


def _ctx(blocks, periods=None):
    return LayerContext(trace=None, blocks=blocks,
                        periods=blocks if periods is None else periods,
                        signal_s=0.0, program_spans={}, counters={},
                        shapes={}, cfg={}, wl={})


class _Ring:
    """Records in the receiver's order of spans: a block of ``block_ms``
    (1 ms of source and stage_host, then pull, whose pull_wait takes
    ``wait_ms``, then consume_host to the block's end), one after the
    other, 10 ms apart."""

    def __init__(self):
        self.recs = []
        self.t = 0

    def add(self, name, start, end, block=None, owner=0, parent=-1,
            items=0.0):
        self.recs.append(SpanRecord(len(self.recs), parent, name, owner,
                                    block, start, end, items))
        return len(self.recs) - 1

    def block(self, b, block_ms=2.0, wait_ms=0.5):
        t = self.t
        self.add("source", t, t + MS // 4, b)
        self.add("stage_host", t + MS // 4, t + MS, b)
        pull = self.add("pull", t + MS, t + MS + int(wait_ms * MS) + 1, b)
        self.add("pull_wait", t + MS, t + MS + int(wait_ms * MS), b,
                 parent=pull)
        self.add("consume_host", t + MS + int(wait_ms * MS) + 1,
                 t + int(block_ms * MS), b)
        self.t += 10 * MS

    def period(self, p):
        t = self.t
        for name in ("bank_stage", "bank_pull", "bank_consume"):
            self.add(name, t, t + MS, p, owner="bank")
            t += MS
        self.t += 10 * MS


@pytest.fixture
def ring(monkeypatch):
    r = _Ring()
    lost = [0]
    monkeypatch.setattr(profiling, "records", lambda: list(r.recs))
    monkeypatch.setattr(profiling, "overflow", lambda: lost[0])
    r.lost = lost
    return r


def _read(name, ctx):
    return run.read_layer_metric(name).read(ctx)


def test_pull_wait_is_its_records_ms_a_block(ring):
    for b in range(4):
        ring.block(b, wait_ms=0.25 * (b + 1))
    assert run.read_layer_metric("pull_wait_ms.live").UNIT == "ms/block"
    assert _read("pull_wait_ms.live", _ctx(4)) == pytest.approx(0.625)
    assert _read("pull_wait_ms.live", _ctx(0)) is None


def test_tail_readers_take_the_blocks_at_or_above_the_p95(ring):
    """200 blocks of 2 ms (0.5 ms waiting) and 12 slow ones of 7 ms
    (3 ms waiting): the 12 are the tail."""
    for b in range(212):
        slow = b % 17 == 5 and b < 17 * 12
        ring.block(b, block_ms=7.0 if slow else 2.0,
                   wait_ms=3.0 if slow else 0.5)
    assert _read("tail_pull_wait_ms.live", _ctx(212)) == \
        pytest.approx(3.0, abs=1e-5)
    assert _read("tail_host_ms.live", _ctx(212)) == \
        pytest.approx(4.0, abs=1e-5)


def test_tail_readers_want_ten_tail_blocks(ring):
    """100 blocks of distinct times: 5 at or above the p95."""
    for b in range(100):
        ring.block(b, block_ms=2.0 + 0.01 * b)
    assert _read("tail_pull_wait_ms.live", _ctx(100)) is None
    assert _read("tail_host_ms.live", _ctx(100)) is None


def test_tail_blocks_leave_out_bank_and_unblocked_records(ring):
    for b in range(20):
        ring.block(b)
    ring.add("gc", 0, 50 * MS)                   # no block
    ring.period(0)                               # the bank's
    tail = run.read_layer_metric("tail_pull_wait_ms.live").tail_blocks(
        ring.recs)
    assert tail is None or all(t == pytest.approx(2.0) for t, _ in tail)


def test_gc_is_the_union_of_its_records_a_block_or_a_period(ring):
    for b in range(4):
        ring.block(b)
    ring.add("gc", 0, 2 * MS, items=0.0)
    ring.add("gc", MS, 3 * MS, items=1.0)        # overlaps the first
    ring.add("gc", 20 * MS, 21 * MS, items=2.0)
    assert _read("gc_ms.live", _ctx(4)) == pytest.approx(1.0)
    assert _read("gc_ms.bank32", _ctx(32, periods=2)) is None
    ring.period(0)
    assert _read("gc_ms.bank32", _ctx(32, periods=2)) == pytest.approx(2.0)


def test_gc_reads_zero_without_collections(ring):
    ring.block(0)
    assert _read("gc_ms.live", _ctx(1)) == 0.0


def test_graph_captures_count_the_capture_records(ring):
    ring.block(0)
    assert _read("graph_captures", _ctx(1)) == 0
    ring.add("capture", 0, MS)
    ring.add("capture", 2 * MS, 3 * MS)
    assert _read("graph_captures", _ctx(1)) == 2


@pytest.mark.parametrize("metric", sorted(set(LIVE + BANK)))
def test_reader_is_none_on_overflow_when_empty_and_without_records(
        metric, ring, monkeypatch):
    ctx = _ctx(212, periods=212)
    assert _read(metric, ctx) is None            # empty
    for b in range(212):
        ring.block(b, block_ms=7.0 if b % 17 == 5 else 2.0)
        ring.period(b)
    ring.add("capture", 0, MS)
    ring.add("gc", 0, MS)
    assert _read(metric, ctx) is not None
    ring.lost[0] = 1
    assert _read(metric, ctx) is None            # the ring overflowed
    ring.lost[0] = 0
    monkeypatch.delattr(profiling, "records")    # a program without records
    assert _read(metric, ctx) is None


def test_entries_name_the_readers_units():
    bench = run.load_benchmark()
    layer = {m["name"]: m for m in bench["per_layer"]}
    for metric, cells in [(m, ["mixed12_uep.live"]) for m in LIVE[:4]] + \
            [("gc_ms.bank32", ["mixed12_uep_band3.bank32"]),
             ("graph_captures", ["mixed12_uep.live",
                                 "mixed12_uep_band3.bank32"])]:
        entry = layer[metric]
        assert entry["workloads"] == cells
        assert entry["moves"] == "block_p95_ms"
        assert entry["unit"] == run.read_layer_metric(metric).UNIT
