"""The rows' upload beside the kernels (``dabjax_torch/runtime/upload.py``)
on the CPU.

Streams and events need a card, so these tests put a stand-in backend in
the upload's place: its streams and events write each call into one log
(waits, records, host syncs, copies, buffers made), its copies run at
once, and its events read as pending while the test says the device is
busy.  Through it they hold the order of the calls on each path, the
choice of the path and its counts, and the receiver's calls around them;
without it, that the CPU takes the host rows as they are.  The card's
own tests are in ``tests/test_torch_card.py``."""

import numpy as np
import pytest
import torch

from dabjax_torch.runtime import receiver as receiver_mod
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import Receiver
from dabjax_torch.runtime.upload import RowsUpload
from dabjax_torch.testing import LoopSource

CPU = torch.device("cpu")


class Event:
    def __init__(self, back, name):
        self.back, self.name, self.recorded = back, name, False

    def record(self, stream):
        self.recorded = True
        self.back.log.append(("record", self.name, stream.name))

    def query(self):
        return not (self.recorded and self.back.busy)

    def synchronize(self):
        self.back.log.append(("sync", self.name))


class Stream:
    def __init__(self, back, name):
        self.back, self.name = back, name

    def wait_event(self, event):
        self.back.log.append(("wait", self.name, event.name))


class StandIn:
    """An upload backend for the CPU (see the module docstring).  Events
    are named in the order the upload makes them; buffers ``dev0``,
    ``dev1``, ... in the order it makes them, host tensors ``host``."""

    def __init__(self):
        self.log = []
        self.busy = False
        self.copy = Stream(self, "copy")
        self.graphs = Stream(self, "graphs")
        self.made = []
        self._events = 0

    def current(self):
        return self.graphs

    def event(self):
        self._events += 1
        return Event(self, f"event{self._events - 1}")

    def empty(self, like):
        t = torch.empty_like(like)
        self.made.append(t)
        self.log.append(("empty", self.name(t), tuple(like.shape)))
        return t

    def name(self, t):
        for i, m in enumerate(self.made):
            if t is m:
                return f"dev{i}"
        return "host"

    def copy_on(self, stream, dst, src):
        dst.copy_(src)
        self.log.append(("copy", stream.name, self.name(dst), self.name(src)))


def _upload():
    back = StandIn()
    return RowsUpload(CPU, back), back


def _names(up):
    """The upload's events by role: what the log calls them."""
    return up.uploaded.name, up._read.name, up._stage_free.name


def _host(k, shape=(3, 5, 2)):
    return torch.full(shape, k, dtype=torch.uint8)


# ------------------------------------------------------------ the paths

def test_first_upload_is_direct_and_makes_no_stage():
    up, back = _upload()
    got = up(_host(7))
    h2d, read, _ = _names(up)
    assert back.log == [
        ("empty", "dev0", (3, 5, 2)),
        ("wait", "copy", read),                 # the last graph's reads
        ("copy", "copy", "dev0", "host"),
        ("record", h2d, "copy"),
        ("wait", "graphs", h2d),                # before the graph's call
    ]
    assert got is up.rows and torch.equal(got, _host(7))
    assert up.stage is None and up.counts == {"direct": 1}


def test_upload_while_the_graph_reads_the_rows_is_staged():
    """The graph's event still pending: the copy goes to the stage, after
    the copy stream's wait on the last copy out of it; the graphs'
    stream waits on the copy, then copies the stage into the rows and
    marks the stage free again."""
    up, back = _upload()
    up(_host(1))
    up.read()                                  # the block graph's call
    back.busy, back.log = True, []
    got = up(_host(2))
    h2d, read, free = _names(up)
    assert back.log == [
        ("empty", "dev1", (3, 5, 2)),
        ("wait", "copy", free),
        ("copy", "copy", "dev1", "host"),
        ("record", h2d, "copy"),
        ("wait", "graphs", h2d),
        ("copy", "graphs", "dev0", "dev1"),
        ("record", free, "graphs"),
    ]
    assert got is up.rows and torch.equal(got, _host(2))
    assert up.counts == {"direct": 1, "staged": 1}


def test_the_stage_is_made_once():
    up, back = _upload()
    up(_host(1))
    back.busy = True
    for k in range(2, 6):
        up.read()
        up(_host(k))
    assert [e for e in back.log if e[0] == "empty"] == [
        ("empty", "dev0", (3, 5, 2)), ("empty", "dev1", (3, 5, 2))]
    assert up.counts == {"direct": 1, "staged": 4}


@pytest.mark.parametrize("busy", [[False] * 4, [True] * 4,
                                  [True, False, True, True],
                                  [False, True, False, False]],
                         ids=["idle", "busy", "mixed", "once"])
def test_each_path_is_counted_and_reads_the_right_events(busy):
    """Blocks through the upload and the graph's call in turn, the device
    busy or not at each upload: a direct copy waits on the graph's event
    and writes the rows on the copy stream; a staged copy waits on the
    stage's and writes the stage; the graphs' stream waits on the copy
    before its own copy and before the graph (the ``read`` after it);
    every block's rows arrive."""
    up, back = _upload()
    for k, b in enumerate([False] + busy):
        back.busy, back.log = b, []
        got = up(_host(k))
        up.read()
        h2d, read, free = _names(up)
        copies = [e for e in back.log if e[0] in ("copy", "wait", "record")]
        if b:
            assert copies == [("wait", "copy", free),
                              ("copy", "copy", "dev1", "host"),
                              ("record", h2d, "copy"),
                              ("wait", "graphs", h2d),
                              ("copy", "graphs", "dev0", "dev1"),
                              ("record", free, "graphs"),
                              ("record", read, "graphs")]
        else:
            assert copies == [("wait", "copy", read),
                              ("copy", "copy", "dev0", "host"),
                              ("record", h2d, "copy"),
                              ("wait", "graphs", h2d),
                              ("record", read, "graphs")]
        assert torch.equal(got, _host(k))
    assert up.counts["staged"] == sum(busy)
    assert up.counts["direct"] == len(busy) + 1 - sum(busy)


def test_a_new_shape_makes_new_buffers():
    """Rows of another shape get buffers of their own (the old ones go to
    the allocator, which the backend told of the copy stream's use)."""
    up, back = _upload()
    up(_host(1))
    up.read()
    back.busy = True
    up(_host(2))
    up.read()
    up(_host(3, (4, 5, 2)))
    assert [e for e in back.log if e[0] == "empty"] == [
        ("empty", "dev0", (3, 5, 2)), ("empty", "dev1", (3, 5, 2)),
        ("empty", "dev2", (4, 5, 2)), ("empty", "dev3", (4, 5, 2))]
    assert up.rows.shape == up.stage.shape == (4, 5, 2)
    assert torch.equal(up.rows, _host(3, (4, 5, 2)))


def test_read_and_wait_before_any_upload_do_nothing():
    up, back = _upload()
    up.read()
    up.wait()
    assert back.log == [] and up.counts == {}


# ----------------------------------------------------------- the receiver

def _receiver():
    rng = np.random.default_rng(5)
    iq = (rng.standard_normal(1 << 16)
          + 1j * rng.standard_normal(1 << 16)).astype(np.complex64) * 0.3
    return Receiver(LoopSource(iq), ReceiverConfig(frames_per_block=2),
                    device=CPU)


def test_host_rows_wait_on_the_copy_before_restacking():
    """The pinned host buffer is restacked only after the host waited on
    the last upload's copy out of it."""
    rx = _receiver()
    back = StandIn()
    rx._rows_up = RowsUpload(CPU, back)
    need = 3000
    assert rx._ensure(rx._buf_base + 4 * need)
    base = np.array([0, need])
    first = rx._host_rows(base, need)
    assert back.log == []                      # nothing uploaded yet
    rx._rows_up(first)
    back.log = []
    again = rx._host_rows(base + 7, need)
    assert again is first
    assert back.log == [("sync", rx._rows_up.uploaded.name)]
    assert np.array_equal(again.numpy(), np.stack(
        [rx._buf[b: b + need] for b in base + 7]))


def test_block_marks_the_rows_read_after_the_graph(monkeypatch):
    """``Receiver._block`` issues the block graph, then records the event
    that the next upload asks whether the rows are still read."""
    rx = _receiver()
    back = StandIn()
    rx._rows_up = RowsUpload(CPU, back)
    rx._rows_up(_host(1))                      # events made
    back.log = []
    frames = receiver_mod.BlockFn.frames

    def logged(self, rows, coarse):
        back.log.append(("frames",))
        return frames(self, rows, coarse)

    monkeypatch.setattr(receiver_mod.BlockFn, "frames", logged)
    need = receiver_mod.demod.min_frame_samples(rx.p)
    rows = torch.zeros((2, need, 2), dtype=torch.uint8)
    rx._block(rows)
    assert back.log == [("frames",),
                        ("record", rx._rows_up._read.name, "graphs")]


def test_cpu_receiver_takes_host_rows_as_they_are():
    """On the CPU the rows are the block graph's input as given: no
    backend, no buffer, no count."""
    rx = _receiver()
    rows = torch.zeros((2, 10, 2), dtype=torch.uint8)
    got, coarse = rx._upload(rows)
    assert got is rows and coarse.shape == (2,)
    assert rx._rows_up.backend is None and rx._rows_up.rows is None
    assert rx.uploads == {} and rx.uploads is rx._rows_up.counts
