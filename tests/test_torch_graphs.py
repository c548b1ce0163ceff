"""The CUDA graphs of a block (``dabjax_torch/graphs.py``) on the CPU.

A card is needed to capture, so these tests put a stand-in capture
backend in the graphs' place: its "capture" runs the work once and keeps
the outputs, and its replay runs the work again (``_build.LAUNCHES``
left as it was, since a replay runs no Python wrapper) and copies the results
into the kept outputs, so that a replay overwrites the last one's
outputs in place, as a graph does.  Through it they hold the keying,
the recapture, each object's ownership of its graph and the launch
counts; without it, that the CPU runs the eager code.  The card's own
tests are in ``tests/test_torch_card.py``."""

import numpy as np
import pytest
import torch

from dabjax_torch import _build, graphs
from dabjax_torch.constants import CIF_BITS, get_mode
from dabjax_torch.msc.deinterleave import HISTORY
from dabjax_torch.msc.subchannel import EnsembleDecoder, SubchGeometry
from dabjax_torch.ofdm import demod
from dabjax_torch.parallel.mesh import make_mesh
from dabjax_torch.parallel.multihost import MultiReceiver
from dabjax_torch.runtime import profiling
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import BlockFn, Receiver
from dabjax_torch.testing import LoopSource, golden_modulator
from dabjax_torch.tx.fig import ServiceSpec

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class StandIn:
    """A capture backend for the CPU (see the module docstring)."""

    def __init__(self):
        self.eagers = self.captures = self.replays = 0

    def eager(self, fn, device):
        self.eagers += 1
        return fn()

    def capture(self, fn, device):
        self.captures += 1
        out = fn()

        def replay():
            self.replays += 1
            counts = _build.LAUNCHES.copy()
            new = fn()
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(counts)
            for kept, t in zip(_tensors(out), _tensors(new)):
                kept.copy_(t)
        return replay, out


@pytest.fixture
def stand_in(monkeypatch):
    """Every ``BlockGraph`` captures through a stand-in of its own:
    ``{id(graph): StandIn}``."""
    backends = {}
    monkeypatch.setattr(graphs.BlockGraph, "backend", lambda self, device:
                        backends.setdefault(id(self), StandIn()))
    return backends


def _call(g, key, inputs, fn):
    """A call of ``g``'s protocol, as ``BlockFn`` and ``EnsembleDecoder``
    make it."""
    if g.step(key, inputs):
        return g.replay(fn, CPU)
    return g.eager(fn, CPU)


# ----------------------------------------------------------- BlockGraph

def test_graph_is_captured_at_a_keys_second_call_and_replayed(stand_in):
    g = graphs.BlockGraph()
    x, y = torch.arange(4.0), torch.arange(4.0)
    first = _call(g, "k", (x,), lambda: x * 2)
    back = stand_in[id(g)]
    assert (back.eagers, back.captures, g.captured) == (1, 0, False)
    out = _call(g, "k", (x,), lambda: x * 2)
    assert (back.captures, back.replays, g.captured) == (1, 0, True)
    assert out is not first and torch.equal(out, first)
    x += 1                                      # new data, same tensor
    again = _call(g, "k", (x,), lambda: x * 2)
    assert again is out                          # the graph's own buffer
    assert torch.equal(again, torch.arange(1.0, 5.0) * 2)
    assert (back.captures, back.replays) == (1, 1)
    # another input tensor: captured again on it
    moved = _call(g, "k", (y,), lambda: y * 3)
    assert (back.captures, back.replays) == (2, 1) and moved is not out
    assert torch.equal(moved, y * 3)
    # a new key: the graph is dropped, the first call eager again
    assert torch.equal(_call(g, "k2", (y,), lambda: y - 1), y - 1)
    assert (back.eagers, back.captures, g.captured) == (2, 2, False)
    _call(g, "k2", (y,), lambda: y - 1)
    assert (back.captures, g.captured) == (3, True)


def _captures():
    st = profiling.PROCESS.stages.get("capture")
    return st.calls if st is not None else 0


def test_captures_are_counted_and_recorded_replays_are_not(stand_in):
    """Each capture, through the stand-in backend, adds one to the
    process's count, always, and is one ``capture`` record while a
    profiler runs; eager calls and replays add neither."""
    from torch.profiler import ProfilerActivity, profile
    g = graphs.BlockGraph()
    x, y = torch.arange(4.0), torch.arange(4.0)
    before = _captures()
    _call(g, "k", (x,), lambda: x * 2)          # eager
    _call(g, "k", (x,), lambda: x * 2)          # captured, unrecorded
    assert _captures() == before + 1
    profiling.clear_records()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):                      # replays
            _call(g, "k", (x,), lambda: x * 2)
        _call(g, "k", (y,), lambda: y * 2)      # captured on y
        _call(g, "k", (y,), lambda: y * 2)
    back = stand_in[id(g)]
    assert (back.captures, back.replays) == (2, 4)
    assert _captures() == before + 2
    caps = [r for r in profiling.records() if r.name == "capture"]
    assert len(caps) == 1
    assert (caps[0].owner, caps[0].block, caps[0].parent) == (None, None, -1)


def test_graph_takes_cpu_tensors_only_through_a_stand_in():
    assert graphs.BlockGraph().backend(CPU) is None
    assert isinstance(graphs.BlockGraph().backend(torch.device("cuda", 0)),
                      graphs.CudaCapture)


@pytest.mark.parametrize("fails", [False, True], ids=["sound", "raises"])
def test_capture_holds_off_the_garbage_collector(fails, monkeypatch):
    """No collection runs inside a capture (one there may destroy another
    object's graph, which breaks the capture), and the collector is as
    it was after it, whether the captured work returns or raises."""
    import contextlib
    import gc

    class Fake:
        def __init__(self, *args):
            pass

        def wait_stream(self, *other):
            pass

        capture_begin = capture_end = replay = wait_stream

    for name in ("CUDAGraph", "Stream"):
        monkeypatch.setattr(torch.cuda, name, Fake)
    monkeypatch.setattr(torch.cuda, "current_stream", Fake)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    seen = []

    def work():
        seen.append(gc.isenabled())
        if fails:
            raise ValueError("work")
        return "out"

    for enabled in (True, False):
        (gc.enable if enabled else gc.disable)()
        try:
            with contextlib.suppress(ValueError):
                replay, out = graphs.CudaCapture().capture(work, CPU)
                assert out == "out"
            assert gc.isenabled() is enabled
        finally:
            gc.enable()
    assert seen == [False, False]


def test_replays_add_the_launches_their_capture_counted(stand_in):
    """Five calls of work that launches K1 twice and ``mix_windows``
    once: the registry reads five calls' launches, whether a call ran
    eagerly, captured or replayed."""
    launches = _build.LAUNCHES
    launches.clear()
    x = torch.zeros(2)

    def work():
        launches["k1"] += 2                   # as the wrappers count
        launches["mix_windows"] += 1
        return x + 1

    g = graphs.BlockGraph()
    try:
        for _ in range(5):
            _call(g, "k", (x,), work)
        assert stand_in[id(g)].replays == 3
        assert (launches["k1"], launches["mix_windows"]) == (10, 5)
        assert (launches["k2"], launches["guard_corr"]) == (0, 0)
    finally:
        launches.clear()


# ------------------------------------------------------ BlockFn, decoder

MODE2 = get_mode(2)


def _rows(seed, F=2, p=MODE2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        0, 256, (F, demod.min_frame_samples(p), 2), dtype=np.uint8))


def _geoms():
    return [SubchGeometry(1, 0, 24, 32, "EEP-A", 3),
            SubchGeometry(2, 24, 24, 32, "EEP-A", 3),
            SubchGeometry(3, 48, 35, 48, "UEP", 3)]


def _cifs(seed, T=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, (T, CIF_BITS))
                            .astype(np.float32))


def test_blockfn_on_the_cpu_is_the_eager_code():
    fn = BlockFn(MODE2, "u8", device=CPU)
    rows, coarse = _rows(1), torch.full((2,), 1000.0)
    for _ in range(2):                   # the same tensors twice
        shard = fn.frames(rows, coarse)
        cifs, blob = fn.assemble([shard], CPU)
        want = fn._frames(rows, coarse)
        assert shard.keys() == want.keys()
        assert all(torch.equal(shard[k], want[k]) for k in want)
        wc, wb = fn._assemble([want], CPU)
        assert torch.equal(cifs, wc) and torch.equal(blob, wb)
    assert fn._graph._key is None and fn._shard is None


def test_decoder_on_the_cpu_is_the_eager_code():
    dec = EnsembleDecoder(_geoms(), MODE2, device=CPU)
    hist = torch.zeros((HISTORY, CIF_BITS))
    for k in range(2):
        cifs, blob = _cifs(k), torch.arange(5, dtype=torch.uint8)
        merged, new_hist, meta = dec.fused(hist, cifs, blob)
        wm, wh, wmeta = dec._fused(hist, cifs, blob)
        assert torch.equal(merged, wm) and torch.equal(new_hist, wh)
        assert meta == wmeta
        hist = new_hist
    assert dec._graph._key is None and dec._hist is None


def test_blockfn_replays_equal_the_eager_blocks(stand_in):
    """Four blocks through one kept rows tensor and CFO: the first eager,
    the second captured, the rest replayed, each block's outputs equal to
    the eager code's on its rows; a replay's outputs are the graph's own
    buffers; other rows tensors capture again."""
    fn = BlockFn(MODE2, "u8", device=CPU)
    rows, coarse = torch.empty_like(_rows(0)), torch.empty(2)
    outs = []
    for k in range(4):
        rows.copy_(_rows(10 + k))
        coarse.fill_(1000.0 * k)
        shard = fn.frames(rows, coarse)
        cifs, blob = fn.assemble([shard], CPU)
        wc, wb = fn._assemble([fn._frames(rows, coarse)], CPU)
        assert torch.equal(cifs, wc) and torch.equal(blob, wb)
        outs.append((cifs, blob))
    back = stand_in[id(fn._graph)]
    assert (back.eagers, back.captures, back.replays) == (1, 1, 2)
    assert outs[3][0] is outs[2][0] is outs[1][0]
    assert outs[3][1] is outs[1][1]
    assert fn.assemble([fn._shard], CPU)[0] is outs[3][0]
    # a shard that is not the last one handed out is assembled eagerly
    eager = fn.assemble([dict(fn._shard)], CPU)[1]
    assert eager is not outs[3][1] and torch.equal(eager, outs[3][1])
    other = _rows(20)
    cifs, blob = fn(other, coarse)
    wc, wb = fn._assemble([fn._frames(other, coarse)], CPU)
    assert torch.equal(cifs, wc) and torch.equal(blob, wb)
    assert back.captures == 2


def test_decoder_replays_carry_the_history_in_its_own_buffer(stand_in):
    """Six blocks through kept CIF and blob tensors, the history handed
    back each time: merged bytes and history equal the eager chain's;
    from the capture on the history is the decoder's own buffer, passed
    back at no copy; a history from elsewhere is copied in."""
    dec = EnsembleDecoder(_geoms(), MODE2, device=CPU)
    cifs, blob = torch.empty(4, CIF_BITS), torch.empty(7, dtype=torch.uint8)
    hist = want_hist = torch.zeros((HISTORY, CIF_BITS))
    for k in range(6):
        cifs.copy_(_cifs(30 + k))
        blob.copy_(torch.arange(7, dtype=torch.uint8) + k)
        merged, hist, meta = dec.fused(hist, cifs, blob)
        want, want_hist, want_meta = dec._fused(want_hist, cifs, blob)
        assert torch.equal(merged, want) and meta == want_meta
        assert torch.equal(hist, want_hist)
        assert (hist is dec._hist) == (k >= 1)
    back = stand_in[id(dec._graph)]
    assert (back.eagers, back.captures, back.replays) == (1, 1, 4)
    elsewhere = want_hist.clone() + 1
    merged, hist, _ = dec.fused(elsewhere, cifs, blob)
    want, want_hist, _ = dec._fused(elsewhere, cifs, blob)
    assert torch.equal(merged, want) and torch.equal(hist, want_hist)
    assert back.captures == 1


def test_key_change_recaptures_and_blocks_stay_exact(stand_in):
    """Blocks of 2, then 3, then 2 frames: each new key runs eagerly,
    then captures; every block equals the eager code's."""
    fn = BlockFn(MODE2, "u8", device=CPU)
    inputs = {F: (_rows(40 + F, F), torch.zeros(F)) for F in (2, 3)}
    seen = []
    for F in (2, 2, 2, 3, 3, 3, 2, 2):
        rows, coarse = inputs[F]
        kept = fn._graph._key
        cifs, blob = fn(rows, coarse)
        wc, wb = fn._assemble([fn._frames(rows, coarse)], CPU)
        assert torch.equal(cifs, wc) and torch.equal(blob, wb)
        seen.append((kept != fn._graph._key, fn._graph.captured))
    assert seen == [(True, False), (False, True), (False, True),
                    (True, False), (False, True), (False, True),
                    (True, False), (False, True)]
    back = stand_in[id(fn._graph)]
    assert (back.eagers, back.captures) == (3, 3)


# ------------------------------------------------------------ receivers

SERVICES = [ServiceSpec(label="GRAPHPLUS", sid=0x7101, subch_id=1,
                        start_addr=0, bitrate=32, protection="EEP-A",
                        prot_level=3, kind="DAB+"),
            ServiceSpec(label="GRAPHMP2", sid=0x7102, subch_id=2,
                        start_addr=40, bitrate=32, protection="EEP-A",
                        prot_level=3, kind="DAB")]


class _Frames:
    def __init__(self, out, sid):
        self.out, self.sid = out, sid

    def add_logical_frame(self, bits):
        self.out.append((self.sid, np.packbits(bits).tobytes()))


@pytest.fixture(scope="module")
def iq():
    return golden_modulator(mode=1, services=SERVICES).frames(24)


def _receiver(iq, shift=0, mesh=None):
    frames = []
    rx = Receiver(LoopSource(np.roll(iq, shift)),
                  ReceiverConfig(frames_per_block=2, decode_audio=False,
                                 decode_data=True),
                  data_handler_factory=lambda db, sid: _Frames(frames, sid),
                  mesh=mesh, device=CPU)
    return rx, frames


def _blocks(rx, n):
    """The merged bytes of ``n`` blocks, each taken before it is
    consumed."""
    out = []
    for _ in range(n):
        blk = rx.stage()
        out.append(blk.merged.numpy().tobytes())
        rx.consume(blk)
    return out


BLOCKS = 9


@pytest.fixture(scope="module")
def eager_run(iq):
    rx, frames = _receiver(iq)
    try:
        return _blocks(rx, BLOCKS), frames
    finally:
        rx.close()


def test_receiver_replays_equal_its_eager_blocks(iq, eager_run, stand_in):
    """A receiver whose graphs replay gives the eager receiver's merged
    bytes block by block and its logical frames, through the lock, the
    FIC's subchannels arriving (a new decoder, captured anew) and the
    history carried."""
    rx, frames = _receiver(iq)
    try:
        got = _blocks(rx, BLOCKS)
        decoder = rx._decoder
    finally:
        rx.close()
    assert got == eager_run[0] and frames == eager_run[1]
    assert len({sid for sid, _ in frames}) == 2
    block = stand_in[id(rx._block_fn._graph)]
    assert block.captures == 1 and block.replays == BLOCKS - 2
    msc = stand_in[id(decoder._graph)]
    assert msc.captures == 1 and msc.replays >= 1
    assert rx._cif_hist is decoder._hist


def test_receiver_captures_are_recorded_in_the_spans_that_made_them(
        iq, stand_in):
    """A receiver traced from its first block: its two captures (the
    block graph's, the MSC chain's) are ``capture`` records of no block,
    each under the ``blockgraph`` or ``msc`` span that made it."""
    from torch.profiler import ProfilerActivity, profile
    rx, _ = _receiver(iq)
    profiling.clear_records()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _blocks(rx, BLOCKS)
    finally:
        rx.close()
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    caps = [r for r in recs if r.name == "capture"]
    assert sorted(by_id[r.parent].name for r in caps) == ["blockgraph",
                                                          "msc"]
    assert all(r.block is None for r in caps)
    assert all(by_id[r.parent].owner == rx._chan_tag for r in caps)


SHIFT = 7 * get_mode(1).T_F // 3        # channel b starts elsewhere


@pytest.fixture(scope="module")
def lone_b(iq):
    rx, frames = _receiver(iq, SHIFT)
    try:
        return _blocks(rx, BLOCKS), frames
    finally:
        rx.close()


def test_bank_channels_keep_their_own_bytes(iq, eager_run, lone_b,
                                            stand_in):
    """Two channels of equal shapes, staged one after the other before
    the one pull a period: each channel's blocks are its lone eager
    receiver's, so neither reads the other's graph buffers."""
    lone = {"a": eager_run, "b": lone_b}
    assert lone["a"][0] != lone["b"][0]
    frames = {"a": [], "b": []}
    bank = MultiReceiver({"a": LoopSource(iq),
                          "b": LoopSource(np.roll(iq, SHIFT))},
                         ReceiverConfig(frames_per_block=2,
                                        decode_audio=False,
                                        decode_data=True), device=CPU)
    for name, rx in bank.rx.items():
        rx.data_handler_factory = \
            lambda db, sid, out=frames[name]: _Frames(out, sid)
    pulled = []
    pull = bank._pull

    def _pull(blob):
        pulled.append(pull(blob))
        return pulled[-1]

    bank._pull = _pull
    try:
        for _ in range(BLOCKS):
            assert all(bank.step().values())
        graphed = [(stand_in[id(rx._block_fn._graph)].replays,
                    stand_in[id(rx._decoder._graph)].captures,
                    stand_in[id(rx._decoder._graph)].replays > 0)
                   for rx in bank.rx.values()]
    finally:
        bank.close()
    # each channel's graphs are its own: captured once, then replayed
    assert graphed == [(BLOCKS - 2, 1, True)] * 2
    for k, big in enumerate(pulled):
        a = len(lone["a"][0][k])
        assert big[:a].tobytes() == lone["a"][0][k]
        assert big[a:].tobytes() == lone["b"][0][k]
    assert frames == {name: lone[name][1] for name in lone}


def test_mesh_path_runs_the_eager_code(iq, eager_run, stand_in):
    """A receiver on a mesh (two positions on the CPU) takes no graph,
    and gives the single-device blocks."""
    mesh = make_mesh(2, (2, 1), devices=[CPU] * 2)
    rx, frames = _receiver(iq, mesh=mesh)
    try:
        got = _blocks(rx, BLOCKS)
        decoder = rx._decoder
    finally:
        rx.close()
    assert rx._block_fn._graph._key is None
    assert decoder._graph._key is None and not stand_in
    assert got == eager_run[0] and frames == eager_run[1]
