"""Kernels of the port against their plain versions on a CUDA card.

Marked ``cuda``: each skips inside the test when there is no card.  The
file imports neither jax nor ``dabjax``, so it runs on a machine without
them: ``python -m pytest --noconftest -m cuda tests/test_torch_card.py``
(``tests/conftest.py`` imports jax).
"""

import numpy as np
import pytest
import torch

from dabjax_torch.fec import conv, viterbi, viterbi_cuda as vc
from dabjax_torch.fec.viterbi import viterbi_decode_np
from dabjax_torch.tools import hbm_probe
from dabjax_torch.tools import vit_dotshapes as vd
from dabjax_torch.tools import vit_variants as vv
from dabjax_torch.tools import vit_variants2 as vv2
from dabjax_torch.tools import vpu_probe2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _soft(B, nbits, seed):
    """[B, 4*(nbits+6)] integer soft bits: codeword i coded with noise,
    near a tie, or pure noise as i % 3."""
    rng = np.random.default_rng(seed)
    coded = np.stack([conv.encode(b) for b in
                      rng.integers(0, 2, (B, nbits), np.uint8)])
    clean = (coded.astype(np.float32) * 2 - 1) * 100
    sigma = np.array([40.0, 80.0, 0.0])[np.arange(B) % 3, None]
    soft = np.clip(clean + np.round(rng.standard_normal(clean.shape)
                                    * sigma), -127, 127)
    noise = np.arange(B) % 3 == 2
    soft[noise] = rng.integers(-127, 128, (int(noise.sum()), soft.shape[1]))
    return soft.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [100, 101, 768, 2304, 9216])
@pytest.mark.parametrize("B", [1, 31, 33, 384, 4428])
def test_traceback_kernel_bit_exact_on_card(B, nbits):
    """K2 against its plain version on K1's decisions, and K1 + K2
    against the numpy decoder (up to 384 codewords: the numpy decoder
    takes minutes at 4428 x 9216)."""
    dev = _card()
    soft = _soft(B, nbits, seed=B * 10007 + nbits)
    s = torch.from_numpy(soft).to(dev)
    dec = vc.viterbi_forward_cuda(vc.step_soft(s, nbits))
    got = vc.viterbi_traceback_cuda(dec, nbits)
    want = viterbi.viterbi_traceback_torch(vc.unpack_decisions(dec), nbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if B <= 384:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      viterbi_decode_np(soft, nbits))


def _forward_input(kind, B, nbits):
    """int8 [B, nbits + 6, 4]: coded / near-tie / pure noise mixed, all
    of a codeword +127 or -127, or values in -1 .. 1 (ties everywhere)."""
    rng = np.random.default_rng(B * 7919 + nbits)
    T = nbits + 6
    if kind == "mixed":
        soft = _soft(B, nbits, seed=B * 7919 + nbits).reshape(B, T, 4)
    elif kind == "saturated":
        soft = np.broadcast_to(rng.choice([-127, 127], (B, 1, 1)), (B, T, 4))
    else:
        soft = rng.integers(-1, 2, (B, T, 4))
    return torch.from_numpy(soft.astype(np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "saturated", "ties"])
@pytest.mark.parametrize("nbits", [100, 101, 768, 2304, 9216])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 33, 384, 4428])
def test_forward_kernel_bit_exact_on_card(B, nbits, kind):
    """K1's decision words against the plain forward's (int32 metrics),
    packed into K1's layout, some codewords at a time."""
    dev = _card()
    s8 = _forward_input(kind, B, nbits).to(dev)
    dec = vc.viterbi_forward_cuda(s8)
    step = max(1, 10_000_000 // (nbits + 6))
    for i in range(0, B, step):
        want = viterbi.viterbi_forward_torch(s8[i: i + step])
        assert torch.equal(vc.unpack_decisions(dec[i: i + step]), want)
    if B <= 5:
        assert torch.equal(dec, vc.pack_decisions(
            viterbi.viterbi_forward_torch(s8)))
        assert torch.equal(dec, viterbi.viterbi_forward_lanes_torch(s8))


@pytest.mark.cuda
def test_forward_kernel_shuffles_on_card():
    """One exchange a step and two a tile: K1's SASS holds fewer than two
    shuffles a step, and its votes."""
    _card()
    sass = vc.forward_sass_counts()
    assert 0 < sass["SHFL"] < 2 * vc.TILE and sass["VOTE"] >= 2 * vc.TILE


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "saturated"])
@pytest.mark.parametrize("nbits", [100, 101, 768, 2304])
@pytest.mark.parametrize("B", [1, 5, 33, 384])
def test_word_kernels_bit_exact_on_card(B, nbits, kind):
    """K3's words and ``last`` against the plain version in each word
    format, K4's bits against the plain traceback on them, K3 + K4
    against the numpy decoder (up to 33 codewords), and against the
    kernels' lane models (up to 5)."""
    dev = _card()
    soft = _forward_input(kind, B, nbits).reshape(B, -1).float().numpy()
    s = torch.from_numpy(soft).to(dev)
    want = viterbi_decode_np(soft, nbits) if B <= 33 else None
    for fmt in vc.WORD_FORMATS:
        words, last = vc.viterbi_forward_words_cuda(
            vc.pair_soft(s, nbits, fmt), fmt)
        plain_w, plain_l = viterbi.viterbi_forward_words_torch(s, nbits, fmt)
        bits = vc.viterbi_traceback_words_cuda(words, last, nbits)
        torch.cuda.synchronize()
        assert torch.equal(words, plain_w) and torch.equal(last, plain_l)
        assert torch.equal(bits, viterbi.viterbi_traceback_words_torch(
            plain_w, plain_l, nbits))
        if want is not None:
            np.testing.assert_array_equal(bits.cpu().numpy(), want)
        if B <= 5:
            lw, ll = viterbi.viterbi_forward_words_lanes_torch(s, nbits, fmt)
            assert torch.equal(words, lw) and torch.equal(last, ll)
            assert torch.equal(bits, viterbi.viterbi_traceback_words_lanes_torch(
                words, last, nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [101, 768])
def test_word_kernels_beyond_int8_on_card(nbits):
    """Soft at +-300: "f32" words equal the plain version's (no clip) and
    its bits the numpy decoder's."""
    dev = _card()
    rng = np.random.default_rng(nbits)
    soft = rng.integers(-300, 301, (6, 4 * (nbits + 6))).astype(np.float32)
    s = torch.from_numpy(soft).to(dev)
    words, last = vc.viterbi_forward_words_cuda(vc.pair_soft(s, nbits, "f32"),
                                                "f32")
    plain_w, plain_l = viterbi.viterbi_forward_words_torch(s, nbits, "f32")
    bits = vc.viterbi_traceback_words_cuda(words, last, nbits)
    torch.cuda.synchronize()
    assert torch.equal(words, plain_w) and torch.equal(last, plain_l)
    np.testing.assert_array_equal(bits.cpu().numpy(),
                                  viterbi_decode_np(soft, nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["i8mxu", "i8", "f32"])
def test_word_forward_votes_on_card(fmt):
    """K3's core runs K1's step: its unrolled tile holds two votes a step
    and fewer than two shuffles a step, word 0 and set-up included."""
    _card()
    sass = vc.forward_words_sass_counts(fmt)
    assert 0 < sass["SHFL"] < 2 * vc.TILE and sass["VOTE"] >= 2 * vc.TILE


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1160, 16, 4480), (3, 5, 36), (1, 1, 4)])
def test_copy_kernel_bit_exact_on_card(shape):
    dev = _card()
    x = hbm_probe.input_block(shape, seed=3).to(dev)
    x += torch.rand_like(x)
    got, want = hbm_probe.scale_copy_cuda(x), hbm_probe.scale_copy_torch(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["seed", "out_of_range"])
@pytest.mark.parametrize("shape", [(1160, 16, 4480), (8, 1, 4), (24, 3, 36),
                                   (65528, 1, 4)])
def test_decision_plane_bit_exact_on_card(shape, kind):
    """The plane kernel against its plain version, on integer block
    starts and on starts outside int8 (saturated, NaN to 0), up to the
    grid's 65535 rows."""
    dev = _card()
    make = hbm_probe.input_block if kind == "seed" else hbm_probe.odd_block
    x = make(shape, seed=4).to(dev)
    got = hbm_probe.decision_plane_cuda(x)
    want = hbm_probe.decision_plane_torch(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32 * 4480, 4488])
def test_batched_bf16_kernel_on_card(n):
    """D4 exact on integer inputs, within 1e-5 of max |plain| on the TPU
    probe's normal inputs, at the probe's width and a tail width; its
    SASS holds wgmma (HGMMA), one a 64-row slab."""
    dev = _card()
    rng = np.random.default_rng(n)
    si = torch.from_numpy(rng.integers(-1, 2, (256, 16)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-3, 4, (16, n)).astype(np.float32))
    si, xi = (t.to(torch.bfloat16).to(dev) for t in (si, xi))
    assert torch.equal(vd.dot_batched_cuda(si, xi),
                       vd.dot_batched_torch(si, xi))
    s, x = (t.to(dev) for t in vd.batched_inputs(16, n, 1, "bfloat16"))
    got, want = vd.dot_batched_cuda(s, x), vd.dot_batched_torch(s, x)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert vd.sass_counts()["batched bf16 K=16"] >= 4


def _ints(shape, bound, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    v = rng.integers(-bound, bound + 1, size=shape).astype(np.float32)
    return torch.from_numpy(v).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 33])
@pytest.mark.parametrize("lb", [16, 512, 4480, 4496])
@pytest.mark.parametrize("k", vd.KS)
@pytest.mark.parametrize("mode", vd.MODES)
def test_step_kernel_matches_plain_on_card(mode, k, lb, steps):
    """D1 within 1e-5 of max |plain| on the TPU probe's normal inputs
    (repeat_add bit for bit) and exact on integer inputs, at both of its
    column widths (one column a warp up to LB 528, 9 above), a width
    that no 9-column warp tiles (4496) and from 0 steps."""
    dev = _card()
    s, x = (t.to(dev) for t in vd.probe_inputs(k, lb, steps, seed=lb + k))
    want = vd.dot_steps_torch(s, x, mode)
    got = vd.dot_steps_cuda(s, x, mode)
    torch.cuda.synchronize()
    if mode == "repeat_add" or steps == 0:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    si = _ints((256, k), 1, seed=k).to(dev)
    xi = _ints((steps, k, lb), 3, seed=lb + steps).to(dev)
    assert torch.equal(vd.dot_steps_cuda(si, xi, mode),
                       vd.dot_steps_torch(si, xi, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 33])
@pytest.mark.parametrize("lb", [16, 512, 4480, 4496])
def test_bf16_step_kernel_matches_plain_on_card(lb, steps):
    """D2 (wgmma, X through a TMA ring) within DOT_TOL of max |plain| on
    the TPU probe's normal inputs and exact on small integers cast to
    bf16: one block of 2 units (LB 16), blocks of 4 (512), of 4 and 5
    (4480; 4496, whose last 32-column box runs past LB), a partial ring
    stage (1 and 33 steps) and no step."""
    dev = _card()
    s, x = (t.to(dev) for t in vd.probe_inputs(16, lb, steps, "bfloat16",
                                                 seed=lb + steps))
    want = vd.dot_steps_torch(s, x)
    got = vd.dot_steps_cuda(s, x)
    torch.cuda.synchronize()
    if steps == 0:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= \
            vd.DOT_TOL * float(want.abs().max())
    si = _ints((256, 16), 1, seed=16, dtype=torch.bfloat16).to(dev)
    xi = _ints((steps, 16, lb), 3, seed=lb + steps,
               dtype=torch.bfloat16).to(dev)
    assert torch.equal(vd.dot_steps_cuda(si, xi), vd.dot_steps_torch(si, xi))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 8, 1000])
@pytest.mark.parametrize("cols", [16, 4480, 4496])
def test_dots_kernel_matches_plain_on_card(cols, n):
    """D5 bit for bit at its three shapes, at one column a warp (16
    columns), 9 (4480) and a last warp of fewer (4496), from 0 dots."""
    dev = _card()
    for _, x, w in vpu_probe2.dot_inputs(seed=cols, cols=cols):
        x, w = x.to(dev), w.to(dev)
        assert torch.equal(vpu_probe2.dots_cuda(x, w, n),
                           vpu_probe2.dots_torch(x, w, n))


#: (B, nbits) of the redesigned forward probes' checks: one codeword, a
#: block of four and either side of a warp multiple, and the main path's
#: MSC shape
PROBE_SHAPES = [(1, 100), (3, 101), (31, 768), (33, 2304), (4428, 2304)]


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [False, True], ids=["loop", "unrolled"])
@pytest.mark.parametrize("chunk", vv.CHUNKS)
@pytest.mark.parametrize("mode", vv.MODES)
@pytest.mark.parametrize("B,nbits", PROBE_SHAPES)
def test_plane_kernel_matches_plain_on_card(B, nbits, mode, chunk, unroll):
    """P4 (``forward_plane``) byte for byte against its plain version,
    ksplit on and off; ``full`` packs to K3 "i8"'s words."""
    dev = _card()
    soft = torch.from_numpy(_soft(B, nbits, seed=B * 31 + nbits)).to(dev)
    T2, _ = vv.pair_steps(nbits, chunk)
    for ksplit in (True, False):
        x = vv.plane_soft(soft, nbits, chunk, ksplit)
        got = vv.forward_plane_cuda(x, T2, mode, chunk, unroll)
        want = vv.forward_plane_torch(x, T2, mode, chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if mode == "full":
            k3, _ = viterbi.viterbi_forward_words_torch(soft, nbits, "i8")
            assert torch.equal(vv.pack_words(got), k3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", vv2.MODES)
@pytest.mark.parametrize("B,nbits", PROBE_SHAPES)
def test_stage_kernel_matches_plain_on_card(B, nbits, mode):
    """P1 (``forward_words_stage``) word for word against its plain
    version; ``full`` equals K3 "i8" below T2."""
    dev = _card()
    soft = torch.from_numpy(_soft(B, nbits, seed=B * 37 + nbits)).to(dev)
    x = vv2.padded_pair_soft(soft, nbits)
    got = vv2.forward_words_stage_cuda(x, mode)
    want = vv2.forward_words_stage_torch(x, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if mode == "full":
        k3, _ = viterbi.viterbi_forward_words_torch(soft, nbits, "i8")
        assert torch.equal(vv2.mask_padding(got, -(-(nbits + 6) // 2)), k3)


@pytest.fixture(scope="module")
def mesh_rows():
    """Mode I, 8 frames of the 4 x 96 kbit/s EEP-A ensemble of
    tests/test_parallel.py: (rows [8, need, 2] float32, geometries,
    modulator)."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.msc.subchannel import SubchGeometry
    from dabjax_torch.ofdm.demod import min_frame_samples
    from dabjax_torch.tx.fig import ServiceSpec
    from dabjax_torch.tx.modulator import Modulator

    _card()
    p = get_mode(1)
    services = [ServiceSpec(label=f"SVC{i}", sid=0x7000 + i, subch_id=i,
                            start_addr=i * 100, bitrate=96,
                            protection="EEP-A", prot_level=3, kind="DAB+")
                for i in range(4)]
    mod = Modulator(mode=1, services=services)
    iq = mod.iq(8, snr_db=None)
    u0, need = p.T_null + p.T_g, min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(8)])
    geoms = [SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                           s.bitrate, s.protection, s.prot_level)
             for s in services]
    return torch.from_numpy(rows.view(np.float32).reshape(8, need, 2)), \
        geoms, mod


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_sharded_step_on_card(grid, mesh_rows):
    """The sharded step on a mesh of cuda:0 positions equals the
    single-device pipeline on the logical frames, and the CPU mesh's
    bits everywhere (the zero-history warm-up included)."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.parallel.mesh import make_mesh
    from dabjax_torch.parallel.sharding import (make_sharded_inputs,
                                                sharded_ensemble_step)
    from dabjax_torch.runtime.pipeline import full_ensemble_pipeline

    dev = _card()
    rows, geoms, mod = mesh_rows
    p = get_mode(1)
    starts = np.array([g.start_addr for g in geoms])
    n = grid[0] * grid[1]
    bits = {}
    for where in (dev, torch.device("cpu")):
        mesh = make_mesh(n, grid, devices=[where] * n)
        step = sharded_ensemble_step(mesh, p, geoms[0])
        ratio, bits[where.type] = step(*make_sharded_inputs(mesh, rows,
                                                           starts))
        assert float(ratio) == 1.0
    ok, single = full_ensemble_pipeline(p, geoms, device=dev)(rows.to(dev))
    torch.cuda.synchronize()
    assert bits["cuda"].device == dev and bool(ok.all())
    assert torch.equal(bits["cuda"][:, 15:], single)
    assert torch.equal(bits["cuda"].cpu(), bits["cpu"])
    for i, g in enumerate(geoms):
        assert np.array_equal(single[i, 0].cpu().numpy(),
                              mod.payload_bits(g.subch_id, 0))


@pytest.mark.cuda
def test_mesh_home_accepts_bare_cuda():
    """``device="cuda"`` names the current card, which is the home of a
    mesh of ``cuda:0`` positions; another card, or the CPU, is not."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.io.sources import SyntheticSource
    from dabjax_torch.msc.subchannel import EnsembleDecoder
    from dabjax_torch.parallel.mesh import make_mesh
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import Receiver
    from dabjax_torch.tx.fig import ServiceSpec
    from dabjax_torch.tx.modulator import Modulator

    dev = _card()
    torch.cuda.set_device(dev)
    mesh = make_mesh(2, (1, 2), devices=[dev] * 2)
    assert make_mesh(2, (1, 2), devices=["cuda"] * 2).home == dev
    EnsembleDecoder([], get_mode(1), mesh, device="cuda")
    src = SyntheticSource(Modulator(mode=1, services=[ServiceSpec(
        label="SVC0", sid=0x7000, subch_id=0, start_addr=0, bitrate=96,
        protection="EEP-A", prot_level=3, kind="DAB+")]))
    cfg = ReceiverConfig(frames_per_block=8)
    Receiver(src, cfg, mesh=mesh, device="cuda").close()
    with pytest.raises(ValueError, match="home"):
        Receiver(src, cfg, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="home"):
        EnsembleDecoder([], get_mode(1), mesh,
                        device=torch.device("cuda", dev.index + 1))


@pytest.mark.cuda
def test_receiver_k1_launches_lie_in_their_spans_on_card(tmp_path):
    """Under ``device_trace``, every K1 launch of a locked receiver's
    blocks (its ``cuda_runtime`` event, joined to the kernel by the
    correlation id) lies inside a ``blockgraph`` or ``msc`` range: the
    FIC's decode or the MSC chain's.  So does every other kernel's
    launch, by ``cudaLaunchKernel`` or ``cuLaunchKernel`` (cuFFT's)."""
    import json
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.profiling import device_trace
    from dabjax_torch.runtime.receiver import Receiver
    from dabjax_torch.testing import (LoopSource, bench_services,
                                      golden_modulator)

    dev = _card()
    iq = golden_modulator(mode=1, services=bench_services("mixed")).frames(24)
    rx = Receiver(LoopSource(iq),
                  ReceiverConfig(frames_per_block=4, decode_audio=False,
                                 decode_data=True), device=dev)
    try:
        for _ in range(8):
            assert rx.step()
        assert rx.metrics.synced and len(rx._geometries()) == 3
        torch.cuda.synchronize()
        vc.reset_launches()
        with device_trace(str(tmp_path)) as prof:
            for _ in range(3):
                assert rx.step()
            torch.cuda.synchronize()
        launched = vc.FORWARD_LAUNCHES
    finally:
        rx.close()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") in ("blockgraph", "msc")]
    assert len(ranges) == 6
    def launches(cats):
        return {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in cats and "correlation" in e.get("args", {})}

    def inside(kernels, launch):
        for e in kernels:
            t = launch[e["args"]["correlation"]]
            assert any(a <= t <= b for a, b in ranges), e["name"]

    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "forward_acs" in e["name"]
          and "forward_acs_words" not in e["name"]]
    assert launched > 0 and len(k1) == launched
    inside(k1, launches(("cuda_runtime",)))
    inside(kernels, launches(("cuda_runtime", "cuda_driver")))
