"""Kernels of the port against their plain versions on a CUDA card.

Marked ``cuda``: each skips inside the test when there is no card.  The
file imports neither jax nor ``dabjax``, so it runs on a machine without
them: ``python -m pytest --noconftest -m cuda tests/test_torch_card.py``
(``tests/conftest.py`` imports jax).
"""

import numpy as np
import pytest
import torch

from dabjax_torch import _build
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


def _launched(*keys):
    """The launches counted under ``keys`` since the registry's clear."""
    return tuple(_build.LAUNCHES[k] for k in keys)


DEMOD = ("guard_corr", "mix_windows", "dqpsk_soft")


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


def _decision_words(B, T, offset, seed, dev):
    """Random decision words int32 [B, T, 2] on the card, ``offset`` bytes
    (0 or 8) past a 16-byte boundary: K2 copies 16 bytes at a time from
    16-byte aligned rows (T even), else 8."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (B * T * 2 + 2,), generator=g,
                         dtype=torch.int32, device=dev)
    dec = flat[offset // 4: offset // 4 + B * T * 2].view(B, T, 2)
    assert dec.data_ptr() % 16 == offset
    return dec


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [768, 1344, 1536, 1920, 2304, 3072, 4608,
                                   9216])
@pytest.mark.parametrize("B", [1, 31, 33, 384, 4428, 17280])
def test_traceback_packed_kernel_equals_the_chain_on_card(B, nbits):
    """K2's packed epilogue against K2's bits dispersed and packed by the
    torch chain, byte for byte, through both copy paths (decisions 16-byte
    aligned, and 8 bytes past); one launch a call."""
    from dabjax_torch.fec import prbs
    from dabjax_torch.msc.subchannel import pack_bits_u8
    dev = _card()
    for offset in (0, 8):
        dec = _decision_words(B, nbits + 6, offset, B * 10007 + nbits, dev)
        _build.LAUNCHES.clear()
        got = vc.viterbi_traceback_packed_cuda(dec, nbits)
        assert _launched("k2_packed", "k2") == (1, 0)
        want = pack_bits_u8(prbs.disperse(vc.viterbi_traceback_cuda(dec,
                                                                    nbits)))
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and got.shape == (B, nbits // 8)
        assert torch.equal(got, want), offset


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [8, 104, 200, 776])
@pytest.mark.parametrize("B", [1, 33])
def test_traceback_packed_kernel_byte_stores_on_card(B, nbits):
    """Where ``nbits`` is not a multiple of 32 the kernel stores the last
    tile's bytes one at a time (and every byte where the rows are not
    4-byte aligned): it equals the lane model of K2's walk and epilogue
    and the chain; ``nbits`` not a multiple of 8 is refused."""
    from dabjax_torch.fec import prbs
    from dabjax_torch.msc.subchannel import pack_bits_u8
    dev = _card()
    for offset in (0, 8):
        dec = _decision_words(B, nbits + 6, offset, nbits + offset, dev)
        got = vc.viterbi_traceback_packed_cuda(dec, nbits)
        assert torch.equal(got, pack_bits_u8(prbs.disperse(
            vc.viterbi_traceback_cuda(dec, nbits))))
        assert torch.equal(got.cpu(),
                           viterbi.viterbi_traceback_packed_lanes_torch(
                               dec.cpu(), nbits))
    _build.LAUNCHES.clear()
    with pytest.raises(ValueError, match="multiple of 8"):
        vc.viterbi_traceback_packed_cuda(dec, nbits - 1)
    with pytest.raises(ValueError):
        vc.viterbi_traceback_packed_cuda(dec[:, :, :1].contiguous(), nbits)
    assert _launched("k2_packed") == (0,)


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
        _build.LAUNCHES.clear()
        with device_trace(str(tmp_path)) as prof:
            for _ in range(3):
                assert rx.step()
            torch.cuda.synchronize()
        launched = _build.LAUNCHES["k1"]
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


def _demod_rows(p, F, kind, seed, zero=False):
    """Frame rows of ``kind`` [F, need + 8 (, 2)] on the card: uniform
    bytes, or standard-normal floats scaled to the u8 range; all-zero
    signal (bytes 128) where ``zero``."""
    from dabjax_torch.ofdm.demod import min_frame_samples
    dev = _card()
    rng = np.random.default_rng(seed)
    shape = (F, min_frame_samples(p) + 8, 2)
    if kind == "u8":
        a = (np.full(shape, 128, np.uint8) if zero
             else rng.integers(0, 256, shape, dtype=np.uint8))
        return torch.from_numpy(a).to(dev)
    a = (np.zeros(shape, np.float32) if zero
         else (rng.standard_normal(shape) * 0.3).astype(np.float32))
    t = torch.from_numpy(a).to(dev)
    return torch.view_as_complex(t) if kind == "c64" else t


def _bits(t):
    """A float or complex tensor's bits, to compare bit for bit."""
    return torch.view_as_real(t).view(torch.int32) if t.is_complex() \
        else t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("cfo", ["zero", "nonzero"])
@pytest.mark.parametrize("kind", ["u8", "f32", "c64"])
@pytest.mark.parametrize("F", [1, 4, 360])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_demod_kernels_bit_exact_on_card(mode, F, kind, cfo):
    """guard_corr + mix_windows + FFT + dqpsk_soft against the plain
    chain given the same CFO: the FIC soft bits, the CIF block and the
    PRS spectrum of ``demodulate_rows``, and the [F, L-1, 2K] soft bits
    and spectrum of ``demodulate_frames_cfo``, bit for bit; the total
    CFO is the fine CFO plus the coarse, as one float32 add."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.msc.cif import cifs_from_soft
    from dabjax_torch.ofdm import demod

    p = get_mode(mode)
    rows = _demod_rows(p, F, kind, seed=mode * 1000 + F)
    coarse = torch.full((F,), 0.0 if cfo == "zero" else
                        -3.0 * p.carrier_diff, device=rows.device)
    d = demod.demodulate_rows(rows, coarse, p, kind)
    x = demod.complex_rows(rows, kind)
    soft, spec0 = demod.demodulate_frames_cfo_torch(x, d.cfo, p)
    torch.cuda.synchronize()
    assert torch.equal(_bits(d.cfo), _bits(d.fine + coarse))
    assert torch.equal(_bits(d.fic), _bits(soft[:, : p.fic_symbols]))
    assert torch.equal(_bits(d.cifs), _bits(cifs_from_soft(soft, p)))
    assert torch.equal(_bits(d.spec0), _bits(spec0))
    assert bool(torch.isfinite(d.cifs).all()) and bool(d.cifs.abs().max()
                                                        <= 127)

    ramp = (torch.zeros(F, device=rows.device) if cfo == "zero"
            else d.cfo + 170.25)
    got = demod.demodulate_frames_cfo(x, ramp, p)
    want = demod.demodulate_frames_cfo_torch(x, ramp, p)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "f32", "c64"])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_guard_corr_repeats_and_is_accurate_on_card(mode, kind):
    """guard_corr's fine CFO (360 frames) is the same in every run (a
    fixed order of sums, no atomics), and no further from a float64
    computation than the plain float32 sum's, but by ``tol``: both paths
    end in float32 (an atan2f and the Hz scaling, rounded in other
    orders), which is a few ulp of the Hz value, while the plain sum's
    error is the larger part (37800 terms in float32 in mode I)."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.ofdm import demod, demod_cuda

    p = get_mode(mode)
    rows = _demod_rows(p, 360, kind, seed=mode)
    runs = [demod_cuda.guard_corr(rows, p, kind)[0] for _ in range(3)]
    x = demod.complex_rows(rows, kind)
    plain = demod.fine_cfo_estimate_torch(x, p).cpu().numpy()
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(_bits(r), _bits(runs[0]))
    xs = x.cpu().numpy().astype(np.complex128)
    g = np.stack([xs[:, l * p.T_s - p.T_g: l * p.T_s]
                  for l in range(1, p.L)], axis=1)
    ref = np.stack([xs[:, l * p.T_s - p.T_g + p.T_u: l * p.T_s + p.T_u]
                    for l in range(1, p.L)], axis=1)
    corr = np.sum(g * np.conj(ref), axis=(1, 2))
    want = -np.angle(corr) / np.pi * (p.carrier_diff / 2.0)
    got = runs[0].cpu().numpy().astype(np.float64)
    tol = 4 * float(np.spacing(np.float32(np.max(np.abs(want)))))
    assert np.max(np.abs(got - want)) <= np.max(np.abs(plain - want)) + tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "f32", "c64"])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_demod_kernels_zero_rows_on_card(mode, kind):
    """All-zero signal: soft bits 0 and no NaN (the subnormal 1e-38 is
    not flushed), as the plain chain gives them."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.ofdm import demod

    p = get_mode(mode)
    rows = _demod_rows(p, 4, kind, seed=0, zero=True)
    coarse = torch.zeros(4, device=rows.device)
    d = demod.demodulate_rows(rows, coarse, p, kind)
    want = demod.demodulate_rows_torch(rows, coarse, p, kind)
    torch.cuda.synchronize()
    for t in (d.fic, d.cifs, d.spec0):
        assert not bool(t.isnan().any()) and not bool(t.any())
    assert torch.equal(d.cifs, want.cifs) and torch.equal(d.fic, want.fic)


@pytest.mark.cuda
def test_demod_counters_show_the_kernels_on_card():
    """The block graph and the pipeline's demod go through the three
    kernels: one launch of each a call."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.runtime.pipeline import frame_pipeline
    from dabjax_torch.runtime.receiver import BlockFn

    p = get_mode(1)
    for kind in ("u8", "f32"):
        rows = _demod_rows(p, 4, kind, seed=7)
        _build.LAUNCHES.clear()
        BlockFn(p, kind, device=rows.device).frames(
            rows, torch.zeros(4, device=rows.device))
        assert _launched(*DEMOD) == (1, 1, 1)
    _build.LAUNCHES.clear()
    frame_pipeline(p, device=rows.device)(rows)
    assert _launched(*DEMOD) == (1, 1, 1)


@pytest.mark.cuda
def test_demod_kernels_refuse_bad_input_on_card():
    """A CUDA input of a wrong dtype, shape or layout raises, before any
    launch; so do a CPU tensor and a CFO of the wrong kind."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.ofdm import demod, demod_cuda

    p = get_mode(1)
    rows = _demod_rows(p, 4, "f32", seed=3)
    zero = torch.zeros(4, device=rows.device)
    bad_rows = {
        "dtype": rows.double(),
        "short": rows[:, : demod.min_frame_samples(p) - 1],
        "pairs": torch.cat([rows, rows[..., :1]], dim=-1),
        "layout": rows.transpose(1, 2).contiguous().transpose(1, 2),
        "u8 as f32": rows.to(torch.uint8),
    }
    _build.LAUNCHES.clear()
    for name, bad in bad_rows.items():
        with pytest.raises(ValueError):
            demod.demodulate_rows(bad, zero, p, "f32")
        with pytest.raises(ValueError):
            demod_cuda.guard_corr(bad, p, "f32")
    with pytest.raises(ValueError):
        demod_cuda.guard_corr(rows.cpu(), p, "f32")
    for cfo in (zero.double(), zero[:3], zero.cpu()):
        with pytest.raises(ValueError):
            demod_cuda.guard_corr(rows, p, "f32", cfo)
        with pytest.raises(ValueError):
            demod_cuda.mix_windows(rows, cfo, p, "f32", demod.FS)
    with pytest.raises(ValueError):
        demod_cuda.mix_windows(rows[:, :, :1].squeeze(-1), zero, p, "c64",
                               demod.FS)
    spec = torch.zeros((4, p.L, p.T_u), dtype=torch.complex64,
                       device=rows.device)
    n, fic = 2 * p.K, p.fic_symbols
    outs = torch.empty((4, p.L - 1, n), device=rows.device)
    good = (outs[:, :fic], outs[:, fic:])
    for bad_spec, bad_fic, bad_msc in (
            (spec[:, :, :-1], *good), (spec.to(torch.complex128), *good),
            (spec, good[0].double(), good[1]),
            (spec, good[0], outs[:, fic - 1:]),
            (spec, good[0], torch.empty((4, n, p.L - 1 - fic),
                                        device=rows.device).transpose(1, 2))):
        with pytest.raises(ValueError):
            demod_cuda.dqpsk_soft(bad_spec, zero, p, demod.FS, bad_fic,
                                  bad_msc)
    assert _launched(*DEMOD) == (0, 0, 0)


# ------------------------------------------------------------ coarse CFO

def _coarse_scores(spec0, p, search=35):
    """float32 [F, 2 search + 1]: the plain chain's scores
    (``coarse_cfo_estimate_torch`` up to its argmax)."""
    from dabjax_torch.ofdm import demod
    ref = demod._coarse_ref(p.mode, p.T_u, p.K, spec0.device)
    idx = demod._coarse_index(p.T_u, p.K, search, spec0.device)
    s = torch.roll(spec0, p.T_u // 2, dims=-1)
    d = s[..., :-1] * torch.conj(s[..., 1:])
    return torch.abs(torch.sum(d[..., idx] * torch.conj(ref), dim=-1))


def _coarse_pair(spec0, p):
    """(kernel, plain chain) offsets of ``spec0``, synchronised."""
    from dabjax_torch.ofdm import demod
    got = demod.coarse_cfo_estimate(spec0, p)
    want = demod.coarse_cfo_estimate_torch(spec0, p)
    torch.cuda.synchronize()
    return got.cpu(), want.cpu()


def _shifted_refs(p, offsets, sigma, seed, dev):
    """complex64 [len(offsets), T_u] on the card: the PRS reference moved
    ``offsets`` carriers up, plus complex noise of std ``sigma``."""
    from dabjax_torch.ofdm import tables
    rng = np.random.default_rng(seed)
    ref = tables.phase_ref_bins(p.mode, p.T_u, p.K)
    n = len(offsets)
    x = np.stack([np.roll(ref, o) for o in offsets]) + sigma * (
        rng.standard_normal((n, p.T_u)) + 1j * rng.standard_normal(
            (n, p.T_u)))
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dabplus12_eep3a", "dabplus12_eep3a_lband"])
def test_coarse_cfo_kernel_on_golden_spectra_on_card(name):
    """The PRS spectra of a benchmark loop's frames (Mode I, Mode II; no
    CFO in the signal), each also rolled by every offset in -35..35:
    the kernel gives the chain's offsets frame by frame, and they are the
    offsets; one launch a call, counted."""
    from dabjax_torch.ofdm import demod
    dev = _card()
    _, _, p, _, frames = _bench_loop(name)
    rows = frames.to(dev)
    spec0 = demod.demodulate_rows(rows, torch.zeros(rows.shape[0],
                                                    device=dev), p,
                                  "u8").spec0
    offs = np.arange(-35, 36)
    rolled = torch.stack([torch.roll(spec0[i % spec0.shape[0]], int(o))
                          for i, o in enumerate(offs)])
    _build.LAUNCHES.clear()
    got, want = _coarse_pair(spec0, p)
    assert _build.LAUNCHES["coarse_cfo"] == 1
    assert torch.equal(got, want) and not got.any()
    got, want = _coarse_pair(rolled, p)
    assert torch.equal(got, want)
    assert got.tolist() == offs.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_coarse_cfo_kernel_on_every_offset_on_card(mode):
    """The PRS reference moved by every offset in -35..35 under noise
    (Mode III's band runs past the spectrum's edges there: clamped reads)
    and F up to 1,440 frames: the kernel gives the chain's offsets, and
    outside Mode III the offsets themselves."""
    dev = _card()
    from dabjax_torch.constants import get_mode
    p = get_mode(mode)
    offs = np.tile(np.arange(-35, 36), 21)[:1440]
    for F in (1, 4, 71, 1440):
        spec = _shifted_refs(p, offs[:F], 0.5, seed=mode * 10 + F, dev=dev)
        got, want = _coarse_pair(spec, p)
        assert torch.equal(got, want), F
        if mode != 3:
            assert got.tolist() == offs[:F].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_coarse_cfo_kernel_on_random_spectra_on_card(mode):
    """Complex noise spectra (no PRS, so the scores lie close together):
    the kernel gives the chain's offset on every frame whose best two
    chain scores differ by more than 1e-5 of the best; those are nearly
    all frames."""
    from dabjax_torch.constants import get_mode
    dev = _card()
    p = get_mode(mode)
    g = torch.Generator(device=dev).manual_seed(mode)
    spec = torch.randn((1024, p.T_u), dtype=torch.complex64, device=dev,
                       generator=g)
    got, want = _coarse_pair(spec, p)
    top2 = torch.topk(_coarse_scores(spec, p), 2, dim=-1).values.cpu()
    apart = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2[:, 0]
    assert int(apart.sum()) >= 1000
    assert torch.equal(got[apart], want[apart])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_coarse_cfo_kernel_exact_ties_on_card(mode):
    """Exact ties go to the first shift, as torch.argmax gives them: zero
    and constant spectra score every shift alike (-35); a spectrum that
    repeats every 8 bins repeats its candidates every 8 shifts, so its
    best offset lies in -35..-28 (outside Mode III, whose clamped edge
    breaks the period)."""
    from dabjax_torch.constants import get_mode
    dev = _card()
    p = get_mode(mode)
    flat = torch.stack([torch.zeros(p.T_u, dtype=torch.complex64),
                        torch.ones(p.T_u, dtype=torch.complex64),
                        torch.full((p.T_u,), 0.5 - 2j,
                                   dtype=torch.complex64)]).to(dev)
    got, want = _coarse_pair(flat, p)
    assert got.tolist() == want.tolist() == [-35] * 3
    if mode == 3:
        return
    rng = np.random.default_rng(mode)
    g = rng.standard_normal((16, 8)) + 1j * rng.standard_normal((16, 8))
    spec = torch.from_numpy(np.tile(g, p.T_u // 8).astype(np.complex64))
    got, want = _coarse_pair(spec.to(dev), p)
    assert torch.equal(got, want)
    assert bool(((got >= -35) & (got <= -28)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_coarse_cfo_kernel_nan_on_card(mode):
    """A NaN bin in the band makes NaN the scores of the shifts that read
    its products, and the first of those wins, as in torch.argmax; at the
    band's low edge, in its middle, past its upper edge and outside it,
    the kernel gives the chain's offsets."""
    from dabjax_torch.constants import get_mode
    dev = _card()
    p = get_mode(mode)
    lo = p.T_u // 2 - p.K // 2
    rolled = sorted({max(lo - 35, 0), lo, lo + p.K // 2,
                     min(lo - 35 + p.K + 40, p.T_u - 1), p.T_u - 1, 0})
    spec = _shifted_refs(p, [7] * len(rolled), 0.3, seed=mode, dev=dev)
    for i, m in enumerate(rolled):
        spec[i, (m + p.T_u // 2) % p.T_u] = float("nan")
    got, want = _coarse_pair(spec, p)
    assert torch.equal(got, want)
    assert got[rolled.index(lo + p.K // 2)] == -35


def _coarse_replay_trace():
    """A ``BlockFn`` captured at 12 Mode I frames, then three replays
    under the profiler: ``LAUNCHES["coarse_cfo"]`` over the replays, the
    replays' kernel names, the names of the plain chain's gathers (its
    own trace at the same spectrum) and the last replay's coarse tap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from dabjax_torch.ofdm import demod
    from dabjax_torch.runtime.receiver import BlockFn
    dev = _card()
    _, _, p, _, frames = _bench_loop("dabplus12_eep3a")
    rows, coarse = frames[:12].to(dev), torch.zeros(12, device=dev)
    fn = BlockFn(p, "u8", device=dev)
    fn.frames(rows, coarse)
    fn.frames(rows, coarse)
    assert fn._graph.captured
    spec0 = demod.demodulate_rows(rows, coarse, p, "u8").spec0
    torch.cuda.synchronize()

    def kernels(prof):
        return [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    with profile(activities=[ProfilerActivity.CUDA]) as chain:
        demod.coarse_cfo_estimate_torch(spec0, p)
        torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as replays:
        for _ in range(3):
            shard = fn.frames(rows, coarse)
        torch.cuda.synchronize()
    return {"launches": _build.LAUNCHES["coarse_cfo"],
            "names": kernels(replays),
            "gathers": [n for n in kernels(chain) if "index" in n],
            "coarse": shard["coarse"].tolist()}


@pytest.mark.cuda
def test_block_graph_replays_coarse_cfo_on_card():
    """A captured ``BlockFn`` replays the coarse-CFO kernel: three replays
    count three launches in ``LAUNCHES["coarse_cfo"]`` and show three in
    the device trace, and none of the plain chain's gather kernels runs
    there (the chain's own trace names them).  Traced in a fresh process:
    after the rest of this file had run in one process, the chain's trace
    there held no gather kernel."""
    import json
    import pathlib
    import subprocess
    import sys
    _card()
    here = pathlib.Path(__file__).resolve()
    code = (f"import json, sys; sys.path[:0] = [{str(here.parent)!r}, "
            f"{str(here.parents[1])!r}]; import test_torch_card as t; "
            f"print(json.dumps(t._coarse_replay_trace()))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["gathers"]
    assert got["launches"] == 3
    assert sum("coarse_cfo" in n for n in got["names"]) == 3
    assert not set(got["gathers"]) & set(got["names"])
    assert got["coarse"] == [0] * 12


# ------------------------------------------------------------ CUDA graphs

def _bench_loop(name, seed=2024):
    """A benchmark configuration's geometries and its loop's frame rows
    (u8, one period of its mode)."""
    import json
    import pathlib
    from dabbench.common import geometries
    from dabbench.gen.loop import make_loop
    path = pathlib.Path(__file__).resolve().parents[1] / "dabbench" \
        / "configs" / f"{name}.json"
    with open(path) as f:
        cfg = json.load(f)
    loop = make_loop(cfg, seed)
    return cfg, loop, loop.p, geometries(cfg), _loop_rows(loop)


def _loop_rows(loop):
    """A loop's frame rows (u8), one period of its mode, each cut from
    its PRS on."""
    from dabbench.gen.loop import period
    from dabjax_torch.ofdm.demod import min_frame_samples
    p = loop.p
    base = np.arange(period(p).frames) * p.T_F + p.T_null + p.T_g
    idx = base[:, None] + np.arange(min_frame_samples(p))[None, :]
    return torch.as_tensor(loop.u8[idx])


def _eager(monkeypatch):
    """From here on every ``BlockGraph`` runs the eager code."""
    from dabjax_torch import graphs
    monkeypatch.setattr(graphs.BlockGraph, "backend",
                        lambda self, device: None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dabplus12_eep3a", "mixed12_uep"])
def test_graph_blocks_equal_eager_blocks_on_card(name):
    """22 blocks of 12 frames (a new stretch of the loop each) through the
    block graph and the MSC chain as the benchmark's core cell calls
    them, the history carried: each block's merged bytes and history
    equal those of the same objects' eager code, from the first block
    (eager), the second (captured) and every replay, and the eager code's
    equal the torch chain's (``_fused_chain``: K2's bits dispersed and
    packed by torch ops, where the card's chain has K2 store the bytes);
    the launch counters read the eager code's counts a block, the
    front-end kernel's and K2's packed epilogue's one launch a bucket."""
    from dabjax_torch.constants import CIF_BITS
    from dabjax_torch.msc.deinterleave import HISTORY
    from dabjax_torch.msc.subchannel import EnsembleDecoder
    from dabjax_torch.runtime.receiver import BlockFn
    dev = _card()
    _, _, p, geoms, frames = _bench_loop(name)
    F, n = 12, 22
    fn, dec = BlockFn(p, "u8", device=dev), EnsembleDecoder(geoms, p,
                                                          device=dev)
    ref_fn, ref_dec = BlockFn(p, "u8", device=dev), \
        EnsembleDecoder(geoms, p, device=dev)
    rows = torch.empty((F,) + frames.shape[1:], dtype=torch.uint8,
                       device=dev)
    coarse = torch.zeros(F, device=dev)
    hist = want_hist = torch.zeros((HISTORY, CIF_BITS), device=dev)
    counts = []
    for k in range(n):
        rows.copy_(frames[(k * F + np.arange(F)) % frames.shape[0]])
        ref_cifs, ref_blob = ref_fn._assemble(
            [ref_fn._frames(rows, coarse)], dev)
        chain, chain_hist = ref_dec._fused_chain(want_hist, ref_cifs)
        want, want_hist, want_meta = ref_dec._fused(want_hist, ref_cifs,
                                                    ref_blob)
        assert torch.equal(want, torch.cat(
            [ref_blob] + [c.reshape(-1) for c in chain])), f"block {k}"
        assert torch.equal(want_hist, chain_hist)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        cifs, blob = fn.assemble([fn.frames(rows, coarse)], dev)
        merged, hist, meta = dec.fused(hist, cifs, blob)
        counts.append(_launched("k1", "k2", *DEMOD, "msc_front",
                                "k2_packed"))
        assert torch.equal(merged, want), f"block {k}"
        assert torch.equal(hist, want_hist) and meta == want_meta
    assert fn._graph.captured and dec._graph.captured
    assert hist is dec._hist
    assert counts[0][0] > 0 and counts[0][2:] == (1, 1, 1,
                                                  len(dec._buckets),
                                                  len(dec._buckets))
    # K1 a bucket and the FIC's; K2's bits for the FIC alone
    assert counts[0][0] == counts[0][1] + len(dec._buckets)
    assert all(c == counts[0] for c in counts)


@pytest.mark.cuda
def test_graph_key_change_recaptures_on_card():
    """Blocks of 8, then 12, then 8 frames (the block graph's and the MSC
    chain's keys both change): each key's first block is eager, its
    second captured; every block equals the eager code's."""
    from dabjax_torch.constants import CIF_BITS
    from dabjax_torch.msc.deinterleave import HISTORY
    from dabjax_torch.msc.subchannel import EnsembleDecoder
    from dabjax_torch.runtime.receiver import BlockFn
    dev = _card()
    _, _, p, geoms, frames = _bench_loop("mixed12_uep")
    fn, dec = BlockFn(p, "u8", device=dev), EnsembleDecoder(geoms, p,
                                                          device=dev)
    inputs = {F: (frames[:F].to(dev), torch.zeros(F, device=dev))
              for F in (8, 12)}
    hist = want_hist = torch.zeros((HISTORY, CIF_BITS), device=dev)
    seen = []
    for k, F in enumerate((8, 8, 8, 12, 12, 12, 8, 8)):
        rows, coarse = inputs[F]
        rows.copy_(frames[(k * 5 + np.arange(F)) % frames.shape[0]])
        want, want_hist, _ = dec._fused(
            want_hist, *fn._assemble([fn._frames(rows, coarse)], dev))
        merged, hist, _ = dec.fused(
            hist, *fn.assemble([fn.frames(rows, coarse)], dev))
        assert torch.equal(merged, want) and torch.equal(hist, want_hist)
        seen.append((fn._graph.captured, dec._graph.captured))
    assert seen == [(False, False), (True, True), (True, True),
                    (False, False), (True, True), (True, True),
                    (False, False), (True, True)]


#: the soft values the front end must cast as ``to_int8`` does
_FRONT_SPECIAL = [127.5, -127.5, 0.9, -0.9, 1e6, -1e6, float("inf"),
                  -float("inf")]


def _front_cases(name):
    """(geometries at odd start addresses, as many a bucket as the
    configuration has, up to 2) of a benchmark configuration, or of an
    EEP-B profile (64 kbit/s, level 2)."""
    import json
    import pathlib
    from dabbench.common import geometries
    from dabjax_torch.msc.subchannel import SubchGeometry
    if name == "eep_b":
        protos = [SubchGeometry(0, 0, 42, 64, "EEP-B", 2)] * 3
    else:
        path = pathlib.Path(__file__).resolve().parents[1] / "dabbench" \
            / "configs" / f"{name}.json"
        with open(path) as f:
            protos = geometries(json.load(f))
    per_key = {}
    for g in protos:
        per_key.setdefault(g.shape_key, []).append(g)
    out, cursor = [], 1
    for gs in per_key.values():
        for g in gs[:2]:
            cursor += 1 - cursor % 2              # an odd start
            out.append(SubchGeometry(len(out), cursor, g.length_cus,
                                     g.bitrate, g.protection, g.prot_level))
            cursor += g.length_cus + 1
    assert cursor <= 864
    return out


def _front_block(n_new, seed, dev):
    """(history [15, 55296], new CIFs [n_new, 55296]) float32 soft bits in
    -160 .. 160 with ``_FRONT_SPECIAL`` planted."""
    from dabjax_torch.constants import CIF_BITS
    from dabjax_torch.msc.deinterleave import HISTORY
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand((HISTORY + n_new, CIF_BITS), generator=g, device=dev)
         * 320 - 160)
    at = torch.randint(0, x.numel(), (64 * len(_FRONT_SPECIAL),),
                       generator=g, device=dev)
    x.view(-1)[at] = torch.tensor(_FRONT_SPECIAL, device=dev).repeat(64)
    return x[:HISTORY].clone(), x[HISTORY:].clone()


@pytest.mark.cuda
@pytest.mark.parametrize("new", [4, 16, 1440])
@pytest.mark.parametrize("name", ["dabplus12_eep3a", "mixed12_uep", "eep_b"])
def test_msc_front_kernel_equals_the_chain_on_card(name, new):
    """The front-end kernel's K1 input against ``step_soft(
    depuncture_profile(time_deinterleave(msc_soft(cat(hist, cifs)))))``
    byte for byte, for every bucket of the configuration at odd start
    addresses: from the history and the new CIFs where they lie
    (``EnsembleDecoder``), and from the bucket's float32 and int8 slices
    (``full_rate``, the entry of ``decode_subchannel``); one launch a
    bucket."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.msc.subchannel import (EnsembleDecoder, full_rate,
                                             full_rate_torch, msc_soft)
    dev = _card()
    dec = EnsembleDecoder(_front_cases(name), get_mode(1), device=dev)
    hist, cifs = _front_block(new, new + len(dec.geoms), dev)
    block = torch.cat([hist, cifs])
    soft = msc_soft(block)
    for off, geoms in dec._bucket_starts():
        g = geoms[0]
        nbits = 24 * g.bitrate
        want = vc.step_soft(full_rate_torch(dec._slices(soft, off, geoms), g),
                            nbits).reshape(len(geoms), new, -1)
        _build.LAUNCHES.clear()
        got = dec._full_rate(hist, cifs, off, geoms)
        from_float = full_rate(dec._slices(block, off, geoms), g)
        from_int8 = full_rate(dec._slices(soft, off, geoms), g)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["msc_front"] == 3
        for what, t in (("block", got), ("float32 slices", from_float),
                        ("int8 slices", from_int8)):
            assert t.dtype == torch.int8 and t.is_contiguous()
            assert torch.equal(t, want), (g.shape_key, what)


@pytest.mark.cuda
def test_msc_front_refuses_bad_input_on_card():
    """The wrapper raises on a CPU tensor, another dtype, a 1-D or
    strided head, rows off 16 bytes, a tail unlike the head, bad starts
    and too few columns, and launches nothing."""
    from dabjax_torch.msc import front_cuda
    dev = _card()
    lengths, pis = [69, 3], [8, 7]                # EEP-A 96 kbit/s, level 3
    rows = torch.zeros((20, 4608 * 2), device=dev)
    starts = torch.tensor([0, 72], device=dev)
    _build.LAUNCHES.clear()
    assert front_cuda.msc_front(rows, None, starts, 4608, lengths,
                                pis).shape == (2, 5, 9240)
    assert _build.LAUNCHES["msc_front"] == 1
    bad = [
        (rows.cpu(), None, starts.cpu(), 4608),
        (rows.double(), None, starts, 4608),
        (rows.view(-1), None, starts, 4608),
        (rows.t(), None, starts, 4608),
        (rows.view(-1)[1: 1 + 19 * 9216].view(19, 9216), None, starts,
         4608),
        (torch.zeros((20, 9217), device=dev)[:, :9216], None, starts, 4608),
        (rows[:15], rows[15:].to(torch.int8), starts, 4608),
        (rows[:15], torch.zeros((5, 9216 + 16), device=dev)[:, :9216],
         starts, 4608),
        (rows, None, starts.to(torch.int32), 4608),
        (rows, None, starts.cpu(), 4608),
        (rows, None, torch.stack([starts, starts]).t(), 4608),
        (rows, None, starts, 4600),
        (rows, None, starts, 4616),
    ]
    _build.LAUNCHES.clear()
    for k, (head, tail, st, n_cols) in enumerate(bad):
        with pytest.raises(ValueError):
            front_cuda.msc_front(head, tail, st, n_cols, lengths, pis)
            pytest.fail(f"case {k} did not raise")
    assert _build.LAUNCHES["msc_front"] == 0


def _live(u8, offset, dev, mesh=None):
    """A live receiver on a loop from ``offset``, recording its routed
    frames and each block's merged bytes."""
    from dabbench.common import LoopSource
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import Receiver
    frames = []

    class Handler:
        def __init__(self, sid):
            self.sid = sid

        def add_logical_frame(self, bits):
            frames.append((self.sid, np.packbits(bits).tobytes()))

    rx = Receiver(LoopSource(u8, offset),
                  ReceiverConfig(frames_per_block=4, decode_audio=False,
                                 decode_data=True),
                  data_handler_factory=lambda db, sid: Handler(sid),
                  mesh=mesh, device=dev)
    return rx, frames


def _live_blocks(rx, n):
    out = []
    for _ in range(n):
        blk = rx.stage()
        out.append(blk.merged.cpu().numpy().tobytes())
        rx.consume(blk)
    return out


BANK_BLOCKS = 30


@pytest.mark.cuda
def test_bank_channels_keep_their_own_bytes_on_card(monkeypatch):
    """A two-channel ``MultiReceiver`` of equal shapes (the mixed
    ensemble from two loop frames): each channel's pulled bytes and
    routed frames equal its lone receiver's eager run, block by block."""
    from dabjax_torch.parallel.multihost import MultiReceiver
    dev = _card()
    _, loop, p, _, _ = _bench_loop("mixed12_uep")
    offsets = {"a": 3 * p.T_F, "b": 17 * p.T_F + 999}
    bank = MultiReceiver({}, device=dev)
    lives = {name: _live(loop.u8, off, dev) for name, off in offsets.items()}
    bank.rx = {name: rx for name, (rx, _) in lives.items()}
    pulled = []
    pull = bank._pull

    def _pull(blob):
        pulled.append(pull(blob))
        return pulled[-1]

    bank._pull = _pull
    try:
        for _ in range(BANK_BLOCKS):
            assert all(bank.step().values())
        assert all(rx._block_fn._graph.captured and rx._decoder._graph.captured
                   for rx in bank.rx.values())
    finally:
        bank.close()
    _eager(monkeypatch)
    for name, off in offsets.items():
        rx, frames = _live(loop.u8, off, dev)
        try:
            lone = _live_blocks(rx, BANK_BLOCKS)
        finally:
            rx.close()
        assert frames == lives[name][1], name
        for k, big in enumerate(pulled):
            a = len(pulled[k]) - len(lone[k]) if name == "b" else 0
            assert big[a: a + len(lone[k])].tobytes() == lone[k], (name, k)


BANK32_WARM, BANK32_PERIODS = 40, 50


@pytest.mark.cuda
def test_bank_of_32_channels_on_card():
    """A 32-channel ``MultiReceiver`` of the mixed ensemble (the live
    monitor's bank), every channel from a loop offset of its own: once
    every channel's block and MSC graphs are captured, each bank span
    opens once a period and counts the channels and the joined blob's
    bytes; in the first periods, and in the first after the capture,
    each channel's slice of the joined blob equals its own blob pulled
    alone; after the warm-up the device memory stays flat."""
    from dabjax_torch.parallel.multihost import MultiReceiver
    dev = _card()
    _, loop, p, _, _ = _bench_loop("mixed12_uep")
    bank = MultiReceiver({}, device=dev)
    bank.rx = {f"ch{c}": _live(loop.u8, (c * 7 % 30) * p.T_F + 131 * c,
                               dev)[0] for c in range(32)}
    checked = []

    def slices_of(rx):
        consume = rx.consume

        def _consume(blk, big):
            if check:
                assert big.tobytes() == blk.merged.cpu().numpy().tobytes()
                checked.append(len(big))
            return consume(blk, big)

        return _consume

    for rx in bank.rx.values():
        rx.consume = slices_of(rx)
    try:
        for k in range(BANK32_WARM):
            check = k < 3
            assert all(bank.step().values())
        assert all(rx._block_fn._graph.captured and rx._decoder._graph.captured
                   for rx in bank.rx.values())
        bank.profiler.stages.clear()
        torch.cuda.synchronize(dev)
        allocated = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for k in range(BANK32_PERIODS):
            check = k < 3
            assert all(bank.step().values())
        torch.cuda.synchronize(dev)
        assert torch.cuda.memory_allocated(dev) == allocated
        peak = torch.cuda.max_memory_allocated(dev) - allocated
        st = bank.profiler.stages
        assert {n: st[n].calls for n in st} == {
            "bank_stage": BANK32_PERIODS, "bank_pull": BANK32_PERIODS,
            "bank_consume": BANK32_PERIODS}
        assert st["bank_stage"].items == 32 * BANK32_PERIODS
        # the joined blob of a captured period: 32 blobs of one layout
        assert st["bank_pull"].items == BANK32_PERIODS * 32 * checked[-1]
        assert len(checked) == 6 * 32
        print(f"bank32: {allocated} bytes allocated, peak +{peak}, "
              f"{checked[-1]} bytes a channel a period")
    finally:
        bank.close()


@pytest.mark.cuda
def test_mesh_receiver_equals_single_device_on_card():
    """``mesh=make_mesh(2)`` of the one card (both positions on it) runs
    the eager code and routes the single-device receiver's frames, whose
    blocks replay their graphs."""
    from dabjax_torch.parallel.mesh import make_mesh
    dev = _card()
    _, loop, p, _, _ = _bench_loop("mixed12_uep")
    runs = {}
    for name, mesh in (("single", None),
                       ("mesh", make_mesh(2, devices=[dev] * 2))):
        rx, frames = _live(loop.u8, 5 * p.T_F, dev, mesh)
        try:
            _live_blocks(rx, BANK_BLOCKS)
            runs[name] = (frames, rx._block_fn._graph,
                          rx._decoder._graph)
        finally:
            rx.close()
    assert runs["mesh"][0] == runs["single"][0]
    assert runs["single"][0]
    assert runs["single"][1].captured and runs["single"][2].captured
    assert runs["mesh"][1]._key is None and runs["mesh"][2]._key is None


# ------------------------------------------------- the rows beside the graph

UPLOAD_BLOCKS = 40


@pytest.mark.cuda
def test_upload_beside_the_block_graph_on_card(monkeypatch):
    """40 blocks of the core's 360 frames through ``Receiver._block`` as
    the archive decoder's cell drives them: two pinned host buffers (two
    noise draws of the loop) in turn, each block issued before the one
    before it is read.  Every block's blob equals a synchronous eager run
    of its buffer; uploads took the staged path (the block before still
    read the rows' buffer); the block graph was captured once, on the
    one rows buffer."""
    import json
    import pathlib
    from dabbench.gen.loop import make_loops, period
    from dabjax_torch import graphs
    from dabjax_torch.constants import get_mode
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import BlockFn, Receiver
    from dabjax_torch.testing import LoopSource
    dev = _card()
    path = pathlib.Path(__file__).resolve().parents[1] / "dabbench" \
        / "configs" / "dabplus12_eep3a.json"
    with open(path) as f:
        cfg = json.load(f)
    p = get_mode(cfg["mode"])
    F = 12 * period(get_mode(1)).frames
    bufs = []
    for loop in make_loops(cfg, 2024, draws=2):
        rows = _loop_rows(loop).repeat(12, 1, 1)
        bufs.append(torch.empty(rows.shape, dtype=rows.dtype,
                                pin_memory=True).copy_(rows))
    ref = BlockFn(p, "u8", device=dev)
    coarse = torch.zeros(F, device=dev)
    want = [ref._assemble([ref._frames(b.to(dev), coarse)], dev)[1].cpu()
            for b in bufs]
    assert not torch.equal(want[0], want[1])
    captures = []
    capture = graphs.CudaCapture.capture

    def counted(self, fn, device):
        captures.append(device)
        return capture(self, fn, device)

    monkeypatch.setattr(graphs.CudaCapture, "capture", counted)
    rx = Receiver(LoopSource(np.zeros(1, np.complex64)),
                  ReceiverConfig(mode=cfg["mode"], frames_per_block=F),
                  device=dev)
    pinned = [torch.empty(want[0].shape, dtype=torch.uint8, pin_memory=True)
              for _ in range(2)]
    events = [torch.cuda.Event() for _ in range(2)]

    def issue(k):
        _, blob = rx._block(bufs[k % 2])
        pinned[k % 2].copy_(blob, non_blocking=True)
        events[k % 2].record()

    issue(0)
    for k in range(UPLOAD_BLOCKS):
        if k + 1 < UPLOAD_BLOCKS:
            issue(k + 1)
        events[k % 2].synchronize()
        assert torch.equal(pinned[k % 2], want[k % 2]), f"block {k}"
    assert captures == [dev] and rx._block_fn._graph.captured
    assert sum(rx.uploads.values()) == UPLOAD_BLOCKS
    assert rx.uploads["staged"] > 0
    assert rx._rows_up.stage is not None
    print(f"upload: {dict(rx.uploads)} of {UPLOAD_BLOCKS} blocks")


@pytest.mark.cuda
def test_live_receiver_uploads_direct_on_card():
    """A live receiver syncs on each block's blob before it stages the
    next, so every upload finds the rows' buffer free: 20 blocks, all
    direct, and no staging buffer made."""
    dev = _card()
    _, loop, p, _, _ = _bench_loop("mixed12_uep")
    rx, frames = _live(loop.u8, 5 * p.T_F, dev)
    try:
        _live_blocks(rx, 20)
    finally:
        rx.close()
    assert frames
    assert rx.uploads == {"direct": 20}
    assert rx._rows_up.stage is None


@pytest.mark.cuda
def test_lband_core_block_is_correct_on_card():
    """The L-Band Mode II cell's block, 1,440 frames of all 12 services,
    through the core driver (the block graph and ``EnsembleDecoder.fused``
    captured and replayed) on the card, held to the benchmark's plain
    reference by the cell's own comparison."""
    from dabbench.control import program_checks
    from dabbench.gen.loop import load_config
    dev = _card()
    c = program_checks(load_config("dabplus12_eep3a_lband"), 28, dev)
    assert c.correct, c.values
