"""The port's pipeline_stages against dabjax's on golden Mode I IQ: the
same prefixes, each folding the first element of every tensor it
computes into one float32 value (dabjax sums them all), the
viterbi_forward prefix under each Viterbi soft format, and no prefix
reducing a large tensor."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dabjax.constants import get_mode
from dabjax.iq import pack_iq
from dabjax.msc import subchannel as subch_jax
from dabjax.ofdm import demod as demod_jax
from dabjax.runtime import pipeline as pipe_jax
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator
from dabjax_torch.fec import viterbi, viterbi_cuda
from dabjax_torch.msc.subchannel import SubchGeometry
from dabjax_torch.runtime import pipeline

torch.set_num_threads(1)

# Mode I: four CIFs per frame, so 5 frames give 5 decoded logical frames
N_FRAMES = 5
STAGES = ("demod", "fic", "deint_depunct", "viterbi_forward", "full")


@pytest.fixture(scope="module")
def golden():
    p = get_mode(1)
    svc = [ServiceSpec(label=f"ST{i}", sid=0x2300 + i, subch_id=2 + i,
                       start_addr=start, bitrate=64, protection="EEP-A",
                       prot_level=2, kind="DAB+")
           for i, start in enumerate((0, 200))]
    mod = Modulator(mode=1, services=svc)
    iq = mod.iq(N_FRAMES, snr_db=30.0, seed=5)
    u0 = p.T_null + p.T_g
    need = demod_jax.min_frame_samples(p)
    rows = pack_iq(np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                             for f in range(N_FRAMES)]))
    geoms = tuple(SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                                s.bitrate, s.protection, s.prot_level)
                  for s in svc)
    return p, geoms, rows


def _fold(*arrays):
    """The port's fold (``pipeline._fold``) on numpy arrays: the float32
    sum of the first element of each."""
    return float(sum(np.float32(np.asarray(a).reshape(-1)[0])
                     for a in arrays))


@pytest.fixture(scope="module")
def values(golden):
    """{stage: (the fold of dabjax's tensors of that prefix, port
    value)}, i8lane in both."""
    from dabjax.fec import puncture as punct_jax
    from dabjax.fic.fic_decoder import decode_fic
    from dabjax.iq import unpack_iq
    from dabjax.msc.cif import cifs_from_soft
    from dabjax.msc.deinterleave import time_deinterleave

    p, geoms, rows = golden
    geoms_j = tuple(subch_jax.SubchGeometry(*dataclasses.astuple(g))
                    for g in geoms)
    fns_j = pipe_jax.pipeline_stages(p, geoms_j)
    fns_t = pipeline.pipeline_stages(p, geoms, device="cpu")
    assert tuple(fns_t) == tuple(fns_j) == STAGES
    proto = geoms_j[0]
    lengths, pis = punct_jax.eep_profile(proto.bitrate, proto.prot_level,
                                         proto.protection[-1])
    idx = (np.array([g.start_addr * 64 for g in geoms_j])[:, None]
           + np.arange(proto.length_cus * 64)[None, :])
    full_fn = pipe_jax.full_ensemble_pipeline(p, geoms_j)

    def tensors(r):
        x = unpack_iq(r)
        soft, _ = demod_jax.demodulate_frames_cfo(
            x, demod_jax.fine_cfo_estimate(x, p), p)
        fibs, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        slices = cifs_from_soft(soft, p)[:, idx].transpose(1, 0, 2)
        prep = punct_jax.depuncture_profile(time_deinterleave(slices),
                                            lengths, pis)
        return soft, fibs, ok, prep, full_fn(r)

    soft, fibs, ok, prep, full = jax.jit(tensors)(jnp.asarray(rows))
    want = {"demod": _fold(soft), "fic": _fold(soft, fibs, ok),
            "deint_depunct": _fold(soft, prep, fibs, ok),
            "full": _fold(*full)}
    x = torch.from_numpy(rows)
    out = {}
    for name, vj in want.items():
        vt = fns_t[name](x)
        assert vt.dtype == torch.float32 and vt.dim() == 0
        out[name] = (vj, float(vt))
    return out


def test_demod_fic_and_deint_stages_match_dabjax(values):
    """Each prefix folds the first element of each tensor it computes.
    The soft bits of the two demods may differ by 1 at rounding edges
    (about 1e-5 of them, tests/test_torch_demod.py), so a folded soft
    value may move the fold by 1 (twice in deint_depunct: once in the
    soft bits, once depunctured); the FIB bits and CRC flags are
    exact."""
    tol = {"demod": 1, "fic": 1, "deint_depunct": 2}
    for name in ("demod", "fic", "deint_depunct"):
        vj, vt = values[name]
        assert abs(vt - vj) <= tol[name], (name, vj, vt)
    # the FIC's own contribution is exact
    fic_j = values["fic"][0] - values["demod"][0]
    fic_t = values["fic"][1] - values["demod"][1]
    assert fic_t == fic_j > 0


def test_full_stage_exact(values):
    vj, vt = values["full"]
    assert vt == vj > 0


@pytest.mark.parametrize("fmt", ["i8lane", "i8mxu", "i8", "f32"])
def test_viterbi_forward_stage_folds_dec00(golden, fmt, monkeypatch):
    """viterbi_forward = deint_depunct + dec[0, 0, 0] of the port's own
    decision layout under each SOFT_FMT."""
    p, geoms, rows = golden
    monkeypatch.setattr(viterbi_cuda, "SOFT_FMT", fmt)
    seen = []
    forward = viterbi.viterbi_forward_words

    def spy(soft, nbits):
        # the FIC decode (768 bits) goes through it too; keep the MSC's
        out = forward(soft, nbits)
        if nbits == 24 * geoms[0].bitrate:
            seen.append(out[0])
        return out

    monkeypatch.setattr(viterbi, "viterbi_forward_words", spy)
    fns = pipeline.pipeline_stages(p, geoms, device="cpu")
    x = torch.from_numpy(rows)
    v_fwd = fns["viterbi_forward"](x)
    v_prep = fns["deint_depunct"](x)
    (dec,) = seen
    if fmt == "i8lane":
        assert dec.shape == (2 * (4 * N_FRAMES - 15), 64 * 24 + 6, 2)
    else:
        assert dec.shape[1:] == (64, 2 * (4 * N_FRAMES - 15))
    assert float(v_fwd) == float(v_prep + dec[0, 0, 0].to(torch.float32))


def test_stage_prefixes_reduce_no_large_tensor(golden, monkeypatch):
    """Each prefix launches its stages (the demod, the FIC decode, the
    MSC de-interleave, the MSC forward, the subchannel decode) and sums no
    tensor of more than 4096 elements itself: a full sum is work the
    full pipeline does not do, and would make a later stage read low."""
    import sys
    from dabjax_torch.ofdm import demod
    p, geoms, rows = golden
    msc_nbits = 24 * geoms[0].bitrate
    calls, sums = [], []

    def spy(name, fn, keep=lambda *a: True):
        def wrapped(*args, **kw):
            if keep(*args):
                calls.append(name)
            return fn(*args, **kw)
        return wrapped

    def summing(fn):
        def wrapped(t, *args, **kw):
            caller = sys._getframe(1).f_code.co_filename
            if caller == pipeline.__file__:
                sums.append(t.numel())
            return fn(t, *args, **kw)
        return wrapped

    monkeypatch.setattr(demod, "demodulate_frames_cfo",
                        spy("demod", demod.demodulate_frames_cfo))
    monkeypatch.setattr(pipeline, "decode_fic",
                        spy("fic", pipeline.decode_fic))
    monkeypatch.setattr(pipeline, "full_rate",
                        spy("deinterleave", pipeline.full_rate))
    monkeypatch.setattr(viterbi, "viterbi_forward_words",
                        spy("forward", viterbi.viterbi_forward_words,
                            lambda soft, nbits: nbits == msc_nbits))
    monkeypatch.setattr(pipeline, "decode_subchannel",
                        spy("subchannel", pipeline.decode_subchannel))
    monkeypatch.setattr(torch.Tensor, "sum", summing(torch.Tensor.sum))
    monkeypatch.setattr(torch, "sum", summing(torch.sum))
    fns = pipeline.pipeline_stages(p, geoms, device="cpu")
    x = torch.from_numpy(rows)
    want = {"demod": ["demod"], "fic": ["demod", "fic"],
            "deint_depunct": ["demod", "fic", "deinterleave"],
            "viterbi_forward": ["demod", "fic", "deinterleave", "forward"],
            "full": ["demod", "fic", "subchannel", "forward"]}
    for name, fn in fns.items():
        calls.clear()
        sums.clear()
        assert np.isfinite(float(fn(x)))
        assert sorted(set(calls)) == sorted(want[name]), (name, calls)
        assert all(n <= 4096 for n in sums), (name, sums)
