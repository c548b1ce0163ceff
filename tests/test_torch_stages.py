"""The port's pipeline_stages against dabjax's on golden Mode I IQ: the
same prefixes, each folding every output it computes into one float32
value, and the viterbi_forward prefix under each Viterbi soft format."""

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


@pytest.fixture(scope="module")
def values(golden):
    """{stage: (dabjax value, port value)}, i8lane in both."""
    p, geoms, rows = golden
    geoms_j = tuple(subch_jax.SubchGeometry(*dataclasses.astuple(g))
                    for g in geoms)
    fns_j = pipe_jax.pipeline_stages(p, geoms_j)
    fns_t = pipeline.pipeline_stages(p, geoms, device="cpu")
    assert tuple(fns_t) == tuple(fns_j) == STAGES
    names = ("demod", "fic", "deint_depunct", "full")
    # one jit for the four prefixes: XLA shares their common front
    vals_j = jax.jit(lambda r: tuple(fns_j[n](r) for n in names))(
        jnp.asarray(rows))
    x = torch.from_numpy(rows)
    out = {}
    for name, vj in zip(names, vals_j):
        vt = fns_t[name](x)
        assert vt.dtype == torch.float32 and vt.dim() == 0
        out[name] = (float(vj), float(vt))
    return out


def test_demod_fic_and_deint_stages_match_dabjax(values):
    """The soft bits of the two demods may differ by 1 at rounding edges
    (about 1e-5 of them, tests/test_torch_demod.py); each such flip moves
    a prefix sum by at most 1 per appearance (twice in deint_depunct:
    once in the soft bits, once depunctured), so the bound is 3e-4 of the
    soft-bit count.  The FIB bits and CRC flags are exact."""
    p = get_mode(1)
    tol = 3e-4 * N_FRAMES * (p.L - 1) * 2 * p.K
    for name in ("demod", "fic", "deint_depunct"):
        vj, vt = values[name]
        assert abs(vt - vj) <= tol, (name, vj, vt)
    # the FIC's own contribution is exact
    fic_j = values["fic"][0] - values["demod"][0]
    fic_t = values["fic"][1] - values["demod"][1]
    assert fic_t == fic_j > 0


def test_full_stage_exact(values):
    vj, vt = values["full"]
    assert vt == vj > 0


@pytest.mark.parametrize("fmt", ["i8lane", "i8mxu", "i8", "f32"])
def test_viterbi_forward_stage_folds_dec00(golden, fmt, monkeypatch):
    """viterbi_forward = deint_depunct + sum(dec[0, 0]) of the port's own
    decision layout under each SOFT_FMT (the same float32 sums, in the
    same order, so equal exactly)."""
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
    assert float(v_fwd) == float(v_prep + dec[0, 0].to(torch.float32).sum())
