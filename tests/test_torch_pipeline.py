"""dabjax_torch pipelines against dabjax on the same golden IQ: the frame
pipeline (demod + FIC) in Modes I-IV, the full-ensemble pipeline for UEP,
EEP-A and EEP-B buckets, and the fused per-block MSC chain.  Everything
after the CRC gates and the Viterbi must be bit-exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dabjax.constants import CIF_BITS, get_mode
from dabjax.iq import pack_iq
from dabjax.msc import subchannel as subch_jax
from dabjax.ofdm import demod as demod_jax
from dabjax.runtime import pipeline as pipe_jax
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator
from dabjax_torch.msc.subchannel import EnsembleDecoder, SubchGeometry
from dabjax_torch.runtime import pipeline

torch.set_num_threads(1)


def _rows(mod, p, n_frames, **iq_kw):
    iq = mod.iq(n_frames, **iq_kw)
    u0 = iq_kw.get("sample_offset", 0) + p.T_null + p.T_g
    need = demod_jax.min_frame_samples(p)
    return pack_iq(np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                             for f in range(n_frames)]))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_frame_pipeline_fic_exact(mode):
    p = get_mode(mode)
    svc = [ServiceSpec(label="FRAMES", sid=0x2101, subch_id=2, start_addr=0,
                       bitrate=64, protection="EEP-A", prot_level=2,
                       kind="DAB+")]
    rows = _rows(Modulator(mode=mode, services=svc), p, 2, snr_db=25.0,
                 sample_offset=300, seed=mode)
    _, fib_j, ok_j, snr_j = jax.jit(pipe_jax.frame_pipeline(p))(
        jnp.asarray(rows))
    soft, fib_t, ok_t, snr_t = pipeline.frame_pipeline(p, device="cpu")(
        torch.from_numpy(rows))
    assert np.asarray(ok_j).all()
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j) > 0)
    np.testing.assert_array_equal(fib_t.numpy(), np.asarray(fib_j))
    np.testing.assert_allclose(snr_t.numpy(), np.asarray(snr_j), atol=1e-3)
    assert soft.shape == (2, p.L - 1, 2 * p.K)


_BUCKETS = {
    "UEP": dict(bitrate=96, protection="UEP", prot_level=3),
    "EEP-A": dict(bitrate=64, protection="EEP-A", prot_level=2),
    "EEP-B": dict(bitrate=64, protection="EEP-B", prot_level=3),
}


@pytest.mark.parametrize("bucket", sorted(_BUCKETS))
def test_full_ensemble_pipeline_exact(bucket):
    # Mode II: one CIF per frame, so 17 frames give 2 decoded frames
    p, n_frames = get_mode(2), 17
    kw = _BUCKETS[bucket]
    svc = [ServiceSpec(label=f"B{i}", sid=0x2200 + i, subch_id=3 + i,
                       start_addr=start, kind="DAB", **kw)
           for i, start in enumerate((5, 300))]
    mod = Modulator(mode=2, services=svc)
    rows = _rows(mod, p, n_frames, snr_db=30.0, sample_offset=64, seed=4)
    geoms = tuple(SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                                s.bitrate, s.protection, s.prot_level)
                  for s in svc)
    geoms_j = tuple(subch_jax.SubchGeometry(*dataclasses.astuple(g))
                    for g in geoms)
    ok_j, bits_j = jax.jit(pipe_jax.full_ensemble_pipeline(p, geoms_j))(
        jnp.asarray(rows))
    ok_t, bits_t = pipeline.full_ensemble_pipeline(p, geoms, device="cpu")(
        torch.from_numpy(rows))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j) > 0)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    assert ok_t.all()
    bits_t = bits_t.numpy()
    assert bits_t.shape == (2, n_frames - 15, 24 * kw["bitrate"])
    for i, s in enumerate(svc):
        for t in range(bits_t.shape[1]):
            np.testing.assert_array_equal(bits_t[i, t],
                                          mod.payload_bits(s.subch_id, t))


def test_fused_msc_bytes_match_dabjax():
    """EnsembleDecoder.fused against dabjax's _fused_msc on the same
    history, CIFs and blob: two buckets, start addresses as a tensor."""
    p = get_mode(1)
    geoms = [SubchGeometry(1, 0, 64, 64, "EEP-A", 2),
             SubchGeometry(2, 100, 70, 96, "UEP", 3),
             SubchGeometry(5, 700, 64, 64, "EEP-A", 2)]
    rng = np.random.default_rng(11)
    hist = rng.integers(-127, 128, (15, CIF_BITS)).astype(np.float32)
    cifs = rng.integers(-127, 128, (2, CIF_BITS)).astype(np.float32)
    blob = rng.integers(0, 256, 37).astype(np.uint8)
    dec_j = subch_jax.EnsembleDecoder(
        [subch_jax.SubchGeometry(*dataclasses.astuple(g)) for g in geoms], p)
    mj, hj, meta_j = dec_j.fused(jnp.asarray(hist), jnp.asarray(cifs),
                                 jnp.asarray(blob))
    dec_t = EnsembleDecoder(geoms, p, device="cpu")
    mt, ht, meta_t = dec_t.fused(torch.from_numpy(hist),
                                 torch.from_numpy(cifs),
                                 torch.from_numpy(blob))
    assert mt.dtype == torch.uint8
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert [(tuple(g.subch_id for g in gs), s) for gs, s in meta_t] == \
        [(tuple(g.subch_id for g in gs), s) for gs, s in meta_j]
    # the unfused per-bucket decode of the same block
    block = np.concatenate([hist, cifs])
    out_j = dec_j.decode(jnp.asarray(block))
    out_t = dec_t.decode(torch.from_numpy(block))
    assert sorted(out_t) == sorted(out_j) == [1, 2, 5]
    for k in out_j:
        np.testing.assert_array_equal(out_t[k], out_j[k])


def test_example_rows_shape():
    p = get_mode(2)
    rows = pipeline.example_rows(p, 3, device="cpu")
    assert rows.shape == tuple(pipe_jax.example_rows(p, 3).shape)
    assert rows.dtype == torch.float32
    ok = pipeline.frame_pipeline(p, device="cpu")(rows)[2]
    assert ok.shape == (3, 3) and ok.dtype == torch.bool
