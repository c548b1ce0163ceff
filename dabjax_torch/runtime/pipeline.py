"""Receiver pipelines on frame-aligned IQ (torch port of
:mod:`dabjax.runtime.pipeline`).

Rows are ``[F, need, 2]`` float32 (re, im) pairs, each starting at the PRS
useful part, as in dabjax; ``torch.view_as_complex`` makes them complex64
without a copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from dabjax.constants import CU_BITS, DabParams
from dabjax_torch.fec import puncture, viterbi
from dabjax_torch.fic.fic_decoder import decode_fic
from dabjax_torch.msc.cif import cifs_from_soft
from dabjax_torch.msc.deinterleave import time_deinterleave
from dabjax_torch.msc.subchannel import (SubchGeometry, decode_subchannel,
                                         subch_profile)
from dabjax_torch.ofdm import demod

__all__ = ["FramePipeline", "FullEnsemblePipeline", "frame_pipeline",
           "full_ensemble_pipeline", "pipeline_stages", "example_rows"]


def _complex_rows(rows: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(rows.to(torch.float32).contiguous())


def _on(rows: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The pipeline never moves data between devices behind the caller."""
    if rows.device.type != device.type or (
            device.index is not None and rows.device.index != device.index):
        raise ValueError(f"rows on {rows.device}, pipeline on {device}")
    return rows


class FramePipeline(nn.Module):
    """Frame demod + FIC decode: rows -> (soft, fib_bits, crc_ok, snr)."""

    def __init__(self, p: DabParams, *, device):
        super().__init__()
        self.p = p
        self.device = torch.device(device)

    def forward(self, rows: torch.Tensor):
        p = self.p
        x = _complex_rows(_on(rows, self.device))
        fine = demod.fine_cfo_estimate(x, p)
        soft, spec0 = demod.demodulate_frames_cfo(x, fine, p)
        snr = demod.snr_estimate(spec0, p)
        fibs, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        return soft, fibs, ok, snr


class FullEnsemblePipeline(nn.Module):
    """Demod, FIC and every subchannel of one shape bucket:
    rows -> (fib_crc_ok [F, n_fibs], bits [n_subch, T-15, 24*bitrate])."""

    def __init__(self, p: DabParams, geoms: Sequence[SubchGeometry], *,
                 device):
        super().__init__()
        if len({g.shape_key for g in geoms}) != 1:
            raise ValueError("all subchannels must share one shape bucket")
        self.p = p
        self.device = torch.device(device)
        self.proto = geoms[0]
        n_bits = self.proto.length_cus * CU_BITS
        starts = np.array([g.start_addr * CU_BITS for g in geoms])
        idx = starts[:, None] + np.arange(n_bits)[None, :]
        self.register_buffer(
            "idx", torch.as_tensor(idx, dtype=torch.int64, device=device),
            persistent=False)

    def forward(self, rows: torch.Tensor):
        p = self.p
        x = _complex_rows(_on(rows, self.device))
        fine = demod.fine_cfo_estimate(x, p)
        soft, _ = demod.demodulate_frames_cfo(x, fine, p)
        _, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        cifs = cifs_from_soft(soft, p)
        slices = cifs[:, self.idx].transpose(0, 1)       # [n_subch, T, bits]
        return ok, decode_subchannel(slices, self.proto)


def frame_pipeline(p: DabParams, *, device) -> FramePipeline:
    return FramePipeline(p, device=device)


def full_ensemble_pipeline(p: DabParams, geoms: Sequence[SubchGeometry],
                           *, device) -> FullEnsemblePipeline:
    return FullEnsemblePipeline(p, geoms, device=device)


def pipeline_stages(p: DabParams, geoms: Sequence[SubchGeometry], *,
                    device):
    """Cumulative sub-pipelines of :func:`full_ensemble_pipeline` for a
    per-stage breakdown (port of ``dabjax.runtime.pipeline.
    pipeline_stages``).

    Returns an ordered dict of name -> fn(rows) -> 0-d float32 tensor;
    each fn is a strict prefix of the full pipeline and folds every output
    it computes into its value, so no stage is skipped.  Stage cost is the
    difference of adjacent prefix times: demod | fic | deint_depunct |
    viterbi_forward | traceback_dispersal (= full - viterbi_forward).  The
    ``viterbi_forward`` prefix folds in ``dec[0, 0]`` of the decision
    layout ``viterbi_cuda.SOFT_FMT`` gives (one element keeps the forward
    pass without a reduction over the whole plane)."""
    full_pipe = FullEnsemblePipeline(p, geoms, device=device)
    proto, idx = full_pipe.proto, full_pipe.idx
    lengths, pis = subch_profile(proto.protection, proto.bitrate,
                                 proto.prot_level)
    dev = full_pipe.device

    def _front(rows):
        x = _complex_rows(_on(rows, dev))
        fine = demod.fine_cfo_estimate(x, p)
        return demod.demodulate_frames_cfo(x, fine, p)[0]

    def _fic(soft):
        fibs, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        return (fibs.sum().to(torch.float32)
                + ok.sum().to(torch.float32))

    def _prep(soft):
        slices = cifs_from_soft(soft, p)[:, idx].transpose(0, 1)
        return puncture.depuncture_profile(time_deinterleave(slices),
                                           lengths, pis)

    def s_demod(rows):
        return _front(rows).sum()

    def s_fic(rows):
        soft = _front(rows)
        return soft.sum() + _fic(soft)

    def s_prep(rows):
        soft = _front(rows)
        return soft.sum() + _fic(soft) + _prep(soft).sum()

    def s_forward(rows):
        soft = _front(rows)
        full = _prep(soft)
        dec, _ = viterbi.viterbi_forward_words(full, 24 * proto.bitrate)
        return (soft.sum() + _fic(soft) + full.sum()
                + dec[0, 0].to(torch.float32).sum())

    def s_full(rows):
        ok, bits = full_pipe(rows)
        return ok.sum().to(torch.float32) + bits.sum().to(torch.float32)

    return {"demod": s_demod, "fic": s_fic, "deint_depunct": s_prep,
            "viterbi_forward": s_forward, "full": s_full}


def example_rows(p: DabParams, n_frames: int = 2, seed: int = 0, *,
                 device) -> torch.Tensor:
    """Random frame rows (float IQ pairs) of the pipeline's input shape."""
    rng = np.random.default_rng(seed)
    need = demod.min_frame_samples(p)
    x = rng.standard_normal((n_frames, need, 2)) / np.sqrt(2)
    return torch.as_tensor(x.astype(np.float32), device=device)
