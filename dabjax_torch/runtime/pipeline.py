"""Receiver pipelines on frame-aligned IQ (torch port of
:mod:`dabjax.runtime.pipeline`).

Rows are ``[F, need, 2]`` float32 (re, im) pairs, each starting at the PRS
useful part, as in dabjax; ``demod.complex_rows`` views them as complex64
without a copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from dabjax_torch.constants import CU_BITS, DabParams
from dabjax_torch.fec import viterbi
from dabjax_torch.fic.fic_decoder import decode_fic
from dabjax_torch.msc.cif import cifs_from_soft
from dabjax_torch.msc.subchannel import (SubchGeometry, decode_subchannel,
                                         full_rate, msc_soft)
from dabjax_torch.ofdm import demod

__all__ = ["FramePipeline", "FullEnsemblePipeline", "frame_pipeline",
           "full_ensemble_pipeline", "pipeline_stages", "example_rows"]


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

    @torch.no_grad()   # inference only: a quarter less host time a batch
    def forward(self, rows: torch.Tensor):
        p = self.p
        x = demod.complex_rows(_on(rows, self.device), "f32")
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

    @torch.no_grad()   # inference only: a quarter less host time a batch
    def forward(self, rows: torch.Tensor):
        p = self.p
        x = demod.complex_rows(_on(rows, self.device), "f32")
        fine = demod.fine_cfo_estimate(x, p)
        soft, _ = demod.demodulate_frames_cfo(x, fine, p)
        _, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        cifs = msc_soft(cifs_from_soft(soft, p))
        slices = cifs[:, self.idx].transpose(0, 1)       # [n_subch, T, bits]
        return ok, decode_subchannel(slices, self.proto)


def frame_pipeline(p: DabParams, *, device) -> FramePipeline:
    return FramePipeline(p, device=device)


def full_ensemble_pipeline(p: DabParams, geoms: Sequence[SubchGeometry],
                           *, device) -> FullEnsemblePipeline:
    return FullEnsemblePipeline(p, geoms, device=device)


def _fold(*tensors: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the first element of each tensor: an indexed
    element, never a copy or a reduction of the tensor."""
    return sum(t[(0,) * t.dim()].to(torch.float32) for t in tensors)


def pipeline_stages(p: DabParams, geoms: Sequence[SubchGeometry], *,
                    device):
    """Cumulative sub-pipelines of :func:`full_ensemble_pipeline` for a
    per-stage breakdown (port of ``dabjax.runtime.pipeline.
    pipeline_stages``).

    Returns an ordered dict of name -> fn(rows) -> 0-d float32 tensor;
    each fn is a strict prefix of the full pipeline, and its value folds
    in the first element of every tensor it computes (:func:`_fold`).
    dabjax sums every output because XLA would otherwise drop the work
    that feeds nothing; eager PyTorch launches every op whether or not its
    result is read, so one element each suffices, and a full sum would add
    a reduction the full pipeline does not run (over the int8 full-rate
    stream, 0.27 ms on an H100, enough to make the last stage negative).
    Stage cost is the difference of adjacent prefix times: demod | fic |
    deint_depunct | viterbi_forward | traceback_dispersal (= full -
    viterbi_forward).  ``deint_depunct`` holds the int8 formats' clip and
    cast of the CIF block (:func:`msc_soft`), which comes before its
    gathers, and the front end (:func:`full_rate`: on a card the
    front-end kernel), so ``viterbi_forward`` is the forward kernel and nothing
    else; it folds in ``dec[0, 0, 0]`` of the decision layout
    ``viterbi_cuda.SOFT_FMT`` gives."""
    full_pipe = FullEnsemblePipeline(p, geoms, device=device)
    proto, idx = full_pipe.proto, full_pipe.idx
    dev = full_pipe.device

    def _front(rows):
        x = demod.complex_rows(_on(rows, dev), "f32")
        fine = demod.fine_cfo_estimate(x, p)
        return demod.demodulate_frames_cfo(x, fine, p)[0]

    def _fic(soft):
        return _fold(*decode_fic(soft[:, : p.fic_symbols, :], p))

    def _prep(soft):
        slices = msc_soft(cifs_from_soft(soft, p))[:, idx].transpose(0, 1)
        return full_rate(slices, proto)

    def s_demod(rows):
        return _fold(_front(rows))

    def s_fic(rows):
        soft = _front(rows)
        return _fold(soft) + _fic(soft)

    def s_prep(rows):
        soft = _front(rows)
        return _fold(soft, _prep(soft)) + _fic(soft)

    def s_forward(rows):
        soft = _front(rows)
        full = _prep(soft)
        dec, _ = viterbi.viterbi_forward_words(full, 24 * proto.bitrate)
        return _fold(soft, full, dec) + _fic(soft)

    def s_full(rows):
        return _fold(*full_pipe(rows))

    stages = {"demod": s_demod, "fic": s_fic, "deint_depunct": s_prep,
              "viterbi_forward": s_forward, "full": s_full}
    return {name: torch.no_grad()(fn) for name, fn in stages.items()}


def example_rows(p: DabParams, n_frames: int = 2, seed: int = 0, *,
                 device) -> torch.Tensor:
    """Random frame rows (float IQ pairs) of the pipeline's input shape."""
    rng = np.random.default_rng(seed)
    need = demod.min_frame_samples(p)
    x = rng.standard_normal((n_frames, need, 2)) / np.sqrt(2)
    return torch.as_tensor(x.astype(np.float32), device=device)
