"""Sharded full-ensemble decode step over a (time, subch) mesh (torch port
of :mod:`dabjax.parallel.sharding`).

dabjax's step is one SPMD program (``shard_map``); here the one process
issues each mesh position's work on that position's device:

* frame rows are split along ``time``; demod and FIC run once a time
  row, on the row's first position (``shard_map`` repeats them on every
  subch position), and the row's CIF block is copied to its other
  positions
* the MSC time de-interleaver needs the previous 15 CIFs: each row's
  last 15 go to the next row as a halo, and row 0 gets zeros, as
  ``ppermute`` gives a device that is sent nothing
* subchannels are split along ``subch``; each position decodes its
  slice of one shape bucket
* the FIC CRC pass rate is summed over the rows on the home device
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from dabjax_torch.constants import CU_BITS, DabParams
from dabjax_torch.devices import on_device
from dabjax_torch.fic.fic_decoder import decode_fic
from dabjax_torch.msc.cif import cifs_from_soft
from dabjax_torch.msc.deinterleave import HISTORY
from dabjax_torch.msc.subchannel import (SubchGeometry, decode_subchannel,
                                         msc_soft)
from dabjax_torch.ofdm import demod
from dabjax_torch.parallel.mesh import Mesh

__all__ = ["sharded_ensemble_step", "make_sharded_inputs"]


def sharded_ensemble_step(mesh: Mesh, p: DabParams, proto: SubchGeometry):
    """Build the step.

    Returns ``fn(rows, starts) -> (fic_ratio, subch_bits)`` over
    :func:`make_sharded_inputs`' placement, where
      fic_ratio: 0-d float32 on the home device, the fraction of FIBs
        passing CRC
      subch_bits: [n_subch, T_total, 24*bitrate] int32 on the home device:
        each time row contributes its CIFs, decoded over the 15-CIF halo
        of the row before (zeros for row 0), so output ``15 + t`` is
        logical frame ``t``.
    """
    n_time, n_col = mesh.devices.shape
    n_bits = proto.length_cus * CU_BITS

    def cifs_of(rows: torch.Tensor):
        """Demod + FIC of one time row's frames: (int8 CIFs, FIBs passing
        CRC, FIBs)."""
        x = demod.complex_rows(rows, "f32")
        fine = demod.fine_cfo_estimate(x, p)
        soft, _ = demod.demodulate_frames_cfo(x, fine, p)
        _, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        cifs = msc_soft(cifs_from_soft(soft, p))
        if cifs.shape[0] < HISTORY:
            raise ValueError(
                f"time shard carries {cifs.shape[0]} CIFs < {HISTORY}-CIF "
                f"de-interleaver halo; use more frames per shard")
        return cifs, ok.to(torch.float32).sum(), ok.numel()

    def decode(block: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        idx = (starts[:, None] * CU_BITS
               + torch.arange(n_bits, device=block.device))
        slices = block.index_select(1, idx.reshape(-1))
        slices = slices.reshape(block.shape[0], -1, n_bits).transpose(0, 1)
        return decode_subchannel(slices, proto)

    @torch.no_grad()
    def step(rows: Sequence[torch.Tensor],
             starts: Sequence[Sequence[torch.Tensor]]):
        if len(rows) != n_time or any(len(s) != n_col for s in starts):
            raise ValueError("inputs not placed by make_sharded_inputs")
        blocks, passed, total = [], [], 0
        halo = None
        for r in range(n_time):
            dev = mesh.devices[r, 0]
            with on_device(dev):
                cifs, n_ok, n_fib = cifs_of(rows[r])
                if halo is None:
                    halo = cifs.new_zeros((HISTORY, cifs.shape[1]))
                blocks.append(torch.cat([halo.to(dev), cifs]))
            halo = cifs[-HISTORY:]
            passed.append(n_ok)
            total += n_fib
        bits = [[None] * n_col for _ in range(n_time)]
        for r in range(n_time):
            for c in range(n_col):
                dev = mesh.devices[r, c]
                with on_device(dev):
                    bits[r][c] = decode(blocks[r].to(dev), starts[r][c])
        home = mesh.home
        fic_ratio = sum(n.to(home) for n in passed) / total
        out = torch.cat([torch.cat([bits[r][c].to(home)
                                    for r in range(n_time)], dim=1)
                         for c in range(n_col)])
        return fic_ratio, out

    return step


def make_sharded_inputs(mesh: Mesh, rows, starts: np.ndarray
                        ) -> Tuple[List[torch.Tensor],
                                   List[List[torch.Tensor]]]:
    """Place the step's inputs: ``rows`` ([F, need] complex, or [F, need,
    2] float (re, im) pairs, numpy or torch) in contiguous frame shards on
    the time rows' first positions, ``starts`` ([n_subch] CU start
    addresses) in contiguous slices on the subch columns, one copy a
    position.  F must divide by the time size and n_subch by the subch
    size."""
    n_time, n_col = mesh.devices.shape
    if isinstance(rows, np.ndarray) and np.iscomplexobj(rows):
        rows = np.ascontiguousarray(rows, np.complex64)
        rows = rows.view(np.float32).reshape(rows.shape + (2,))
    rows = torch.as_tensor(rows)
    starts = np.asarray(starts, np.int64)
    if rows.shape[0] % n_time or starts.shape[0] % n_col:
        raise ValueError(
            f"{rows.shape[0]} frames over {n_time} time rows, "
            f"{starts.shape[0]} subchannels over {n_col} subch columns")
    row_parts = [part.to(mesh.devices[r, 0]) for r, part in
                 enumerate(torch.tensor_split(rows, n_time))]
    start_parts = [[torch.as_tensor(part, device=mesh.devices[r, c])
                    for c, part in enumerate(np.split(starts, n_col))]
                   for r in range(n_time)]
    return row_parts, start_parts
