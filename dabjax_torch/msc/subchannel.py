"""Subchannel decode: CIF soft bits -> logical-frame bits, all services
(torch port of :mod:`dabjax.msc.subchannel`).

Time de-interleave, depuncture, Viterbi and energy dispersal over every
subchannel of the ensemble, batched by shape bucket (subchannels of equal
size, bitrate and protection decode as one Viterbi batch).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dabjax.constants import CU_BITS, DabParams
from dabjax.fec import puncture as puncture_np
from dabjax_torch.fec import prbs, puncture, viterbi
from dabjax_torch.msc.deinterleave import HISTORY, time_deinterleave

__all__ = ["SubchGeometry", "subch_profile", "subch_puncture_mask",
           "decode_subchannel",
           "pack_bits_u8", "EnsembleDecoder"]


@dataclasses.dataclass(frozen=True)
class SubchGeometry:
    """Static decode geometry of one subchannel."""
    subch_id: int
    start_addr: int
    length_cus: int
    bitrate: int
    protection: str      # "UEP" | "EEP-A" | "EEP-B"
    prot_level: int

    @classmethod
    def from_db(cls, sc) -> "SubchGeometry":
        prot = ("UEP" if sc.uep_flag == 0
                else f"EEP-{sc.eep_profile}")
        return cls(subch_id=sc.subch_id, start_addr=sc.start_addr,
                   length_cus=sc.length, bitrate=sc.bitrate,
                   protection=prot, prot_level=sc.prot_level)

    @property
    def shape_key(self) -> Tuple:
        return (self.length_cus, self.bitrate, self.protection,
                self.prot_level)


def subch_profile(protection: str, bitrate: int, prot_level: int):
    """(lengths, pis) of a subchannel's puncturing profile."""
    if protection == "UEP":
        return puncture_np.uep_profile(bitrate, prot_level)
    return puncture_np.eep_profile(bitrate, prot_level, protection[-1])


@functools.lru_cache(maxsize=None)
def subch_puncture_mask(protection: str, bitrate: int, prot_level: int
                        ) -> np.ndarray:
    """Keep-mask of a subchannel's profile; raises ValueError/KeyError for
    a profile the decoder lacks."""
    return puncture_np.puncture_mask(*subch_profile(protection, bitrate,
                                               prot_level))


def decode_subchannel(subch_soft: torch.Tensor, g: SubchGeometry,
                      deinterleave: bool = True) -> torch.Tensor:
    """``subch_soft`` [..., T, length_cus*64] -> [..., T - 15, 24*bitrate]
    int32 logical-frame bits (output t is transmitted logical frame t)."""
    lengths, pis = subch_profile(g.protection, g.bitrate,
                                g.prot_level)
    soft = time_deinterleave(subch_soft) if deinterleave else subch_soft
    full = puncture.depuncture_profile(soft, lengths, pis)
    return prbs.disperse(viterbi.viterbi_decode(full, 24 * g.bitrate))


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """np.packbits on the device: (..., 8k) 0/1 -> (..., k) uint8, MSB
    first."""
    shifts = torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    x = bits.to(torch.int32).reshape(bits.shape[:-1] + (-1, 8))
    return (x << shifts).sum(dim=-1).to(torch.uint8)


class EnsembleDecoder(nn.Module):
    """All-services MSC decoder over shape buckets.

    Holds the subchannels' CU start addresses as a device buffer, so
    :meth:`fused` slices every subchannel with one gather per bucket and
    no host sync, whatever the start addresses are."""

    def __init__(self, geometries: Sequence[SubchGeometry], p: DabParams,
                 *, device):
        super().__init__()
        self.p = p
        self.geoms = list(geometries)
        self._buckets: Dict[Tuple, List[SubchGeometry]] = {}
        for g in self.geoms:
            self._buckets.setdefault(g.shape_key, []).append(g)
        starts = [g.start_addr for geoms in self._buckets.values()
                  for g in geoms]
        self.register_buffer(
            "starts", torch.tensor(starts, dtype=torch.int64,
                                   device=device), persistent=False)

    def decode(self, cifs: torch.Tensor) -> Dict[int, np.ndarray]:
        """``cifs`` [T, 55296] consecutive CIFs (T > 15) ->
        {subch_id: [T-15, 24*bitrate] bits}."""
        out: Dict[int, np.ndarray] = {}
        for key, geoms in self._buckets.items():
            slices = torch.stack([
                cifs[:, g.start_addr * CU_BITS:
                     (g.start_addr + g.length_cus) * CU_BITS]
                for g in geoms])
            bits = decode_subchannel(slices, geoms[0]).cpu().numpy()
            for i, g in enumerate(geoms):
                out[g.subch_id] = bits[i]
        return out

    def fused(self, hist: torch.Tensor, cifs: torch.Tensor,
              blob: torch.Tensor) -> Tuple:
        """The whole per-block MSC chain: history concat, per-bucket
        slicing, decode, bit-pack, merge behind ``blob``.  Returns
        ``(merged_u8, new_hist, bucket_meta)`` with bucket_meta listing
        (geoms, output_shape) in merge order for the host-side split."""
        block = torch.cat([hist, cifs], dim=0)
        T = block.shape[0]
        parts = [blob]
        meta = []
        off = 0
        for key, geoms in self._buckets.items():
            n = len(geoms)
            n_bits = geoms[0].length_cus * CU_BITS
            cols = torch.arange(n_bits, device=block.device)
            idx = self.starts[off: off + n, None] * CU_BITS + cols
            slices = block.index_select(1, idx.reshape(-1))
            slices = slices.reshape(T, n, n_bits).transpose(0, 1)
            packed = pack_bits_u8(decode_subchannel(slices, geoms[0]))
            parts.append(packed.reshape(-1))
            meta.append((geoms, (n, T - HISTORY, 3 * key[1])))
            off += n
        return torch.cat(parts), block[-HISTORY:], meta
