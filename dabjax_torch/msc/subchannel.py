"""Subchannel decode: CIF soft bits -> logical-frame bits, all services
(torch port of :mod:`dabjax.msc.subchannel`).

Time de-interleave, depuncture, Viterbi and energy dispersal over every
subchannel of the ensemble, batched by shape bucket (subchannels of equal
size, bitrate and protection decode as one Viterbi batch).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dabjax_torch.constants import CIF_BITS, CU_BITS, DabParams
from dabjax_torch.devices import on_device, resolve
from dabjax_torch.fec import prbs, puncture, viterbi, viterbi_cuda
from dabjax_torch.graphs import BlockGraph, layout
from dabjax_torch.msc import front_cuda
from dabjax_torch.msc.deinterleave import HISTORY, time_deinterleave

__all__ = ["SubchGeometry", "subch_profile", "subch_puncture_mask",
           "decode_subchannel", "decode_full", "full_rate",
           "full_rate_torch", "msc_soft", "pack_bits_u8", "EnsembleDecoder"]


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
        return puncture.uep_profile(bitrate, prot_level)
    return puncture.eep_profile(bitrate, prot_level, protection[-1])


@functools.lru_cache(maxsize=None)
def subch_puncture_mask(protection: str, bitrate: int, prot_level: int
                        ) -> np.ndarray:
    """Keep-mask of a subchannel's profile; raises ValueError/KeyError for
    a profile the decoder lacks."""
    return puncture.puncture_mask(*subch_profile(protection, bitrate,
                                               prot_level))


def msc_soft(cifs: torch.Tensor) -> torch.Tensor:
    """CIF soft values in the type the Viterbi format decodes: int8
    (clipped to +-127, ``viterbi_cuda.to_int8``) under the int8 formats,
    unchanged under "f32".

    The de-interleave and the depuncture only move values and insert
    zeros, so the clip and cast give the same stream before them as after
    them; done here, on the CIF block, they touch a quarter of the
    full-rate stream's values once, and the gathers move int8."""
    if viterbi_cuda.soft_format() == "f32":
        return cifs
    return viterbi_cuda.to_int8(cifs)


def _front_kernel(device: torch.device) -> bool:
    """Whether the MSC front end runs as one kernel on ``device``
    (:mod:`dabjax_torch.msc.front_cuda`): on a CUDA card under the int8
    soft formats; the CPU and "f32" run the torch chain."""
    return device.type == "cuda" and viterbi_cuda.soft_format() != "f32"


def full_rate_torch(subch_soft: torch.Tensor, g: SubchGeometry
                    ) -> torch.Tensor:
    """The MSC front end as torch ops, the kernel's plain version:
    ``subch_soft`` [..., T, length_cus*64] -> [..., T - 15, 4*(nbits+6)]
    full-rate soft bits (:func:`msc_soft`'s type), time de-interleaved
    and depunctured.  The CPU, the mesh and "f32" run it."""
    lengths, pis = subch_profile(g.protection, g.bitrate, g.prot_level)
    return puncture.depuncture_profile(time_deinterleave(msc_soft(subch_soft)),
                                       lengths, pis)


def full_rate(subch_soft: torch.Tensor, g: SubchGeometry) -> torch.Tensor:
    """:func:`full_rate_torch`'s result, by the front-end kernel on a CUDA
    card under the int8 formats (float32 or int8 slices read as they lie
    where their strides allow, else from a contiguous copy)."""
    if not _front_kernel(subch_soft.device):
        return full_rate_torch(subch_soft, g)
    T, n_cols = subch_soft.shape[-2:]
    x = subch_soft.reshape((-1, T, n_cols))
    if x.dtype not in (torch.float32, torch.int8):
        x = msc_soft(x)
    sb, sr, sc = x.stride()
    if sc != 1 or sb % CU_BITS or (sr * x.element_size()) % 16 \
            or x.data_ptr() % 16:
        x = x.contiguous()
        sb, sr, _ = x.stride()
    # subchannel b's rows are rows of one strided view, from column b * sb
    rows = x.as_strided((T, (x.shape[0] - 1) * sb + n_cols), (sr, 1))
    starts = torch.arange(x.shape[0], device=x.device) * (sb // CU_BITS)
    lengths, pis = subch_profile(g.protection, g.bitrate, g.prot_level)
    out = front_cuda.msc_front(rows, None, starts, n_cols, lengths, pis)
    return out.reshape(subch_soft.shape[:-2] + out.shape[1:])


def decode_full(full: torch.Tensor, g: SubchGeometry) -> torch.Tensor:
    """Full-rate soft bits [..., 4*(nbits+6)] -> dispersed logical-frame
    bits [..., 24*bitrate] int32."""
    return prbs.disperse(viterbi.viterbi_decode(full, 24 * g.bitrate))


def decode_subchannel(subch_soft: torch.Tensor, g: SubchGeometry,
                      deinterleave: bool = True) -> torch.Tensor:
    """``subch_soft`` [..., T, length_cus*64] -> [..., T - 15, 24*bitrate]
    int32 logical-frame bits (output t is transmitted logical frame t).
    The front end is :func:`full_rate`: one kernel on a CUDA card under
    the int8 formats, else the chain, which casts float input by
    :func:`msc_soft` first (its callers cast the whole CIF block once
    and pass int8)."""
    if deinterleave:
        return decode_full(full_rate(subch_soft, g), g)
    lengths, pis = subch_profile(g.protection, g.bitrate, g.prot_level)
    return decode_full(puncture.depuncture_profile(msc_soft(subch_soft),
                                                   lengths, pis), g)


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """np.packbits on the device: (..., 8k) 0/1 -> (..., k) uint8, MSB
    first."""
    shifts = torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    x = bits.to(torch.int32).reshape(bits.shape[:-1] + (-1, 8))
    return (x << shifts).sum(dim=-1).to(torch.uint8)


def _bucket_bytes(full: torch.Tensor, g: SubchGeometry,
                  kernel: bool = False) -> torch.Tensor:
    """Full-rate soft bits [n_subch, T-15, 4*(nbits+6)] -> [n_subch,
    T-15, 3*bitrate] bit-packed logical frames (uint8).

    With ``kernel`` (one CUDA device, no mesh) under a K1 + K2 format the
    traceback stores the dispersed bytes itself
    (``viterbi_cuda.viterbi_traceback_packed_cuda``); otherwise (the CPU,
    the mesh, the word formats) torch ops disperse and pack the bits,
    ``pack_bits_u8(decode_full(...))``: the plain version."""
    if not kernel or viterbi_cuda.soft_format() in viterbi_cuda.WORD_FORMATS:
        return pack_bits_u8(decode_full(full, g))
    nbits = 24 * g.bitrate
    dec, _ = viterbi.viterbi_forward_words(full, nbits)
    out = viterbi_cuda.viterbi_traceback_packed_cuda(dec, nbits)
    return out.reshape(full.shape[:-1] + (nbits // 8,))


def _next_history(hist: torch.Tensor, cifs: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The last HISTORY CIFs of ``hist`` followed by ``cifs``, written
    into ``out`` (which may be ``hist``) or a new tensor, without the
    block: the last HISTORY of ``cifs``, or with fewer new CIFs the end
    of a small ``cat`` of the two."""
    n = cifs.shape[0]
    src = (cifs[n - HISTORY:] if n >= HISTORY
           else torch.cat([hist, cifs])[-HISTORY:])
    if out is None:
        return src.clone() if n >= HISTORY else src
    return out.copy_(src)


class EnsembleDecoder(nn.Module):
    """All-services MSC decoder over shape buckets.

    Holds the subchannels' CU start addresses as a device buffer, so
    every bucket's subchannels are read by it with no host sync, whatever
    the start addresses are.

    On one CUDA device (no mesh) under the int8 soft formats, each
    bucket's front end, from the CIF block to K1's input, is one launch
    of the front-end kernel (:mod:`dabjax_torch.msc.front_cuda`), which
    reads the history and the new CIFs where they lie.  Elsewhere (the
    CPU, a mesh, "f32") it is the torch chain: the history concatenated
    with the CIFs, one gather per bucket by the start buffer, then
    :func:`full_rate_torch`.  In :meth:`fused`, on one CUDA device under
    a K1 + K2 format, each bucket's back end is K1 and then K2 storing
    the dispersed logical-frame bytes itself; elsewhere (the CPU, a mesh,
    the word formats) the bits are dispersed and packed by torch ops.

    With ``mesh`` set (a :class:`dabjax_torch.parallel.mesh.Mesh` whose
    home is ``device``), each bucket's subchannel axis is padded to a
    multiple of the mesh size by repeating subchannel 0 and split over
    the mesh positions in mesh order; each part decodes on its own
    device and the results come home in order.  The per-subchannel math
    is unchanged, so the bits equal the single-device path's.

    On one CUDA device (no mesh), :meth:`fused` is a CUDA graph of this
    object's own (:class:`dabjax_torch.graphs.BlockGraph`), keyed by the
    soft format and the layouts of its inputs."""

    def __init__(self, geometries: Sequence[SubchGeometry], p: DabParams,
                 mesh=None, *, device):
        super().__init__()
        self.p = p
        self.mesh = mesh
        if mesh is not None and resolve(device) != resolve(mesh.home):
            raise ValueError(f"device {device} is not the mesh's home "
                             f"{mesh.home}")
        self.geoms = list(geometries)
        for g in self.geoms:
            if g.start_addr < 0 or (g.start_addr + g.length_cus) * CU_BITS \
                    > CIF_BITS:
                raise ValueError(f"subchannel {g.subch_id} lies outside the "
                                 f"CIF: CUs {g.start_addr} + {g.length_cus}")
        self._buckets: Dict[Tuple, List[SubchGeometry]] = {}
        for g in self.geoms:
            self._buckets.setdefault(g.shape_key, []).append(g)
        starts = [g.start_addr for geoms in self._buckets.values()
                  for g in geoms]
        self.register_buffer(
            "starts", torch.tensor(starts, dtype=torch.int64,
                                   device=device), persistent=False)
        self._graph = BlockGraph()
        self._hist = None     # the graph's CIF history, carried in place

    def _bucket_starts(self):
        """(first index into ``starts``, geometries) of each bucket."""
        off = 0
        for geoms in self._buckets.values():
            yield off, geoms
            off += len(geoms)

    def _kernel(self, device: torch.device) -> bool:
        return self.mesh is None and _front_kernel(device)

    def _full_rate(self, head: torch.Tensor, tail: Optional[torch.Tensor],
                   off: int, geoms: List[SubchGeometry]) -> torch.Tensor:
        """The bucket's full-rate int8 stream by the front-end kernel from
        the block whose rows are ``head``'s then ``tail``'s."""
        g = geoms[0]
        lengths, pis = subch_profile(g.protection, g.bitrate, g.prot_level)
        return front_cuda.msc_front(head, tail,
                                    self.starts[off: off + len(geoms)],
                                    g.length_cus * CU_BITS, lengths, pis)

    def _slices(self, soft: torch.Tensor, off: int,
                geoms: List[SubchGeometry]) -> torch.Tensor:
        """The bucket's subchannels of the CIF block ``soft`` [T, 55296]:
        [n, T, length_cus*64], one gather by the start buffer."""
        n_bits = geoms[0].length_cus * CU_BITS
        cols = torch.arange(n_bits, device=soft.device)
        idx = self.starts[off: off + len(geoms), None] * CU_BITS + cols
        slices = soft.index_select(1, idx.reshape(-1))
        return slices.reshape(soft.shape[0], len(geoms),
                              n_bits).transpose(0, 1)

    def _sharded(self, slices: torch.Tensor, fn) -> torch.Tensor:
        """``fn`` over the bucket's subchannels: on this device, or padded
        to a multiple of the mesh size (pad rows repeat subchannel 0, and
        the caller trims them) and split over the mesh positions."""
        if self.mesh is None:
            return fn(slices)
        pad = (-slices.shape[0]) % self.mesh.size
        if pad:
            slices = torch.cat([slices, slices[:1].expand(pad, -1, -1)])
        outs = []
        for part, dev in zip(torch.tensor_split(slices, self.mesh.size),
                             self.mesh.positions()):
            with on_device(dev):
                outs.append(fn(part.to(dev)))
        home = self.mesh.home
        return torch.cat([o.to(home) for o in outs])

    def _chain(self, soft: torch.Tensor, off: int,
               geoms: List[SubchGeometry], finish) -> torch.Tensor:
        """``finish(full_rate_torch(slices), g)`` over the bucket's slices
        of the cast block ``soft``, on this device or over the mesh."""
        g = geoms[0]
        return self._sharded(self._slices(soft, off, geoms),
                             lambda part: finish(full_rate_torch(part, g), g))

    def decode(self, cifs: torch.Tensor) -> Dict[int, np.ndarray]:
        """``cifs`` [T, 55296] consecutive CIFs (T > 15) ->
        {subch_id: [T-15, 24*bitrate] bits}."""
        out: Dict[int, np.ndarray] = {}
        kernel = self._kernel(cifs.device)
        soft = None if kernel else msc_soft(cifs)
        for off, geoms in self._bucket_starts():
            if kernel:
                bits = decode_full(self._full_rate(cifs, None, off, geoms),
                                   geoms[0])
            else:
                bits = self._chain(soft, off, geoms, decode_full)
            bits = bits.cpu().numpy()
            for i, g in enumerate(geoms):   # enumerate trims pad rows
                out[g.subch_id] = bits[i]
        return out

    def fused(self, hist: torch.Tensor, cifs: torch.Tensor,
              blob: torch.Tensor) -> Tuple:
        """The whole per-block MSC chain: per-bucket front end (the
        history read before the CIFs), decode and bit-pack (on this
        device, or split over the mesh), merge behind ``blob`` on this
        device.  Returns ``(merged_u8, new_hist, bucket_meta)`` with
        bucket_meta listing (geoms, output_shape) in merge order for the
        host-side split; on a mesh the shapes count the pad rows, which
        the split trims by enumerating the geometries.

        On one CUDA device the chain replays as this object's CUDA graph
        from its second call at a key on: ``merged_u8`` is the graph's
        buffer and ``new_hist`` the decoder's own history buffer, which
        the graph updates in place; both are valid until this object's
        next call.  Passing ``new_hist`` back costs nothing; another
        history is copied into the buffer first."""
        if self.mesh is not None or not self._graph.backend(cifs.device):
            return self._fused(hist, cifs, blob)
        key = (viterbi_cuda.soft_format(), tuple(hist.shape), hist.dtype,
               layout(cifs), layout(blob))
        if not self._graph.step(key, (cifs, blob)):
            return self._graph.eager(
                functools.partial(self._fused, hist, cifs, blob),
                cifs.device)
        if self._hist is None or (self._hist.shape, self._hist.dtype,
                                  self._hist.device) != (
                                      hist.shape, hist.dtype, hist.device):
            self._hist = torch.empty(hist.shape, dtype=hist.dtype,
                                     device=hist.device)
        if hist.data_ptr() != self._hist.data_ptr():
            self._hist.copy_(hist)
        merged, _, meta = self._graph.replay(
            functools.partial(self._fused, self._hist, cifs, blob,
                              self._hist), cifs.device)
        return merged, self._hist, meta

    def _fused(self, hist: torch.Tensor, cifs: torch.Tensor,
               blob: torch.Tensor, out_hist: Optional[torch.Tensor] = None
               ) -> Tuple:
        """:meth:`fused`'s chain, issued op by op; the new history goes
        into ``out_hist`` (which may be ``hist``) when it is given."""
        if self._kernel(cifs.device):
            packed = [_bucket_bytes(self._full_rate(hist, cifs, off, geoms),
                                    geoms[0], kernel=True)
                      for off, geoms in self._bucket_starts()]
            new_hist = _next_history(hist, cifs, out_hist)
        else:
            packed, new_hist = self._fused_chain(hist, cifs, out_hist)
        meta = [(geoms, tuple(p.shape))
                for (_, geoms), p in zip(self._bucket_starts(), packed)]
        return torch.cat([blob] + [p.reshape(-1) for p in packed]), \
            new_hist, meta

    def _fused_chain(self, hist: torch.Tensor, cifs: torch.Tensor,
                     out_hist: Optional[torch.Tensor] = None):
        """The torch chain's packed bytes of each bucket and the new
        history: the block concatenated, cast once (the history itself
        stays float), sliced by bucket."""
        block = torch.cat([hist, cifs], dim=0)
        soft = msc_soft(block)
        packed = [self._chain(soft, off, geoms, _bucket_bytes)
                  for off, geoms in self._bucket_starts()]
        new_hist = block[-HISTORY:]
        if out_hist is not None:
            new_hist = out_hist.copy_(new_hist)
        return packed, new_hist
