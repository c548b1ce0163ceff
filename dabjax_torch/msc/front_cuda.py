"""ctypes wrapper over the MSC front-end kernel (``csrc/msc_front.cu``).

One launch takes a shape bucket's subchannels from the CIF block to K1's
input: it reads the block's rows where they lie (the decoder's float32
history, then the new CIFs, with no ``cat``), each subchannel's columns
by a device buffer of start addresses, applies the 16 time de-interleave
delays (:data:`dabjax_torch.msc.deinterleave.DELAYS`), the depuncture
map of the bucket's profile and ``viterbi_cuda.to_int8``'s saturating
cast, and stores the full-rate int8 stream ``[n, T - 15, 4 * (nbits +
6)]``, which is ``step_soft``'s ``[B, nbits + 6, 4]`` (and, nbits being
even in the MSC, ``pair_soft``'s ``[B, T2, 8]``) as it is.  Its plain
version is the torch chain, ``subchannel.full_rate_torch``; the two are
equal byte for byte.

The depuncture map is a host table per profile (:func:`front_table`):
the codeword cut into chunks of at most ``THREADS * WORDS`` words, each
drawing on one run of at most ``MAX_WIDTH`` transmitted columns, and for
each output position the row (after the frame's first) and the column
it reads, or a zero.  :func:`front_np` applies it as the kernel does, in
numpy.  The device copy is cached per profile and device; the first call
(a graph's eager warm-up) makes it, never a capture.

The wrapper takes CUDA tensors only and raises on anything else, on a
failed build and on a failed launch; there is no fallback.  It launches
through ``_build.launch``, which counts each launch in
``_build.LAUNCHES["msc_front"]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dabjax_torch import _build
from dabjax_torch.fec import puncture
from dabjax_torch.msc.deinterleave import DELAYS, HISTORY

__all__ = ["ENTRIES", "FrontTable", "front_table", "sources", "front_np",
           "msc_front"]

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entry launched here: its arguments' ctypes types before the
#: stream (``_build.launch``)
ENTRIES = {"dabjax_msc_front": (_vp, _vp, _i, _i, _i, _ll, _vp, _i, _vp, _vp,
                                _i, _i, _i, _i, _vp)}

#: the kernel's threads a block and output words a thread (csrc kThreads,
#: kWords): a chunk of the codeword has at most THREADS * WORDS words
THREADS, WORDS = 128, 1
#: a chunk's run of transmitted columns, at most (csrc kMaxWidth)
MAX_WIDTH = 512
#: chunk runs start and end on multiples of ALIGN columns: 16 bytes of
#: int8, the unit of the kernel's copies
ALIGN = 16


@dataclasses.dataclass(frozen=True)
class FrontTable:
    """A profile's depuncture map in the kernel's form.

    ``chunks`` int32 [C, 2]: chunk c's first transmitted column and its
    run of columns (multiples of :data:`ALIGN`, at most ``width``);
    ``codes`` int32 [C * chunk_words * 4]: for output position j, -1
    where j is punctured (or past ``out_len``), else ``(d << 16) |
    column``, the column counted from its chunk's first and ``d`` the row
    after the frame's first (``HISTORY - DELAYS[i % 16]`` for
    transmitted bit i)."""
    n_tx: int
    out_len: int
    chunk_words: int
    width: int
    chunks: np.ndarray
    codes: np.ndarray


def sources(lengths: Sequence[int], pis: Sequence[int]
            ) -> Tuple[np.ndarray, np.ndarray]:
    """``(rows, cols)`` int64 [4 * (nbits + 6)]: the row after the output
    frame's first and the transmitted column each full-rate position
    reads, col -1 (row 0) where it is punctured."""
    mask = puncture.puncture_mask(lengths, pis)
    cols = np.full(mask.shape[0], -1, np.int64)
    cols[mask] = np.arange(int(mask.sum()))
    rows = np.where(cols >= 0, HISTORY - DELAYS[cols % 16], 0)
    return rows.astype(np.int64), cols


@functools.lru_cache(maxsize=None)
def front_table(lengths: Tuple[int, ...], pis: Tuple[int, ...]
                ) -> FrontTable:
    """The kernel's table of a profile: the codeword in the fewest
    chunks of at most ``THREADS * WORDS`` words whose runs of columns are
    at most :data:`MAX_WIDTH` wide."""
    rows, cols = sources(lengths, pis)
    out_len = cols.shape[0]
    n_words = out_len // 4
    n = -(-n_words // (THREADS * WORDS))
    while True:
        chunk_words = -(-n_words // n)
        runs = []
        for c in range(n):
            part = cols[4 * c * chunk_words: 4 * (c + 1) * chunk_words]
            used = part[part >= 0]
            if used.size == 0:
                runs.append((0, 0))
                continue
            lo = int(used[0]) // ALIGN * ALIGN
            hi = -(-(int(used[-1]) + 1) // ALIGN) * ALIGN
            runs.append((lo, hi - lo))
        width = max(w for _, w in runs)
        if width <= MAX_WIDTH:
            break
        n += 1
    codes = np.full(n * chunk_words * 4, -1, np.int64)
    for c, (lo, _) in enumerate(runs):
        j = np.arange(4 * c * chunk_words,
                      min(4 * (c + 1) * chunk_words, out_len))
        keep = cols[j] >= 0
        codes[j[keep]] = (rows[j[keep]] << 16) | (cols[j[keep]] - lo)
    return FrontTable(n_tx=int((cols >= 0).sum()), out_len=out_len,
                      chunk_words=chunk_words, width=max(width, ALIGN),
                      chunks=np.array(runs, np.int32).reshape(n, 2),
                      codes=codes.astype(np.int32))


def front_np(block: np.ndarray, starts: Sequence[int], table: FrontTable
             ) -> np.ndarray:
    """The kernel in numpy, chunk by chunk from ``table``: ``block``
    [T, columns] soft values (float or int8), subchannel b's bit i at
    column 64 starts[b] + i -> int8 [n, T - 15, out_len]."""
    T = block.shape[0]
    if block.dtype == np.int8:
        soft = block
    else:
        with np.errstate(invalid="ignore"):
            soft = np.nan_to_num(np.trunc(np.clip(block, -127, 127)),
                                 nan=0.0).astype(np.int8)
    t = np.arange(T - HISTORY)[:, None]
    out = np.zeros((len(starts), T - HISTORY, table.out_len), np.int8)
    for c, (lo, _) in enumerate(table.chunks):
        j0 = 4 * c * table.chunk_words
        j = np.arange(j0, min(j0 + 4 * table.chunk_words, table.out_len))
        code = table.codes[j]
        keep = code >= 0
        d, col = code[keep] >> 16, (code[keep] & 0xFFFF) + lo
        for b, s in enumerate(starts):
            out[b][:, j[keep]] = soft[t + d, 64 * s + col]
    return out


@functools.lru_cache(maxsize=None)
def _device_table(lengths: Tuple[int, ...], pis: Tuple[int, ...],
                  device: torch.device):
    table = front_table(lengths, pis)
    return (table, torch.from_numpy(table.chunks).to(device),
            torch.from_numpy(table.codes).to(device))


def _rows(t: torch.Tensor, name: str) -> int:
    """Check a tensor of rows for the kernel: its row stride."""
    if not t.is_cuda:
        raise ValueError(f"msc_front: {name}: CUDA tensor required, got "
                         f"{t.device}")
    if t.dtype not in (torch.float32, torch.int8) or t.dim() != 2 \
            or t.stride(1) != 1:
        raise ValueError(f"msc_front: {name}: need float32 or int8 rows "
                         f"[rows, columns] with unit column stride, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    if (t.stride(0) * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"msc_front: {name}: rows must start on 16 bytes "
                         f"(row stride {t.stride(0)}, address "
                         f"{t.data_ptr()})")
    return t.stride(0)


def msc_front(head: torch.Tensor, tail: Optional[torch.Tensor],
              starts: torch.Tensor, n_cols: int, lengths: Sequence[int],
              pis: Sequence[int]) -> torch.Tensor:
    """The bucket's full-rate int8 stream [n, H + N - 15, 4 * (nbits + 6)]
    from the block whose rows are ``head``'s [H, ...] then ``tail``'s
    [N, ...] (None: no rows), each subchannel's ``n_cols`` columns from
    column ``64 * starts[b]`` (``starts`` int64 [n] on the same card).
    Equal to ``full_rate_torch`` over the concatenated block's slices."""
    ld = _rows(head, "head")
    N = 0
    if tail is not None:
        if _rows(tail, "tail") != ld or tail.dtype != head.dtype \
                or tail.device != head.device:
            raise ValueError("msc_front: tail must match head's dtype, "
                             "device and row stride")
        N = tail.shape[0]
    if (starts.device != head.device or starts.dtype != torch.int64
            or starts.dim() != 1 or not starts.is_contiguous()):
        raise ValueError(f"msc_front: starts: need contiguous int64 [n] on "
                         f"{head.device}, got {starts.dtype} "
                         f"{tuple(starts.shape)} on {starts.device}")
    table, chunks, codes = _device_table(tuple(lengths), tuple(pis),
                                         head.device)
    if n_cols < table.n_tx or n_cols % ALIGN:
        raise ValueError(f"msc_front: {n_cols} columns a subchannel do not "
                         f"hold the profile's {table.n_tx} soft bits in "
                         f"runs of {ALIGN}")
    H, n = head.shape[0], starts.shape[0]
    T_out = H + N - HISTORY
    out = torch.empty((n, max(T_out, 0), table.out_len), dtype=torch.int8,
                      device=head.device)
    if n == 0 or T_out <= 0:
        return out
    _build.launch("msc_front", ENTRIES, "dabjax_msc_front", head.device,
                  head.data_ptr(), (head if tail is None else tail).data_ptr(),
                  head.dtype == torch.int8, H, N, ld, starts.data_ptr(), n,
                  chunks.data_ptr(), codes.data_ptr(), chunks.shape[0],
                  table.chunk_words, table.width, table.out_len,
                  out.data_ptr())
    return out
