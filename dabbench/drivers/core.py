"""The decode core: the port's block graph (``BlockFn.frames`` and
``assemble``) and ``EnsembleDecoder.fused`` driven back to back on one
device-resident block, the CIF history carried from block to block.

The block is ``periods_per_block`` periods of the seed's loop, cut into
frame rows from each PRS on, uploaded once at set-up.  Each block's
merged blob is copied into pinned host memory, one block in flight
ahead of the copy being read; every blob read is compared with the
window's first, and that one with the reference after the window.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from dabbench.check import Checks, compare_taps, parse_blob
from dabbench.common import LayerContext, frame_s, geometries, reference_of
from dabbench.gen.constants import get_mode
from dabbench.gen.loop import PERIOD_CIFS, make_loop, period

__all__ = ["Driver"]


class Driver:
    def __init__(self, cfg: Dict, wl: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.dev = torch.device(device)
        self.spans = spans
        self.F = (period(get_mode(cfg["mode"])).frames
                  * wl["traffic"]["periods_per_block"])

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from dabjax_torch.constants import CIF_BITS, get_mode
        from dabjax_torch.fic.fic_decoder import (fic_codewords_per_frame,
                                                  fic_profile)
        from dabjax_torch.msc.deinterleave import HISTORY
        from dabjax_torch.msc.subchannel import EnsembleDecoder
        from dabjax_torch.ofdm.demod import min_frame_samples
        p = self.p = get_mode(self.cfg["mode"])
        self.need = min_frame_samples(p)
        self._inputs()
        self.decoder = EnsembleDecoder(geometries(self.cfg), p,
                                       device=self.dev)
        self.hist = torch.zeros((HISTORY, CIF_BITS), dtype=torch.float32,
                                device=self.dev)
        self.n_fib_cw = fic_codewords_per_frame(p)
        _, self.fic_bits, fibs_per_cw = fic_profile(p)
        self.n_fib = self.n_fib_cw * fibs_per_cw
        # two warm blocks: every shape built, the history primed
        for _ in range(2):
            merged, self.meta = self._block()
        self.nbytes = int(merged.shape[0])
        self.pinned = [torch.empty(self.nbytes, dtype=torch.uint8,
                                   pin_memory=self.dev.type == "cuda")
                       for _ in range(2)]
        self.events = [self._event() for _ in range(2)]
        merged.cpu()

    def block_rows(self, u8: np.ndarray) -> torch.Tensor:
        """A block's frame rows [F, need, 2] on the host: a loop's frames
        cut from each PRS on, the loop repeated ``periods_per_block``
        times."""
        p = self.p
        base = np.arange(period(p).frames) * p.T_F + p.T_null + p.T_g
        idx = torch.as_tensor(base[:, None] + np.arange(self.need)[None, :])
        rows = torch.as_tensor(u8)[idx]          # [period frames, need, 2]
        return rows.repeat(self.wl["traffic"]["periods_per_block"], 1, 1)

    def _inputs(self) -> None:
        """The seed's loop, and the block graph's inputs: the block's rows
        uploaded once, the coarse CFO, the port's ``BlockFn``."""
        from dabjax_torch.runtime.receiver import BlockFn
        self.loop = make_loop(self.cfg, self.seed)
        self.rows = self.block_rows(self.loop.u8).to(self.dev)
        self.coarse = torch.zeros(self.F, dtype=torch.float32,
                                  device=self.dev)
        self.block_fn = BlockFn(self.p, "u8", device=self.dev)

    def _event(self):
        return torch.cuda.Event() if self.dev.type == "cuda" else None

    def _blockgraph(self):
        """One block through the block graph: ``(cifs, blob)``."""
        shard = self.block_fn.frames(self.rows, self.coarse)
        return self.block_fn.assemble([shard], self.dev)

    def _block(self):
        with self.spans("blockgraph"):
            cifs, blob = self._blockgraph()
        with self.spans("msc"):
            merged, self.hist, meta = self.decoder.fused(self.hist, cifs,
                                                         blob)
        return merged, meta

    # ------------------------------------------------------------ window

    def _issue(self, k: int) -> None:
        with self.spans("block"):
            merged, _ = self._block()
            self.pinned[k % 2].copy_(merged, non_blocking=True)
            if self.events[k % 2] is not None:
                self.events[k % 2].record()

    def _read(self, k: int) -> None:
        if self.events[k % 2] is not None:
            self.events[k % 2].synchronize()
        got = self.pinned[k % 2].numpy()
        if k == 0:
            self.first = got.copy()
        elif not np.array_equal(got, self.first):
            self.differ += 1

    def window(self, seconds: float) -> None:
        self.differ = 0
        t0 = time.perf_counter()
        self._issue(0)
        k = 0
        while True:
            self._issue(k + 1)
            self._read(k)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._read(k)
        self.t_window = time.perf_counter() - t0
        self.blocks = k + 1

    # ----------------------------------------------------------- results

    def end_to_end(self) -> Dict[str, float]:
        return {"ensemble_rt": self.blocks * self.F * frame_s(self.cfg)
                / self.t_window}

    def layer_context(self, trace) -> LayerContext:
        cifs = self.F * self.p.cifs_per_frame
        codewords = {"fic": (self.F * self.n_fib_cw, self.fic_bits),
                     "msc": [(cifs, 24 * s["bitrate"])
                             for s in self.cfg["services"]]}
        return LayerContext(
            trace=trace, blocks=self.blocks, periods=self.blocks,
            signal_s=self.blocks * self.F * frame_s(self.cfg),
            program_spans={}, counters={}, cfg=self.cfg, wl=self.wl,
            shapes={"F": self.F, "need": int(self.need),
                    "T_u": self.p.T_u, "L": self.p.L, "K": self.p.K,
                    "cifs_per_frame": self.p.cifs_per_frame,
                    "cif_bits": 55296, "n_fib": self.n_fib,
                    "codewords": codewords})

    def release(self) -> None:
        """Free the port's device state before the reference runs."""
        del self.rows, self.block_fn, self.decoder, self.hist, self.coarse
        del self.pinned, self.events

    def check(self) -> Checks:
        p = self.p
        buckets = [([g.subch_id for g in geoms], shape)
                   for geoms, shape in self.meta]
        port = parse_blob(self.first, self.F, self.n_fib, p.T_u, p.K,
                          buckets)
        return judge(port, reference_of(self.loop, self.dev), p, self.F,
                     self.differ)

    def close(self) -> None:
        pass

    def attempted(self) -> int:
        return self.blocks

    def failed(self, checks: Checks) -> int:
        exact_bad = any(v > 0 for k, v in checks.values.items()
                        if k in ("frames_bad", "fibs_bad", "timing_bad"))
        return self.blocks - self.differ if exact_bad else self.differ


def judge(port: Dict, ref: Dict, p, F: int, differ: int,
          checks: Optional[Checks] = None) -> Checks:
    """A core block of ``F`` frames of mode ``p``: its blob against the
    reference's reading of the loop.  Frame f is loop frame f mod the
    mode's frames a period, logical frame t loop CIF t mod 120.  Into
    ``checks`` where given (counts add up, readings keep the worst)."""
    checks = Checks() if checks is None else checks
    checks.add("blocks_differ", differ)
    frames = np.arange(F) % period(p).frames
    per_frame = {k: ref[k][frames] for k in
                 ("snr", "fine", "coarse", "t_off", "t_ok", "fib", "fic_ok",
                  "spectra", "constel")}
    compare_taps(checks, port, per_frame)
    bad = 0
    for sid, want in ref["frames"].items():
        got = port["frames"].get(sid)
        if got is None:
            bad += p.cifs_per_frame * F
            continue
        exp = want[np.arange(got.shape[0]) % PERIOD_CIFS]
        bad += int(np.sum(np.any(got != exp, axis=-1)))
    checks.add("frames_bad", bad)
    return checks
