"""One ``Receiver`` driven by ``step()`` over the seed's loop, closed
loop: the next block is handed over when the last one is done.

Two traffic mixes use it:

* ``live``: audio off, data on, every logical frame routed to the
  harness's recording handlers; each block's wall time, from
  ``Receiver.step()`` to its frames on the host, is one latency sample
  (``block_p95_ms``).
* ``audio``: every service decoded to PCM in ``audio_workers`` spawned
  processes; the window's signal seconds over the wall time from its
  start until the audio of its blocks is drained (``receiver_rt``).
  Closed loop on the audio too: the pool is drained every
  ``drain_every`` blocks, so staging runs at most that far ahead of the
  decoders, and the window closes at the first drain past
  ``--seconds``.

Set-up steps the receiver until it has locked, read the whole ensemble
and decodes every subchannel with a full history, then ``warm_blocks``
more.  A few blocks drawn from the seed keep their rows, their taps and
their frames for the comparison after the window.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from dabbench.check import Checks, compare_frames
from dabbench.common import (LayerContext, LoopSource, Recorder, Tap,
                             check_receiver, frame_s, locked, packed,
                             reference_of, sample_blocks, traced_profiler)
from dabbench.gen.loop import make_loop, start_offset

__all__ = ["Driver"]


class Driver:
    def __init__(self, cfg: Dict, wl: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.tr = wl["traffic"]
        self.dev = torch.device(device)
        self.spans = spans
        self.F = self.tr["frames_per_block"]
        self.audio = bool(self.tr["decode_audio"])

    def setup(self) -> None:
        from dabjax_torch.runtime.config import ReceiverConfig
        from dabjax_torch.runtime.receiver import Receiver
        self.loop = make_loop(self.cfg, self.seed)
        offset = start_offset(self.cfg, self.seed, 0)
        self.rec = Recorder()
        rc = ReceiverConfig(frames_per_block=self.F,
                            decode_audio=self.audio, decode_data=True,
                            audio_workers=self.tr["audio_workers"])
        self.rx = Receiver(LoopSource(self.loop.u8, offset), rc,
                           data_handler_factory=self.rec.factory,
                           device=self.dev)
        self.tap = Tap(self.rx)
        n = len(self.cfg["services"])
        for _ in range(self.tr["max_lock_blocks"]):
            self.rx.step()
            if locked(self.rx, n):
                break
        for _ in range(self.tr["warm_blocks"]):
            self.rx.step()
        if self.audio:
            self.rx.drain_pool()
            self.audio0 = self._audio_counters()
        self.routed0 = dict(self.tap.routed)
        traced_profiler(self.rx, self.spans)
        self.sample = sample_blocks(self.seed, self.tr["sample_span"],
                                    self.tr["samples"])

    def _audio_counters(self) -> Dict[str, float]:
        m = self.rx.metrics
        return {k: getattr(m, k) for k in
                ("au_ok", "au_bad", "superframes_ok", "superframes_bad",
                 "rs_corrected", "mp2_frames_ok", "mp2_frames_bad",
                 "audio_decode_seconds")}

    def window(self, seconds: float) -> None:
        rx = self.rx
        rx.profiler.stages.clear()
        lat = []
        t0 = time.perf_counter()
        k = 0
        while True:
            keep = k in self.sample
            self.tap.keep = self.rec.keep = keep
            t = time.perf_counter()
            if not rx.step():
                raise RuntimeError("the loop source ran dry")
            lat.append(time.perf_counter() - t)
            k += 1
            if self.audio and k % self.tr["drain_every"]:
                continue
            if self.audio:
                rx.drain_pool()
            if time.perf_counter() - t0 >= seconds:
                break
        self.tap.keep = self.rec.keep = False
        self.t_window = time.perf_counter() - t0
        self.lat = np.array(lat)
        self.blocks = k
        self.stages = {n: s.seconds for n, s in rx.profiler.stages.items()}

    # ----------------------------------------------------------- results

    def end_to_end(self) -> Dict[str, float]:
        signal = self.blocks * self.F * frame_s(self.cfg)
        return {"block_p95_ms": float(np.percentile(self.lat, 95)) * 1e3,
                "receiver_rt": signal / self.t_window}

    def layer_context(self, trace) -> LayerContext:
        counters = {}
        if self.audio:
            now = self._audio_counters()
            counters = {k: now[k] - self.audio0[k] for k in now}
        return LayerContext(
            trace=trace, blocks=self.blocks, periods=self.blocks,
            signal_s=self.blocks * self.F * frame_s(self.cfg),
            program_spans=self.stages, counters=counters, cfg=self.cfg,
            wl=self.wl, shapes={"F": self.F})

    def release(self) -> None:
        pass

    def check(self) -> Checks:
        checks = Checks()
        check_receiver(checks, self.rx, self.tap, self.cfg, self.dev)
        if self.audio:
            self._check_audio(checks)
        else:
            ref = reference_of(self.loop, self.dev)
            compare_frames(checks, packed(self.rec.kept), ref["frames"])
            checks.add("frames_missing", sum(
                self.tap.routed[s] - self.rec.count.get(s, 0)
                for s in self.tap.routed)
                + len(self.cfg["services"]) - len(self.tap.routed))
        return checks

    def _check_audio(self, checks: Checks) -> None:
        """Over the window (the decoders synced during set-up): every AU
        and MP2 frame good, no RS correction, and as many as the frames
        routed to each service carry: a DAB+ superframe is 5 logical
        frames of 3 AUs, an MP2 frame one logical frame, less the one
        superframe (frame) the window's edges may cut."""
        now = self._audio_counters()
        d = {k: now[k] - self.audio0[k] for k in now}
        for k in ("au_ok", "superframes_ok", "mp2_frames_ok"):
            checks.add_info(k, d[k])
        checks.add("audio_bad", d["au_bad"] + d["superframes_bad"]
                   + d["mp2_frames_bad"] + d["rs_corrected"])
        want_au = want_mp2 = 0
        for s in self.cfg["services"]:
            n = self.tap.routed.get(s["subch"], 0) \
                - self.routed0.get(s["subch"], 0)
            checks.add_info("frames_routed", n)
            if s["kind"] == "DAB+":
                want_au += 3 * max(0, n // 5 - 1)
            else:
                want_mp2 += max(0, n - 1)
        checks.add("audio_missing", max(0, want_au - d["au_ok"])
                   + max(0, want_mp2 - d["mp2_frames_ok"]))

    def close(self) -> None:
        self.rx.close()

    def attempted(self) -> int:
        return self.blocks

    def failed(self, checks: Checks) -> int:
        exact = ("frames_bad", "frames_missing", "fibs_bad", "fic_crc_bad",
                 "audio_bad", "audio_missing", "db_bad", "sync_bad")
        bad = sum(checks.values.get(k, 0) > 0 for k in exact)
        return self.blocks if bad else 0
