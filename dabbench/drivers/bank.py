"""A ``MultiReceiver`` channel bank driven by ``step()``, closed loop:
one block period in flight, the bank's one device-to-host copy a period.

Channel ``c`` plays loop ``c % loops`` (each loop rendered from the seed
with a salt of its own) from a loop frame of its own drawn from the
seed, so the channels' payloads and blocks do not line up.  Audio is off and
data on: every logical frame of every channel is routed to the
harness's recording handlers.  The window's signal seconds, summed over
the channels, over its wall time is ``bank_rt``.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from dabbench.check import Checks, compare_frames
from dabbench.common import (LayerContext, LoopSource, Recorder, Tap,
                             check_receiver, frame_s, locked, packed,
                             reference_of, sample_blocks, traced_profiler)
from dabbench.gen.loop import make_loop, rng_for, start_offset

__all__ = ["Driver"]


class Driver:
    def __init__(self, cfg: Dict, wl: Dict, seed: int, device, spans):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.tr = wl["traffic"]
        self.dev = torch.device(device)
        self.spans = spans
        self.F = self.tr["frames_per_block"]
        self.n = self.tr["channels"]

    def setup(self) -> None:
        from dabjax_torch.parallel.multihost import MultiReceiver
        from dabjax_torch.runtime.config import ReceiverConfig
        self.loops = [make_loop(self.cfg, self.seed, salt)
                      for salt in range(self.tr["loops"])]
        names = [f"ch{c}" for c in range(self.n)]
        sources = {name: LoopSource(self.loops[c % len(self.loops)].u8,
                                    start_offset(self.cfg, self.seed, c))
                   for c, name in enumerate(names)}
        rc = ReceiverConfig(frames_per_block=self.F, decode_audio=False,
                            decode_data=True)
        self.bank = MultiReceiver(sources, rc, device=self.dev)
        self.recs, self.taps = {}, {}
        for name, rx in self.bank.rx.items():
            self.recs[name] = Recorder()
            rx.data_handler_factory = self.recs[name].factory
            self.taps[name] = Tap(rx)
        n = len(self.cfg["services"])
        for _ in range(self.tr["max_lock_blocks"]):
            self.bank.step()
            if all(locked(rx, n) for rx in self.bank.rx.values()):
                break
        for _ in range(self.tr["warm_blocks"]):
            self.bank.step()
        for rx in self.bank.rx.values():
            traced_profiler(rx, self.spans)
        pull = self.bank._pull

        def _pull(blob):
            with self.spans("pull"):
                return pull(blob)

        self.bank._pull = _pull
        self.sample = sample_blocks(self.seed, self.tr["sample_span"],
                                    self.tr["samples"])
        # the channels whose blocks the sampled periods keep
        rng = rng_for(self.seed, 6)
        self.kept_channels = {names[int(i)] for i in rng.choice(
            self.n, size=min(self.tr["sample_channels"], self.n),
            replace=False)}

    def window(self, seconds: float) -> None:
        for rx in self.bank.rx.values():
            rx.profiler.stages.clear()
        t0 = time.perf_counter()
        k = 0
        while True:
            keep = k in self.sample
            for name in self.bank.rx:
                self.recs[name].keep = keep
                self.taps[name].keep = keep and name in self.kept_channels
            progressed = self.bank.step()
            if not all(progressed.values()):
                raise RuntimeError("a loop source ran dry")
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        for name in self.bank.rx:
            self.recs[name].keep = self.taps[name].keep = False
        self.t_window = time.perf_counter() - t0
        self.periods = k
        self.stages = {}
        for rx in self.bank.rx.values():
            for name, st in rx.profiler.stages.items():
                self.stages[name] = self.stages.get(name, 0.0) + st.seconds

    # ----------------------------------------------------------- results

    def end_to_end(self) -> Dict[str, float]:
        return {"bank_rt": self.periods * self.n * self.F
                * frame_s(self.cfg) / self.t_window}

    def layer_context(self, trace) -> LayerContext:
        return LayerContext(
            trace=trace, blocks=self.periods * self.n, periods=self.periods,
            signal_s=self.periods * self.n * self.F * frame_s(self.cfg),
            program_spans=self.stages, counters={}, cfg=self.cfg,
            wl=self.wl, shapes={"F": self.F, "channels": self.n})

    def release(self) -> None:
        pass

    def check(self) -> Checks:
        checks = Checks()
        refs = [reference_of(loop, self.dev)["frames"]
                for loop in self.loops]
        for c, (name, rx) in enumerate(self.bank.rx.items()):
            check_receiver(checks, rx, self.taps[name], self.cfg, self.dev)
            rec, tap = self.recs[name], self.taps[name]
            compare_frames(checks, packed(rec.kept),
                           refs[c % len(self.loops)])
            checks.add("frames_missing", sum(
                tap.routed[s] - rec.count.get(s, 0) for s in tap.routed)
                + len(self.cfg["services"]) - len(tap.routed))
        return checks

    def close(self) -> None:
        self.bank.close()

    def attempted(self) -> int:
        return self.periods * self.n

    def failed(self, checks: Checks) -> int:
        exact = ("frames_bad", "frames_missing", "fibs_bad", "fic_crc_bad",
                 "db_bad", "sync_bad")
        bad = sum(checks.values.get(k, 0) > 0 for k in exact)
        return self.periods * self.n if bad else 0
