"""A ``MultiReceiver`` channel bank as a live monitor: the bank driver's
channels, loops, recording and checks, with each ``bank.step()`` timed.

Closed loop: one bank period after another.  A period (every channel's
``stage()``, the blobs joined and pulled in one copy, every channel's
``consume()`` to its frames routed) is one latency sample
(``block_p95_ms``), but for the periods whose outputs are kept for the
comparison: those also run the harness's recording (every channel's
frames kept, the kept channels' rows and blobs copied), which takes them
to the top of the window's periods, so they are checked and not timed.
The window runs past ``seconds`` until it has timed a period.

The bank's own spans (``bank_stage``, ``bank_pull``, ``bank_consume``)
and their counters (channels staged, bytes pulled) are read from its
``profiler``; a bank that keeps none reports no span and no counter,
and its periods are timed all the same.

The configuration names the deployment's channel count (``channels``);
the traffic runs that many channels.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from dabbench.common import LayerContext, frame_s
from dabbench.drivers import bank

__all__ = ["Driver"]

#: the bank's spans, and the counter each span's items give
BANK_SPANS = ("bank_stage", "bank_pull", "bank_consume")
COUNTERS = {"bank_stage": "channels_staged", "bank_pull": "bytes_pulled"}


class Driver(bank.Driver):
    def setup(self) -> None:
        if self.cfg.get("channels", self.n) != self.n:
            raise ValueError(f"the configuration names "
                             f"{self.cfg['channels']} channels, the "
                             f"traffic {self.n}")
        super().setup()

    def window(self, seconds: float) -> None:
        prof = getattr(self.bank, "profiler", None)
        for rx in self.bank.rx.values():
            rx.profiler.stages.clear()
        if prof is not None:
            prof.stages.clear()
        lat = []
        t0 = time.perf_counter()
        k = 0
        while True:
            keep = k in self.sample
            for name in self.bank.rx:
                self.recs[name].keep = keep
                self.taps[name].keep = keep and name in self.kept_channels
            t = time.perf_counter()
            progressed = self.bank.step()
            if not keep:
                lat.append(time.perf_counter() - t)
            if not all(progressed.values()):
                raise RuntimeError("a loop source ran dry")
            k += 1
            if time.perf_counter() - t0 >= seconds and lat:
                break
        for name in self.bank.rx:
            self.recs[name].keep = self.taps[name].keep = False
        self.t_window = time.perf_counter() - t0
        self.lat = np.array(lat)
        self.periods = k
        self.stages, self.counters = {}, {}
        for rx in self.bank.rx.values():
            for name, st in rx.profiler.stages.items():
                self.stages[name] = self.stages.get(name, 0.0) + st.seconds
        if prof is not None:
            for name in BANK_SPANS:
                st = prof.stages.get(name)
                if st is None:
                    continue
                self.stages[name] = st.seconds
                if name in COUNTERS:
                    self.counters[COUNTERS[name]] = st.items

    # ----------------------------------------------------------- results

    def end_to_end(self) -> Dict[str, float]:
        return {"block_p95_ms": float(np.percentile(self.lat, 95)) * 1e3}

    def layer_context(self, trace) -> LayerContext:
        return LayerContext(
            trace=trace, blocks=self.periods * self.n, periods=self.periods,
            signal_s=self.periods * self.n * self.F * frame_s(self.cfg),
            program_spans=self.stages, counters=self.counters, cfg=self.cfg,
            wl=self.wl, shapes={"F": self.F, "channels": self.n})
