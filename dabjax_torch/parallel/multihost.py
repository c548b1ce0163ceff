"""Channel bank and multi-process channel sharding (torch port of
:mod:`dabjax.parallel.multihost`).

Channels (ensembles) are independent RF, so a deployment decodes many of
them concurrently: one process per host owns a round-robin share of the
channels (:func:`assign_channels`), and one
host drives its share as a :class:`MultiReceiver` bank, whose channels
share a single device-to-host copy per block period.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dabjax_torch.runtime.profiling import StageProfiler
from dabjax_torch.runtime.receiver import Receiver

__all__ = ["init_distributed", "assign_channels", "run_channels",
           "MultiReceiver"]


class MultiReceiver:
    """Channel bank: k full receivers driven in lock-step with exactly one
    device-to-host copy per block period for the whole bank.

    Every channel's staged device blob (demod and FIC taps, FIB payloads,
    bit-packed MSC frames) is joined on the device and pulled at once;
    host parsing and audio then run per channel (audio on each receiver's
    worker threads or on a shared process pool).

    A period that stages a channel is timed by ``self.profiler`` in the
    bank's spans of :data:`dabjax_torch.runtime.profiling.SPANS`, one of
    each: ``bank_stage`` (items: channels staged), ``bank_pull`` (items:
    bytes pulled) and ``bank_consume``; each channel's receiver times its
    own spans inside them.  ``step()`` numbers its periods: while a
    profiler records spans, the bank's carry the period's number and the
    owner ``"bank"``."""

    def __init__(self, sources: Dict[str, object], config=None,
                 data_handler_factory=None, *, device):
        """``config``: one ReceiverConfig for every channel, or a
        {channel: ReceiverConfig} dict (e.g. a scan bank tuning one
        service per ensemble)."""
        cfg_of = (config.get if isinstance(config, dict)
                  else (lambda name: config))
        self._pool = None
        workers = max((getattr(cfg_of(n), "audio_workers", 0) or 0)
                      for n in sources) if sources else 0
        if workers > 0:
            from dabjax_torch.runtime.audio_pool import AudioWorkerPool
            self._pool = AudioWorkerPool(workers)
        self.rx: Dict[str, Receiver] = {
            name: Receiver(src, cfg_of(name),
                           data_handler_factory=data_handler_factory,
                           audio_pool=self._pool, device=device)
            for name, src in sources.items()}
        self.profiler = StageProfiler(owner="bank")
        self._periods = itertools.count()

    def _pull(self, bank: torch.Tensor) -> np.ndarray:
        """The bank's one device-to-host copy of a block period."""
        return bank.cpu().numpy()

    def step(self) -> Dict[str, bool]:
        """Stage every live channel, pull the joined bank blob once, then
        consume per channel.  Returns {channel: progressed}."""
        prof = self.profiler
        prof.block = next(self._periods)
        blks = {}
        with prof.stage("bank_stage") as span:
            for name, rx in self.rx.items():
                blk = rx.stage()
                if blk is not None:
                    blks[name] = blk
            span.items = len(blks)
            if not blks:
                span.drop()
        if not blks:
            return {name: False for name in self.rx}
        with prof.stage("bank_pull") as span:
            big = self._pull(torch.cat([b.merged for b in blks.values()]))
            span.items = big.nbytes
        with prof.stage("bank_consume"):
            off = 0
            for name, b in blks.items():
                n = int(b.merged.shape[0])
                self.rx[name].consume(b, big[off: off + n])
                off += n
        return {name: (name in blks) for name in self.rx}

    def run(self, n_blocks: int) -> Dict[str, object]:
        live = set(self.rx)
        for _ in range(n_blocks):
            if not live:
                break
            progressed = self.step()
            live = {n for n in live if progressed.get(n)}
        for rx in self.rx.values():
            rx._drain_audio()
        if self._pool is not None:
            counters = self._pool.drain()
            for rx in self.rx.values():
                rx.merge_pool_counters(counters)
        return {name: rx.metrics for name, rx in self.rx.items()}

    def close(self) -> None:
        for rx in self.rx.values():
            rx.close()
        if self._pool is not None:
            self._pool.close()
            self._pool = None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0) -> None:
    """Join the ``torch.distributed`` process group of a multi-process
    run (``coordinator`` is ``host:port`` of process 0); a no-op for a
    single process (the common one-host case)."""
    if num_processes <= 1 or coordinator is None:
        return
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)


def assign_channels(channels: Sequence[str], num_processes: int,
                    process_id: int) -> List[str]:
    """Round-robin channel -> process assignment (deterministic on every
    host, no coordination needed)."""
    return [c for i, c in enumerate(sorted(channels))
            if i % num_processes == process_id]


def run_channels(sources: Dict[str, Callable[[], object]],
                 n_blocks: int = 8,
                 coordinator: Optional[str] = None,
                 num_processes: int = 1, process_id: int = 0,
                 receiver_config=None, *, device) -> Dict[str, object]:
    """Decode this process's share of ``sources`` ({channel: source
    factory}) on ``device``; returns {channel: Metrics} for the channels
    it owns.  Factories (not live sources) are passed so only owned
    channels open hardware.  Two or more owned channels run as one
    :class:`MultiReceiver` bank; one runs as a lone receiver."""
    init_distributed(coordinator, num_processes, process_id)
    mine = assign_channels(list(sources), num_processes, process_id)
    if len(mine) > 1:
        bank = MultiReceiver({chan: sources[chan]() for chan in mine},
                             receiver_config, device=device)
        try:
            return bank.run(n_blocks)
        finally:
            bank.close()
    out = {}
    for chan in mine:
        rx = Receiver(sources[chan](), receiver_config, device=device)
        try:
            out[chan] = rx.run(n_blocks)
        finally:
            rx.close()
    return out
