"""Band scan: hop a tunable source across DAB channels, report ensembles
(torch port of :mod:`dabjax.runtime.scan`, whose module imports jax
through its Receiver).

The loop drives any source exposing ``set_frequency`` (live SDRs,
rtl_tcp, or a :class:`~dabjax.io.sources.TunedSourceBank` standing in
for the tuner) and reuses one Receiver across hops: ``reset(source)``
clears the stream state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from dabjax.runtime.channels import frequency_khz
from dabjax.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import Receiver

__all__ = ["ScanResult", "band_scan"]


@dataclasses.dataclass
class ScanResult:
    channel: str
    frequency_khz: int
    synced: bool
    ensemble_label: str = ""
    ensemble_id: int = 0
    n_services: int = 0
    snr_db: float = 0.0


def band_scan(source, channels: Sequence[str],
              config: Optional[ReceiverConfig] = None,
              blocks: int = 3,
              on_result: Optional[Callable[[ScanResult], None]] = None,
              *, device) -> List[ScanResult]:
    """Sweep ``channels`` on a tunable ``source``.

    Per channel: tune, try to sync (the receiver's ``scan_attempts``
    no-signal loop), decode the FIC for ``blocks`` blocks, record what was
    found.  MSC decode stays off: the scan only needs the ensemble
    database."""
    cfg = config or ReceiverConfig()
    cfg = dataclasses.replace(cfg, decode_audio=False, decode_data=False,
                              service=None)
    rx = Receiver(source, cfg, device=device)
    results: List[ScanResult] = []
    try:
        for chan in channels:
            khz = frequency_khz(chan)
            if khz is None:
                raise ValueError(f"unknown DAB channel {chan!r}")
            source.set_frequency(khz * 1000)
            rx.reset(source)
            rx.run(blocks)
            n = len([s for s in rx.db.services.values() if s.has_label])
            res = ScanResult(
                channel=chan, frequency_khz=khz,
                synced=bool(rx.metrics.synced and rx.metrics.fic_crc_ok),
                ensemble_label=rx.db.ensemble_label,
                ensemble_id=rx.db.ensemble_id,
                n_services=n, snr_db=rx.metrics.snr_db)
            results.append(res)
            if on_result is not None:
                on_result(res)
    finally:
        rx.close()
    return results
