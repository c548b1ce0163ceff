"""Hopper probes: the TPU measurement harnesses of ``tools/`` on the card.

Each module mirrors a probe of ``tools/`` by name and measures on one
CUDA card what that probe measured on the TPU, with a hand-written
kernel (``dabjax_torch/csrc/probes.cu``, ``chains.cu`` or ``dots.cu``,
or the production kernel the probe launched) beside its plain torch
version.  They answer questions about the Viterbi kernels' costs (what
each stage of a pair step costs, what the prep before the kernel costs,
what a streaming copy and a decision-plane store reach, what a per-step
int8 decision plane costs against packed words, what one elementwise op
costs by dtype, what a small-K matrix product costs in a loop); none of
them is on the receiver's path.

Run one on a card as ``python -m dabjax_torch.tools.<name>``: it prints
one line per case (ms, and Mb/s or GB/s) and exits non-zero when there is
no card.  Times are CUDA events around repeated launches after a
warm-up: :func:`cuda_ms` for calls that keep the device busy longer
than the host takes to issue them, :func:`device_ms` for short ones
(under about 50 us a call), whose back-to-back calls :func:`cuda_ms`
would time at the host's issue rate (about 30 us a call through a
wrapper on an H100 host).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

#: the main-path MSC shape: 12 subchannels x 369 logical frames of a
#: 96-frame batch, 2304 bits each (96 kbit/s)
CODEWORDS = 12 * 369
NBITS = 24 * 96


def soft_bits(codewords: int = CODEWORDS, nbits: int = NBITS,
              seed: int = 0) -> np.ndarray:
    """Integer soft bits in [-127, 127], float32 [codewords,
    4 * (nbits + 6)], from ``seed`` (the TPU probes' input)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, size=(codewords, 4 * (nbits + 6)),
                        dtype=np.int8).astype(np.float32)


def have_card(name: str) -> bool:
    """True when a CUDA card is present; else says so on stderr."""
    if torch.cuda.is_available():
        return True
    print(f"{name}: no CUDA card (torch.cuda.is_available() is false); "
          "the probes measure the card only", file=sys.stderr)
    return False


def _host_counts() -> tuple:
    return (sum(s["collections"] for s in gc.get_stats()),
            torch.cuda.memory_stats().get("segment.all.allocated", 0))


def cuda_ms(fn, reps: int, host: dict | None = None) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events, after one
    warm-up call.  A ``host`` dict gets what the host did meanwhile:
    ``issue_ms``, its wall ms from the start event's record to the end
    event's (where it comes near ``reps`` times the reading, the device
    waited on the host), ``gc``, the garbage collections run, and
    ``mallocs``, the device segments the caching allocator took."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    before = _host_counts() if host is not None else None
    t = time.perf_counter()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    issue = time.perf_counter() - t
    torch.cuda.synchronize()
    if host is not None:
        gcs, mallocs = (a - b for a, b in zip(_host_counts(), before))
        host.update(issue_ms=issue * 1e3, gc=gcs, mallocs=mallocs)
    return t0.elapsed_time(t1) / reps


def interleaved_ms(fns: dict, runs: int, reps: int = 10,
                   timer=cuda_ms) -> dict:
    """{name: {median, min, max}} ms of each ``fns[name]()`` over ``runs``
    runs of ``reps`` calls (each run timed by ``timer``, :func:`cuda_ms`
    or :func:`device_ms`), the runs taken in turns (a, b, b, a, ...)."""
    times = {name: [] for name in fns}
    for run in range(runs):
        order = list(fns) if run % 2 == 0 else list(fns)[::-1]
        for name in order:
            times[name].append(timer(fns[name], reps))
    return {name: dict(median=statistics.median(v), min=min(v), max=max(v))
            for name, v in times.items()}


#: the device sleep's cycles a second of sleep (the H100's top SM clock is
#: 1.98 GHz; at a lower clock the sleep only lasts longer)
_SLEEP_HZ = 2e9


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls: the calls are
    enqueued behind a device sleep (``torch.cuda._sleep``), the start
    event recorded after the sleep, so the device runs them back to back
    however slowly the host issues them.  The sleep is sized from the
    host's time to issue one call (four times ``reps`` of it, plus 2 ms),
    and checked: if the start event has completed by the time the host
    has issued the last call, the device waited on the host and the
    reading is not taken; the run is repeated once with a sleep four
    times as long, and raises ``RuntimeError`` if it waits again.  The
    ``reps`` calls' launches must fit in the launch queue (about a
    thousand): on a full queue the host waits for the sleeping device,
    and the check fails however long the sleep."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    issue = time.perf_counter() - t
    torch.cuda.synchronize()
    sleep_s = 2e-3 + 4 * reps * issue
    for attempt in range(2):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * _SLEEP_HZ))
        t0.record()
        for _ in range(reps):
            fn()
        waited = t0.query()             # the sleep was over already
        t1.record()
        torch.cuda.synchronize()
        if not waited:
            return t0.elapsed_time(t1) / reps
        sleep_s *= 4
    raise RuntimeError(f"device_ms: the device sleep of {sleep_s / 4:.4f} s "
                       f"ended before the host had issued {reps} calls")
