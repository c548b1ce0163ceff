"""The harness's own tests: on the CPU at small sizes, the card-only
ones marked ``cuda`` (they skip inside the test without a card; on the
card: ``python -m pytest -m cuda dabbench/tests``)."""

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips inside the test without "
                   "one); run on the card with `python -m pytest -m cuda "
                   "dabbench/tests`")


def small_config(name: str = "mixed12_uep", n: int = 3) -> dict:
    """A configuration's first ``n`` services of the kinds given, as a
    configuration of its own (the CPU runs the port's plain Viterbi)."""
    cfg = json.loads((ROOT / "dabbench" / "configs" / f"{name}.json")
                     .read_text())
    if name == "mixed12_uep":
        svc = [s for s in cfg["services"] if s["bitrate"] in (128, 56)][:n]
    else:
        svc = cfg["services"][:n]
    return dict(cfg, name="small", services=svc)


def small_workload(name: str) -> dict:
    """A cell's workload cut to a CPU run: 30-frame core blocks, 8-frame
    receiver blocks, 2 bank channels."""
    wl = json.loads((ROOT / "dabbench" / "workloads" / f"{name}.json")
                    .read_text())
    tr = wl["traffic"]
    if wl["driver"] in ("core", "core_upload"):
        tr.update(periods_per_block=1)
    elif wl["driver"] == "bank":
        tr.update(channels=2, frames_per_block=8, max_lock_blocks=8,
                  sample_span=3)
    else:
        tr.update(frames_per_block=8, warm_blocks=2, sample_span=2)
    return wl


#: the entries that would put the bank and audio cells in BENCHMARK.json:
#: their drivers, workload files and readers are kept, the cells are not
#: (PERF.md says why: their runs spread too widely for a bound)
LEFT_OUT = {
    "workloads": [{"name": "dabplus12_eep3a.bank8",
                   "config": "dabplus12_eep3a", "traffic": "bank8",
                   "chips": 1},
                  {"name": "mixed12_uep.audio", "config": "mixed12_uep",
                   "traffic": "audio", "chips": 1}],
    "end_to_end": [{"name": "bank_rt", "unit": "signal-s/s",
                    "better": "higher", "source": "host_clock",
                    "workloads": ["dabplus12_eep3a.bank8"]},
                   {"name": "receiver_rt", "unit": "signal-s/s",
                    "better": "higher", "source": "host_clock",
                    "workloads": ["mixed12_uep.audio"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": src,
         "layer": layer, "moves": moves, "workloads": [cell]}
        for n, u, src, layer, moves, cell in (
            ("device_idle_pct.bank", "%", "device_trace", "device",
             "bank_rt", "dabplus12_eep3a.bank8"),
            ("host_stage_ms.bank", "ms/period", "program_span", "receiver",
             "bank_rt", "dabplus12_eep3a.bank8"),
            ("host_consume_ms.bank", "ms/period", "program_span",
             "receiver", "bank_rt", "dabplus12_eep3a.bank8"),
            ("audio_s_per_s.audio", "s/signal-s", "program_counter",
             "host plane", "receiver_rt", "mixed12_uep.audio"))],
}


def bench_with_left_out() -> dict:
    """BENCHMARK.json with the left-out cells' entries added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in LEFT_OUT.items():
        bench[key] = bench[key] + entries
    return bench
