"""The 32-ensemble live monitor (``mixed12_uep_band3.bank32``, driver
``bank_live``) on a small run on the CPU: 2 channels of 8-frame blocks
over a small cut of its configuration.  A sound run is correct and
reports its period latency and the bank's spans; a planted fault reads
not correct; a bank with no profiler (as before the bank kept one) still
runs, with its span metrics left out; a configuration and traffic that
disagree on the channel count refuse to run."""

import importlib
import json

import pytest
import torch

from dabbench import run
from dabbench.gen.loop import load_config
from dabbench.tests.conftest import ROOT, bench_with_left_out
from dabbench.tests.test_bench_faults import answer_altered, half_batch

CELL = "mixed12_uep_band3.bank32"
SPAN_METRICS = ("bank_stage_ms.bank32", "bank_pull_ms.bank32",
                "bank_consume_ms.bank32")
#: the cell's per-layer entries in BENCHMARK.json: (name, unit, source,
#: layer)
LAYER = (("bank_stage_ms.bank32", "ms/period", "program_span", "entry"),
         ("bank_pull_ms.bank32", "ms/period", "program_span", "entry"),
         ("bank_consume_ms.bank32", "ms/period", "program_span",
          "host plane"),
         ("launches.bank32", "launches/period", "device_trace", "device"),
         ("device_idle_pct.bank32", "%", "device_trace", "device"))


def test_cell_names_its_configuration_and_metrics():
    """The workload file names the configuration, the driver and the
    readers, each reader of the unit its entry gives; the configuration
    is the live cell's multiplex at the deployment's channel count."""
    wl = run.load_workload(CELL)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert wl["chips"] == 1 and wl["traffic_name"] == "bank32"
    cfg = load_config(wl["config"])
    assert cfg["channels"] == wl["traffic"]["channels"] == 32
    assert cfg["reduced"] == ["channels"]
    live = load_config("mixed12_uep")
    for key in ("mode", "ensemble", "services", "snr_db", "precision"):
        assert cfg[key] == live[key], key
    assert hasattr(importlib.import_module(
        f"dabbench.drivers.{wl['driver']}"), "Driver")
    assert run.cell_metrics(bench["end_to_end"], wl, "end_to_end") == \
        ["block_p95_ms", "setup_s"]
    assert run.cell_metrics(bench["per_layer"], wl, "per_layer") == \
        [n for n, *_ in LAYER]
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, unit, source, layer in LAYER:
        assert run.read_layer_metric(name).UNIT == unit
        m = entries[name]
        assert (m["unit"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == (unit, source, layer, "block_p95_ms",
                                    [CELL])


def _small(channels=2):
    """The cell's configuration cut as ``conftest.small_config`` cuts the
    live cell's (three services of 128 and 56 kbit/s), at ``channels``."""
    cfg = load_config("mixed12_uep_band3")
    svc = [s for s in cfg["services"] if s["bitrate"] in (128, 56)][:3]
    return dict(cfg, name="small", services=svc, channels=channels)


def _run(capsys, trace=0, cfg=None):
    wl = run.load_workload(CELL)
    wl["traffic"].update(channels=2, frames_per_block=8, max_lock_blocks=8,
                         warm_blocks=2, sample_span=3)
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 77),
                   "--seconds", "1", "--trace", str(trace)], device="cpu",
                  workload=wl, config=cfg or _small(),
                  bench=bench_with_left_out())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _parent_bank(monkeypatch):
    """``MultiReceiver`` as it was before it kept a profiler: no
    ``profiler`` attribute, and a ``step`` that opens no span."""
    from dabjax_torch.parallel.multihost import MultiReceiver
    init = MultiReceiver.__init__

    def bare_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        del self.profiler

    def step(self):
        blks = {}
        for name, rx in self.rx.items():
            blk = rx.stage()
            if blk is not None:
                blks[name] = blk
        if not blks:
            return {name: False for name in self.rx}
        big = self._pull(torch.cat([b.merged for b in blks.values()]))
        off = 0
        for name, b in blks.items():
            n = int(b.merged.shape[0])
            self.rx[name].consume(b, big[off: off + n])
            off += n
        return {name: (name in blks) for name in self.rx}

    monkeypatch.setattr(MultiReceiver, "__init__", bare_init)
    monkeypatch.setattr(MultiReceiver, "step", step)


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct_and_reports_the_bank(trace, capsys):
    out = _run(capsys, trace)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    m = out["metrics"]
    if trace:
        for name in SPAN_METRICS:
            assert m[name]["value"] > 0 and m[name]["unit"] == "ms/period"
        # no device trace on the CPU: the device's metrics read nothing
        assert "launches.bank32" not in m
        assert "device_idle_pct.bank32" not in m
    else:
        assert set(m) == {"block_p95_ms", "setup_s"}
        assert m["block_p95_ms"]["value"] > 0 and m["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", [answer_altered, half_batch],
                         ids=lambda f: f.__name__)
def test_fault_makes_the_run_incorrect(fault, monkeypatch, capsys):
    fault(monkeypatch)
    out = _run(capsys)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] == out["attempted"] > 0


@pytest.mark.parametrize("trace", [0, 1])
def test_bank_without_profiler_runs_with_span_metrics_left_out(
        trace, monkeypatch, capsys):
    _parent_bank(monkeypatch)
    out = _run(capsys, trace)
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    if trace:
        assert not set(SPAN_METRICS) & set(m)
    else:
        assert m["block_p95_ms"]["value"] > 0


def test_channel_count_of_configuration_and_traffic_agree(capsys):
    with pytest.raises(ValueError, match="channels"):
        _run(capsys, cfg=_small(channels=3))


def test_recorded_periods_are_checked_and_not_timed():
    """A stand-in bank whose recorded periods are slow: the window times
    only the others, runs past its seconds until it has timed one, and
    the p95 reads the periods it timed."""
    import time
    from types import SimpleNamespace

    from dabbench.drivers import bank_live
    from dabjax_torch.runtime.profiling import StageProfiler

    d = bank_live.Driver.__new__(bank_live.Driver)
    rec = SimpleNamespace(keep=False)
    kept = []

    def step():
        kept.append(rec.keep)
        time.sleep(0.05 if rec.keep else 0.001)
        return {"ch0": True}

    d.bank = SimpleNamespace(rx={"ch0": SimpleNamespace(
        profiler=StageProfiler())}, step=step)
    d.recs, d.taps = {"ch0": rec}, {"ch0": SimpleNamespace(keep=False)}
    d.kept_channels, d.sample = {"ch0"}, {0, 1, 2}
    d.window(0.0)
    assert kept == [True, True, True, False] and d.periods == 4
    assert len(d.lat) == 1
    d.window(0.3)
    assert len(d.lat) == d.periods - 3 > 1
    assert d.end_to_end()["block_p95_ms"] < 40.0
