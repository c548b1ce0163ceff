"""Run one benchmark cell once and print its result line.

    python -m dabbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``dabbench/workloads/<cell>.json``; it names its
configuration (``dabbench/configs/``), its driver (``dabbench/drivers/``)
and its metrics.  Set-up renders the cell's IQ from the seed, builds the
port's objects and warms every shape; the window then drives the port
for ``--seconds`` (a traced run: for the cell's ``trace_seconds``, under
``torch.profiler``).  Once the window has closed and the device's peak
memory is read, the port's outputs are held against the plain reference
(``dabbench/reference``), and the last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error).

Needs a CUDA card: without one, or with fewer cards than the cell asks
for, it exits 2 and prints no result.  It exits 3 with no result if
``jax``, ``jaxlib``, ``flax`` or ``dabjax`` were loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

__all__ = ["main", "load_workload", "load_benchmark", "read_layer_metric",
           "forbidden_modules", "process_start", "cell_metrics"]

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = pathlib.Path(__file__).resolve().parent
#: top-level module names the port's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dabjax")


def process_start() -> float:
    """Wall time (``time.time()``) at which this process started."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``dabjax_torch`` passes, ``dabjax`` does not)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def load_workload(name: str) -> dict:
    with open(BENCH / "workloads" / f"{name}.json") as f:
        wl = json.load(f)
    if wl["name"] != name:
        raise ValueError(f"workload file {name}.json names {wl['name']}")
    return wl


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def read_layer_metric(name: str):
    """The reader module ``dabbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "dabbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(entries, wl: dict, kind: str) -> list:
    """The metrics a cell reports: those its workload file names, and
    every entry of ``BENCHMARK.json`` that lists the cell (or, with no
    ``workloads`` key, every cell), so that a later metric is added by a
    new file and a new entry alone."""
    names = list(wl[kind])
    for m in entries:
        if wl["name"] in m.get("workloads", [wl["name"]]) \
                and m["name"] not in names:
            names.append(m["name"])
    return names


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its own kernels into ``dabjax_torch/build``), no
    flax for ``transformers``, one numeric thread a process."""
    cache = BENCH / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    # one thread a process for the numeric libraries: the audio worker
    # processes inherit it, and the host's cores are shared
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def _card_line(torch, n: int) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"nvidia-smi: {e}"]
    return f"card: {name} x{n}; " + " | ".join(smi[:n])


def main(argv=None, *, device=None, workload=None, config=None,
         bench=None) -> int:
    """Run a cell.  ``device``, ``workload``, ``config`` and ``bench`` are
    for the harness's own tests, which drive a small run on the CPU: they
    skip the look for a card and take the cell, its configuration and
    BENCHMARK.json as given."""
    t_proc = process_start()
    ap = argparse.ArgumentParser(prog="python -m dabbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    wl = workload or load_workload(args.workload)
    bench = bench or load_benchmark()
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"dabbench: needs {wl['chips']} CUDA card(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
        print(_card_line(torch, wl["chips"]), flush=True)
    device = torch.device(device)
    cuda = device.type == "cuda"

    from dabbench.gen.loop import load_config
    from dabbench.trace import Spans
    cfg = config or load_config(wl["config"])
    drv = importlib.import_module(f"dabbench.drivers.{wl['driver']}")
    spans = Spans(bool(args.trace))
    d = drv.Driver(cfg, wl, args.seed, device, spans)
    d.setup()
    if cuda:
        torch.cuda.synchronize(device)
    seconds = min(args.seconds, wl["trace_seconds"]) if args.trace \
        else args.seconds
    trace = None
    t_first = time.time()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with spans("window"):
                d.window(seconds)
        path = str(BENCH / ".cache" / f"trace_{os.getpid()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        del prof
        from dabbench.trace import parse_chrome_trace
        trace = parse_chrome_trace(path)
    else:
        d.window(seconds)
    setup_s = t_first - t_proc
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = d.end_to_end()
    layer_ctx = d.layer_context(trace) if args.trace else None
    d.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = d.check()
    d.close()

    leaked = forbidden_modules()
    if leaked:
        print(f"dabbench: forbidden modules loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return 3

    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if args.trace:
        for name in cell_metrics(bench["per_layer"], wl, "per_layer"):
            mod = read_layer_metric(name)
            v = mod.read(layer_ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        e2e["setup_s"] = setup_s
        for name in cell_metrics(bench["end_to_end"], wl, "end_to_end"):
            metrics[name] = {"value": float(e2e[name]), "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": checks.correct and d.attempted() > 0,
           "attempted": d.attempted(), "failed": d.failed(checks),
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    out["checks"] = checks.table()
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
