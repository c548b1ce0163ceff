"""Nothing the harness loads is jax, jaxlib, flax or dabjax, compared by
whole top-level module names (``dabjax_torch`` is the port and passes)."""

import os
import subprocess
import sys

from dabbench import run
from dabbench.tests.conftest import ROOT

AUDIT = """
import importlib, pathlib, sys
import dabbench.run as run
for mod in ("dabbench.common", "dabbench.check", "dabbench.control",
            "dabbench.trace", "dabbench.reference.receiver",
            "dabbench.gen.loop", "dabbench.drivers.core",
            "dabbench.drivers.bank", "dabbench.drivers.receiver",
            "dabjax_torch.runtime.receiver",
            "dabjax_torch.parallel.multihost",
            "dabjax_torch.runtime.audio_pool"):
    importlib.import_module(mod)
for path in (pathlib.Path(run.BENCH) / "metrics").glob("*.py"):
    run.read_layer_metric(path.stem)
print("LOADED", ",".join(sorted({m.split(".")[0] for m in sys.modules})))
print("FORBIDDEN", ",".join(run.forbidden_modules()))
"""


def test_subprocess_import_audit():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", AUDIT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "FORBIDDEN")))
    loaded = set(lines["LOADED"].split(","))
    assert "dabjax_torch" in loaded and "dabbench" in loaded
    assert not loaded & set(run.FORBIDDEN)
    assert lines["FORBIDDEN"].strip() == ""


def test_names_are_compared_whole(monkeypatch):
    for name in ("dabjax_torch.fake", "jaxtyping_fake", "flaxen_fake",
                 "dabjax.fake", "jax.fake"):
        monkeypatch.setitem(sys.modules, name, object())
    found = run.forbidden_modules()
    assert "dabjax.fake" in found and "jax.fake" in found
    assert not {"dabjax_torch.fake", "jaxtyping_fake",
                "flaxen_fake"} & set(found)


def test_no_card_means_no_result():
    """Without a card a run exits 2 and prints no result line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "dabbench.run", "--workload",
         "dabplus12_eep3a.core", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 2
    assert "correct" not in out.stdout
