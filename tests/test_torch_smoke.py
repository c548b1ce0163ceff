"""chip_smoke.py refuses to report a result where it cannot drive the
card: without CUDA, and when copied out of a checkout."""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU refusal")
    res = _run(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "cuda" in res.stderr.lower()


def test_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
