"""The L-Band Mode II configuration (``dabplus12_eep3a_lband``) and the
demod kernels' roofline reader of its core cell, on the CPU at small
size: the port's core path against the benchmark's plain reference in
Mode II, the reader's bound against ``chip_smoke``'s demod bytes, its
kernel names against ``csrc/demod.cu``, and the configuration against
the Mode I one it copies."""

import pathlib
import re

import pytest

from dabbench import run
from dabbench.control import program_checks
from dabbench.gen.loop import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "dabjax_torch" / "csrc"
ROOFLINE = run.read_layer_metric("demod_roofline")


def _globals(path: pathlib.Path) -> list:
    """The names of the ``__global__`` functions in a CUDA source."""
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s*)?(\w+)\s*\(", path.read_text())


@pytest.mark.parametrize("seed", [28, 2 ** 31 + 9])
def test_lband_program_is_correct_against_the_reference(seed):
    """The configuration's first two services, one 120-frame Mode II
    period a block, through the core driver (``BlockFn`` and
    ``EnsembleDecoder.fused``), held to ``dabbench/reference``."""
    cfg = load_config("dabplus12_eep3a_lband")
    cfg = dict(cfg, services=cfg["services"][:2])
    c = program_checks(cfg, seed, "cpu", periods=1)
    assert c.correct, c.values


def test_demod_bound_is_the_smoke_bytes_in_each_mode():
    """``bound_s`` is ``chip_smoke._demod_bytes`` summed at 3.35 TB/s, for
    Mode I's 360 frames and Mode II's 1,440, and the two blocks' bounds
    agree within 0.01 %."""
    from chip_smoke import _demod_bytes
    from dabbench.gen.constants import get_mode
    bounds = []
    for mode, F in ((1, 360), (2, 1440)):
        p = get_mode(mode)
        want = sum(_demod_bytes(p, F).values()) / 3.35e12
        assert ROOFLINE.bound_s(F, p) == pytest.approx(want, rel=1e-12)
        bounds.append(ROOFLINE.bound_s(F, p))
    assert sum(_demod_bytes(get_mode(1), 360).values()) == 1_282_753_824
    assert sum(_demod_bytes(get_mode(2), 1440).values()) == 1_282_770_816
    assert abs(bounds[1] / bounds[0] - 1) < 1e-4


def test_demod_reader_matches_the_demod_kernels_alone():
    """The reader's pattern finds every kernel of ``csrc/demod.cu`` whose
    bytes ``bound_s`` counts, by its bare name and as the profiler's
    demangled name, and none of the coarse-CFO filter (in the same file,
    its bytes not counted), the Viterbi or the MSC front-end kernels."""
    demod = _globals(CSRC / "demod.cu")
    assert set(demod) == {"guard_corr", "mix_windows", "dqpsk_soft",
                          "coarse_cfo"}
    demod.remove("coarse_cfo")
    others = (["coarse_cfo"] + _globals(CSRC / "viterbi.cu")
              + _globals(CSRC / "msc_front.cu"))
    assert {"forward_acs", "traceback", "msc_front"} <= set(others)
    for name in demod:
        assert ROOFLINE.KERNELS.search(name)
        assert ROOFLINE.KERNELS.search(
            f"void (anonymous namespace)::{name}<unsigned char>"
            f"(unsigned char const*, long long, int)")
    for name in others:
        assert not ROOFLINE.KERNELS.search(name)
        assert not ROOFLINE.KERNELS.search(
            f"void (anonymous namespace)::{name}<true, true>(uint2 const*)")


def test_lband_config_differs_from_mode_one_only_in_the_mode():
    """``dabplus12_eep3a_lband`` is ``dabplus12_eep3a`` with mode 2: the
    same ensemble, services, SNR, precision, guarantees and cuts."""
    lband = load_config("dabplus12_eep3a_lband")
    mode1 = load_config("dabplus12_eep3a")
    differ = {k for k in set(lband) | set(mode1)
              if lband.get(k) != mode1.get(k)}
    assert {"name", "mode", "source"} <= differ
    assert differ <= {"name", "mode", "source", "assumed", "why"}
    assert lband["mode"] == 2 and mode1["mode"] == 1
    assert lband["reduced"] == []
