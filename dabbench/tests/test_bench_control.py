"""The control (the plain reference at bfloat16 in the port's place)
comes out not correct, and the port at the same size correct, by the
comparison a run makes (small size, on the CPU)."""

from dabbench.control import control_checks, program_checks
from dabbench.tests.conftest import small_config


def test_control_is_not_correct():
    c = control_checks(small_config(n=2), 21, 30, "cpu")
    assert not c.correct
    failing = {k for k, v in c.values.items() if v > __import__(
        "dabbench.check", fromlist=["LIMITS"]).LIMITS[k]}
    assert failing & {"snr_err_db", "cfo_err_hz", "spectrum_err",
                      "constel_diff"}


def test_program_is_correct_at_the_same_size():
    c = program_checks(small_config(n=2), 21, "cpu", periods=1)
    assert c.correct, c.values
