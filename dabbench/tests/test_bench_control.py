"""The control (the plain reference at bfloat16 in the port's place)
comes out not correct, and the port at the same size correct, by the
comparison a run makes (small size, on the CPU), in each mode the loop
is cut for: one loop period a block."""

import pytest

from dabbench.check import LIMITS
from dabbench.control import control_checks, program_checks
from dabbench.gen.constants import get_mode
from dabbench.gen.loop import period
from dabbench.tests.conftest import small_config

MODES = [1, 2, 4]


@pytest.mark.parametrize("mode", MODES)
def test_control_is_not_correct(mode):
    frames = period(get_mode(mode)).frames
    c = control_checks(dict(small_config(n=2), mode=mode), 21, frames, "cpu")
    assert not c.correct
    failing = {k for k, v in c.values.items() if v > LIMITS[k]}
    assert failing & {"snr_err_db", "cfo_err_hz", "spectrum_err",
                      "constel_diff"}


@pytest.mark.parametrize("mode", MODES)
def test_program_is_correct_at_the_same_size(mode):
    c = program_checks(dict(small_config(n=2), mode=mode), 21, "cpu",
                       periods=1)
    assert c.correct, c.values
