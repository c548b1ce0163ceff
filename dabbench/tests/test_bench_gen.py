"""The frozen generator copy equals the port's transmitter bit for bit
(at a small size), and the loop is what the configuration states."""

import numpy as np
import pytest

from dabbench.gen import loop
from dabbench.tests.conftest import small_config


def test_frozen_modulator_equals_the_ports():
    from dabjax_torch.tx.modulator import Modulator as PortModulator
    from dabbench.gen.tx.modulator import Modulator
    cfg = small_config()
    gens = loop.payload_generators(cfg, 7)
    kw = dict(mode=1, ensemble_id=cfg["ensemble"]["eid"],
              ensemble_label=cfg["ensemble"]["label"],
              services=loop.service_specs(cfg), payloads=gens)
    ours = Modulator(**kw).frames(2, start_frame=4)
    from dabjax_torch.tx.fig import ServiceSpec
    port_specs = [ServiceSpec(**vars(s)) for s in kw["services"]]
    theirs = PortModulator(**dict(kw, services=port_specs)).frames(
        2, start_frame=4)
    assert ours.dtype == theirs.dtype
    assert ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_frozen_payloads_equal_the_ports(seed):
    from dabjax_torch import testing
    mp2 = loop.mp2_payload(96, 880 + 20 * seed)
    plus = loop.dabplus_payload(96, 2000 + 100 * seed)
    pm, pp = testing.mp2_payload_gen(seed), \
        testing.dabplus_payload_gen(96, seed)
    for cif in range(0, 130, 7):
        assert np.array_equal(mp2(cif), pm(cif))
        assert np.array_equal(plus(cif), pp(cif))


def test_loop_is_one_payload_period_and_seeded():
    cfg = small_config(n=2)
    a = loop.make_loop(cfg, 2 ** 31 + 5)
    p = a.p
    assert a.u8.shape == (loop.PERIOD_FRAMES * p.T_F, 2)
    assert a.u8.dtype == np.uint8
    for s in cfg["services"]:
        for c in range(0, loop.PERIOD_CIFS, 11):
            assert np.array_equal(a.payload_bytes(s["subch"], c),
                                  a.payload_bytes(s["subch"],
                                                  c + loop.PERIOD_CIFS))
    b = loop.make_loop(cfg, 2 ** 31 + 5)
    assert a.u8.tobytes() == b.u8.tobytes()
    c = loop.make_loop(cfg, 2 ** 31 + 6)
    assert a.u8.shape == c.u8.shape and a.u8.tobytes() != c.u8.tobytes()
