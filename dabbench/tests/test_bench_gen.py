"""The frozen generator copy equals the port's transmitter bit for bit
(at a small size), and every Mode I loop a cell plays is the same, byte
for byte, as it was before the loop was cut by mode."""

import hashlib

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


#: SHA-256 of ``make_loop(load_config(config), 0, salt).u8``, taken before
#: the loop was cut by mode (when it rendered Mode I alone)
MODE_I_LOOPS = {
    ("dabplus12_eep3a", 0):
        "759b8b51c630f99120f2517418e661199f494a81b35ffefb4158d0bafc3e3c82",
    ("mixed12_uep", 0):
        "c41ddc844828e124d751533e08fd3678ca2eb18ffdb6ba93147ea0059f73d25d",
    ("mixed12_uep_band3", 0):
        "c41ddc844828e124d751533e08fd3678ca2eb18ffdb6ba93147ea0059f73d25d",
    ("mixed12_uep_band3", 1):
        "a41c311665179c32e1a89d2343951fd190f9ef809815a944e7947714de4b7d90",
}


@pytest.mark.parametrize("config,salt", sorted(MODE_I_LOOPS))
def test_mode_i_loops_are_unchanged(config, salt):
    """Each configuration's loop at seed 0 (a bank's channels: salts 0
    and 1), and where its channels start playing, as before."""
    cfg = loop.load_config(config)
    lp = loop.make_loop(cfg, 0, salt)
    assert lp.u8.shape == (30 * 196_608, 2)
    assert hashlib.sha256(lp.u8.tobytes()).hexdigest() \
        == MODE_I_LOOPS[config, salt]
    assert [loop.start_offset(cfg, 0, c) for c in range(4)] \
        == [2_555_904, 3_735_552, 1_179_648, 4_521_984]


def test_mode_i_blockgraph_bound_is_unchanged():
    """The core cell's block-graph bound (360 Mode I frames), as before:
    bytes-bound, 219,038,400 bytes at 3.35 TB/s."""
    from dabbench import run
    bound = run.read_layer_metric("blockgraph_roofline").bound_s(
        {"F": 360, "need": 193_448, "T_u": 2048, "L": 76, "K": 1536,
         "cifs_per_frame": 4, "cif_bits": 55296, "n_fib": 12})
    assert bound == 6.538459701492537e-05
