"""The plain reference decodes the loop, played twice across its seam,
to exactly the transmitted payload, and imports nothing of the port."""

import ast
import pathlib

import numpy as np

from dabbench.gen import loop
from dabbench.reference.receiver import Reference, loop_rows
from dabbench.tests.conftest import small_config


def test_two_passes_of_the_loop_decode_to_the_payload():
    cfg = small_config()
    lp = loop.make_loop(cfg, 11)
    ref = Reference(cfg, "cpu")
    p = lp.p
    two = np.concatenate([lp.u8, lp.u8])
    cifs, ok = [], []
    for f0 in range(0, 2 * loop.PERIOD_FRAMES, 10):
        d = ref.demod(loop_rows(two, p, range(f0, f0 + 10)))
        assert (d["t_off"] == 0).all() and d["t_ok"].all()
        assert (d["coarse"] == 0).all()
        ok.append(ref.fic(d["soft"])[1])
        cifs.append(ref.cifs(d["soft"]))
    assert np.concatenate(ok).all()
    frames = ref.msc(np.concatenate(cifs), cfg["services"])
    for s in cfg["services"]:
        got = frames[s["subch"]]
        assert got.shape == (2 * loop.PERIOD_CIFS - 15, 3 * s["bitrate"])
        for t in range(got.shape[0]):       # across the seam at CIF 120
            assert np.array_equal(got[t], lp.payload_bytes(s["subch"], t))


def test_reference_imports_nothing_of_the_port():
    root = pathlib.Path(__file__).resolve().parents[1] / "reference"
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("dabjax_torch", "dabjax",
                                               "jax"), (path, n)
