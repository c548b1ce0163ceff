"""The plain reference imports nothing of the port (its decode of the
loop across the seam is in ``test_bench_modes.py``, one case a mode)."""

import ast
import pathlib


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
