"""The one seam of the hand-written kernels, on the CPU: every C entry in
``dabjax_torch/csrc`` is declared by exactly one wrapper module's
``ENTRIES`` table, with the ctypes types of its prototype; the launch
helper in ``_build`` passes the arguments and the stream, counts the
launch in ``_build.LAUNCHES`` and raises on an error code; the graphs
import no kernel module; and no module but ``_build`` counts a launch."""

import ast
import collections
import contextlib
import ctypes
import importlib
import pathlib
import re
import types

import pytest
import torch

from dabjax_torch import _build

PKG = pathlib.Path(_build.__file__).resolve().parent

#: a C parameter's type -> the ctypes type its declaration must give
_C_TYPES = (("*", ctypes.c_void_p), ("long long", ctypes.c_longlong),
            ("unsigned", ctypes.c_uint), ("float", ctypes.c_float),
            ("int", ctypes.c_int))


def _c_type(param: str):
    for word, ctype in _C_TYPES:
        if word in param:
            return ctype
    raise AssertionError(f"no ctypes type for the parameter {param!r}")


def _prototypes() -> dict:
    """{entry: [ctypes type of each parameter]} of every ``int dabjax_*(``
    in ``csrc/*.cu``."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r"^int (dabjax_\w+)\(([^)]*)\)",
                                       src.read_text(), re.M):
            out[name] = [_c_type(p) for p in params.split(",")]
    return out


def _modules_with_entries() -> list:
    """The package's modules that assign ``ENTRIES`` at the top level."""
    found = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(isinstance(node, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "ENTRIES"
                       for t in node.targets) for node in tree.body):
            rel = path.relative_to(PKG.parent).with_suffix("")
            found.append(importlib.import_module(".".join(rel.parts)))
    return found


PROTOTYPES = _prototypes()


def test_every_kernel_source_has_entries():
    assert len(PROTOTYPES) == 19
    assert {n.split("_")[1] for n in PROTOTYPES} == {"viterbi", "demod",
                                                     "msc", "probe"}


@pytest.mark.parametrize("name", sorted(PROTOTYPES))
def test_one_wrapper_declares_each_entry_as_its_prototype(name):
    """Exactly one wrapper module declares the entry, argument by
    argument as the prototype: its table holds the arguments before the
    stream, which ``_build.launch`` passes last as a pointer."""
    owners = [m for m in _modules_with_entries() if name in m.ENTRIES]
    assert len(owners) == 1, [m.__name__ for m in owners]
    *args, stream = PROTOTYPES[name]
    assert stream is ctypes.c_void_p
    assert list(owners[0].ENTRIES[name]) == args


def test_entries_tables_declare_only_entries_of_the_sources():
    declared = [n for m in _modules_with_entries() for n in m.ENTRIES]
    assert sorted(declared) == sorted(PROTOTYPES)


class _Entry:
    """A stand-in C entry: records its calls, returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def stand_in(monkeypatch):
    """A library of two stand-in entries, a device context that enters
    nothing and a current stream of address 0x5EED; a fresh registry."""
    lib = types.SimpleNamespace(dabjax_ok=_Entry(0), dabjax_bad=_Entry(700))
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0x5EED))
    return lib, entered


def test_launch_passes_arguments_and_stream_and_counts(stand_in):
    lib, entered = stand_in
    entries = {"dabjax_ok": (ctypes.c_void_p, ctypes.c_int),
               "dabjax_bad": (ctypes.c_int,)}
    dev = torch.device("cuda", 1)
    for _ in range(2):
        _build.launch("kernel", entries, "dabjax_ok", dev, 1234, 5)
    assert lib.dabjax_ok.calls == [(1234, 5, 0x5EED)] * 2
    assert entered == [dev, dev]
    assert lib.dabjax_ok.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    assert lib.dabjax_ok.restype is ctypes.c_int
    assert _build.LAUNCHES == {"kernel": 2}
    with pytest.raises(RuntimeError, match="other .*dabjax_bad.*700"):
        _build.launch("other", entries, "dabjax_bad", dev, 9)
    assert lib.dabjax_bad.calls == [(9, 0x5EED)]
    assert _build.LAUNCHES == {"kernel": 2, "other": 1}


def _imported(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_graphs_import_no_kernel_module():
    tree = ast.parse((PKG / "graphs.py").read_text())
    kernels = ("dabjax_torch.fec", "dabjax_torch.msc", "dabjax_torch.ofdm")
    assert not [n for n in _imported(tree) if n.startswith(kernels)]


def _counter_name(node) -> str:
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    return node.id if isinstance(node, ast.Name) else ""


def test_only_build_counts_launches():
    """No module of the package but ``_build`` assigns a name ending in
    ``LAUNCHES`` (or an item of one), or declares one ``global``."""
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        if path.name == "_build.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Global):
                names = node.names
            elif isinstance(node, ast.Assign):
                names = [_counter_name(t) for t in node.targets]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                names = [_counter_name(node.target)]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno}" for n in names
                          if n.endswith("LAUNCHES")]
    assert not offenders
