"""The dependent-chain probes (``dabjax_torch.tools.vpu_probe`` and
``vpu_probe2``) against the TPU probes of ``tools/``, on the same tiles.

The TPU kernels run in Pallas interpret mode on the CPU, each built here
with the probe's own kernel body (``make_chain``) and BlockSpecs
(``tools/`` stays as it is; its scripts are imported by path).  The
port's side is the plain version of each chain kernel, which the CUDA
kernel is held against on the card.  Tiles are compared bit for bit:
integer ops wrap in both, and bf16 rounds after every op in both.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dabjax_torch import _build
from dabjax_torch.tools import vpu_probe, vpu_probe2

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (16, 256)


@functools.lru_cache(maxsize=None)
def _tool(name):
    """A TPU probe script of ``tools/``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_probe_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vmem():
    return pl.BlockSpec(memory_space=pltpu.VMEM)


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy or torch tile, as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("n", [3, 8, 64])
@pytest.mark.parametrize("op", vpu_probe.OPS)
@pytest.mark.parametrize("dtype", list(vpu_probe.DTYPES))
def test_chain_matches_tpu_probe(dtype, op, n):
    """``tools/vpu_probe.py``'s ``make_chain`` (with ``chain``'s specs,
    :55-60) against the plain version."""
    base = np.random.default_rng(n).integers(1, 3, size=SHAPE)
    xj = jnp.asarray(base).astype(dtype)
    want = pl.pallas_call(
        _tool("vpu_probe").make_chain(n, op), in_specs=[_vmem()],
        out_specs=_vmem(), out_shape=jax.ShapeDtypeStruct(SHAPE, xj.dtype),
        interpret=True)(xj)
    x = vpu_probe.tile(dtype, SHAPE, seed=n)
    got = vpu_probe.elementwise_chain_torch(x, op, n)
    assert got.dtype == vpu_probe.DTYPES[dtype] and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _build.LAUNCHES["chain"] == 0


@pytest.mark.parametrize("n", [16, 96])
@pytest.mark.parametrize("dtype", vpu_probe2.DTYPES)
def test_pair_chain_matches_tpu_probe(dtype, n):
    """``tools/vpu_probe2.py``'s ``make_chain`` (with ``chain``'s specs,
    :48-56) against the plain version."""
    x, y = vpu_probe2.pair_tiles(dtype, SHAPE, seed=n)
    xj, yj = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (x, y))
    want = pl.pallas_call(
        _tool("vpu_probe2").make_chain(n), in_specs=[_vmem(), _vmem()],
        out_specs=_vmem(), out_shape=jax.ShapeDtypeStruct(SHAPE, xj.dtype),
        interpret=True)(xj, yj)
    got = vpu_probe2.pair_chain_torch(x, y, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got.ne(x).any()
    assert _build.LAUNCHES["pair_chain"] == 0


def test_integer_chains_wrap():
    """Doublings of 1s and 2s wrap to 0 (int8 after 8, int16 after 16,
    int32 after 32); max(v + v, v) holds once v + v wraps negative."""
    for dtype, zero_at in (("int8", 8), ("int16", 16), ("int32", 32)):
        x = vpu_probe.tile(dtype, SHAPE)
        add = vpu_probe.elementwise_chain_torch
        assert add(x, "add", zero_at - 2).ne(0).all()
        assert not add(x, "add", zero_at).any()
        mix = add(x, "mix", 64)
        assert mix.gt(0).all() and mix.eq(add(x, "mix", 96)).all()
    v = vpu_probe.tile("int8", SHAPE)
    assert torch.equal(vpu_probe.elementwise_chain_torch(v, "max", 64), v)


_WRAPPERS = {
    "chain": lambda: vpu_probe.elementwise_chain_cuda(
        torch.ones((4, 4), dtype=torch.int8), "add", 8),
    "pair_chain": lambda: vpu_probe2.pair_chain_cuda(
        torch.ones((4, 4)), torch.ones((4, 4)), 16),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_refuse_cpu_tensors(name):
    with pytest.raises(ValueError, match="CUDA"):
        _WRAPPERS[name]()


def test_plain_chain_rejects_unknown_op():
    with pytest.raises(ValueError, match="op"):
        vpu_probe.elementwise_chain_torch(torch.ones(4), "mul", 2)


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117elementwise_chainILi2ELi0ELi8EEEvPKjPjxjj
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   IADD3 R0, R0, R0, RZ ;                   /* 0x0000000000007210 */
        /*0020*/               @P0 EXIT ;                                   /* 0x000000000000094d */
        /*0030*/                   NOP;                                     /* 0x0000000000007918 */
\t\tFunction : _ZN12_GLOBAL__N_117elementwise_chainILi2ELi0ELi64EEEvPKjPjxjj
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   IADD3 R0, R0, R0, RZ ;                   /* 0x0000000000007210 */
        /*0020*/                   IADD3 R0, R0, R0, RZ ;                   /* 0x0000000000007210 */
        /*0030*/              @!P0 EXIT ;                                   /* 0x000000000000094d */
\t\tFunction : _ZN12_GLOBAL__N_110pair_chainILi0ELi16EEEvPKjS2_Pjxj
        /*0000*/                   EXIT ;                                   /* 0x000000000000794d */
"""


def test_sass_lengths_parse_cuobjdump(monkeypatch):
    """The SASS count reads each kernel's template arguments and counts
    its instructions, NOPs left out."""
    monkeypatch.setattr(_build, "sass", lambda: _SASS)
    assert vpu_probe._sass_lengths(
        r"elementwise_chainILi(\d+)ELi(\d+)ELi(\d+)E") == {(2, 0, 8): 3,
                                                           (2, 0, 64): 4}
    assert vpu_probe._sass_lengths(r"pair_chainILi(\d+)ELi(\d+)E") == {
        (0, 16): 1}


@pytest.mark.parametrize("mod", [vpu_probe, vpu_probe2],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_main_without_a_card_fails(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the probe")
    assert mod.main() == 1
    err = capsys.readouterr()
    assert "no CUDA card" in err.err and not err.out


@pytest.mark.parametrize("argv", [["dot"], ["both"], ["nope"]])
def test_vpu_probe2_dot_half_not_ported(argv, capsys):
    """The ``dot`` half is ported now: ``dot`` and ``both`` run the probe
    (and fail without a card, as ``vpu`` does); anything else is a usage
    error, exit 2."""
    if argv[0] != "nope" and torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the probe")
    assert vpu_probe2.main(argv) == (2 if argv[0] == "nope" else 1)
    err = capsys.readouterr()
    assert not err.out and err.err
    assert ("usage" if argv[0] == "nope" else "no CUDA card") in err.err
