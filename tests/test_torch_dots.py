"""The dot-shape probes (``dabjax_torch.tools.vit_dotshapes`` and the
``dot`` half of ``vpu_probe2``) against the TPU probes of ``tools/``.

The TPU kernels run in Pallas interpret mode on the CPU.  The scripts of
``tools/`` are imported by path, a fresh copy per test, and left as they
are: ``probe`` and ``probe_batched`` build their ``pallas_call`` inside,
so the copy's ``pl`` is swapped for one whose ``pallas_call`` adds
``interpret=True`` and records the kernel's output, and its ``timed`` for
a single call; ``make_dots`` is built here with the probe's own BlockSpecs
(``dots``, :91-98).  The port's side is the plain version of each kernel,
which the CUDA kernel is held against on the card.

Tolerances: on small-integer inputs (every product and sum an integer
below 2^24) exact; on the TPU probe's standard-normal inputs, float32
sums of the same products taken in another order, within 1e-5 of the
largest value.  ``make_dots`` runs on the TPU probe's integer inputs,
where both sides round acc * 1e-9 and the add the same way: exact.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dabjax_torch import _build
from dabjax_torch.tools import vit_dotshapes as vd
from dabjax_torch.tools import vpu_probe2

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
LB, STEPS = 128, 4


def _fresh_tool(name):
    """A new copy of a TPU probe script of ``tools/``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_dot_probe_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _IntRng:
    """Stands in for ``default_rng`` in the TPU script: small integers
    where it asks for standard normals."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def standard_normal(self, shape):
        return self._rng.integers(-3, 4, size=shape).astype(np.float64)


def _run_tpu(fn_name, inputs, *args):
    """Run ``tools/vit_dotshapes.py``'s ``fn_name`` once in interpret
    mode; returns (its kernel's output, X, S) as numpy float32."""
    mod = _fresh_tool("vit_dotshapes")
    seen = {}

    def pallas_call(kernel, **kw):
        f = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*a):
            seen["out"] = f(*a)
            return seen["out"]
        return call

    def timed(fn, *a, **kw):
        seen["args"] = a
        fn(*a)
        return 1.0

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call,
                                   BlockSpec=pl.BlockSpec)
    mod.timed = timed
    if inputs == "int":
        mod.np = types.SimpleNamespace(
            random=types.SimpleNamespace(default_rng=_IntRng))
    getattr(mod, fn_name)(*args)
    x, s = (np.asarray(jnp.asarray(a, jnp.float32)) for a in seen["args"])
    return np.asarray(seen["out"]), x, s


def _port(a, dtype):
    return torch.from_numpy(np.array(a)).to(vd.DTYPES[dtype])


def _compare(got, want, inputs):
    if inputs == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("inputs", ["normal", "int"])
@pytest.mark.parametrize("dtype", list(vd.DTYPES))
@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("mode", vd.MODES)
def test_probe_matches_tpu_probe(mode, k, dtype, inputs):
    """``probe`` (:49-89): pm[0, :128] after STEPS steps."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want, x, s = _run_tpu("probe", inputs, "t", k, LB, STEPS, mode, jdt)
    assert want.shape == (1, 128) and x.shape == (STEPS, k, LB)
    got = vd.dot_steps_torch(_port(s, dtype), _port(x, dtype), mode)
    assert tuple(got.shape) == ((256 if mode == "dot" else 64), LB)
    _compare(got[:1, :128].numpy(), want, inputs)
    assert _build.LAUNCHES["dot_steps"] == 0


@pytest.mark.parametrize("inputs", ["normal", "int"])
@pytest.mark.parametrize("dtype", list(vd.DTYPES))
@pytest.mark.parametrize("k", [8, 16])
def test_probe_batched_matches_tpu_probe(k, dtype, inputs, capsys):
    """``probe_batched`` (:92-115): the product's [0, :128]."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want, x, s = _run_tpu("probe_batched", inputs, "t", k, LB, STEPS, jdt)
    assert "us/step" in capsys.readouterr().out
    assert x.shape == (k, STEPS * LB)
    got = vd.dot_batched_torch(_port(s, dtype), _port(x, dtype))
    assert tuple(got.shape) == (256, STEPS * LB)
    _compare(got[:1, :128].numpy(), want, inputs)


def test_probe_inputs_are_the_tpu_probes():
    """S then X from default_rng(0), float32 then bf16 (the TPU script's
    own cast of f32 values, so the bf16 inputs agree too)."""
    for dtype, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        _, x, s = _run_tpu("probe", "normal", "t", 16, LB, STEPS, "dot", jdt)
        sp, xp = vd.probe_inputs(16, LB, STEPS, dtype)
        np.testing.assert_array_equal(sp.float().numpy(), s)
        np.testing.assert_array_equal(xp.float().numpy(), x)


@pytest.mark.parametrize("n_dots", vpu_probe2.DOT_NS)
@pytest.mark.parametrize("shape", [s[:2] for s in vpu_probe2.DOT_SHAPES])
def test_dots_match_tpu_probe(shape, n_dots):
    """``make_dots`` (:78-87, with ``dots``' specs) on the TPU probe's
    integer inputs, 256 columns: bit for bit."""
    rows_w, kdim = shape
    rng = np.random.default_rng(n_dots + kdim)
    x = rng.integers(-127, 128, size=(8 * kdim, 256)).astype(np.float32)
    w = rng.integers(-1, 2, size=(rows_w, kdim)).astype(np.float32)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        _fresh_tool("vpu_probe2").make_dots(n_dots, rows_w, kdim),
        in_specs=[vmem, vmem], out_specs=vmem,
        out_shape=jax.ShapeDtypeStruct((rows_w, 256), jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(w))
    got = vpu_probe2.dots_torch(torch.from_numpy(x), torch.from_numpy(w),
                                n_dots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _build.LAUNCHES["dots_chain"] == 0


def test_dot_inputs_are_the_tpu_probes():
    """x then w for each shape in turn from one default_rng(0), as
    ``dot_costs`` (:101-110) draws them."""
    rng = np.random.default_rng(0)
    for (rows_w, kdim, tag), (tag_p, x, w) in zip(vpu_probe2.DOT_SHAPES,
                                                 vpu_probe2.dot_inputs()):
        want_x = rng.integers(-127, 128, size=(8 * kdim, 4480))
        want_w = rng.integers(-1, 2, size=(rows_w, kdim))
        assert tag_p == tag
        np.testing.assert_array_equal(x.numpy(), want_x)
        np.testing.assert_array_equal(w.numpy(), want_w)


_WRAPPERS = {
    "dot_steps": lambda: vd.dot_steps_cuda(torch.ones((256, 16)),
                                           torch.ones((2, 16, 16))),
    "dot_steps_bf16": lambda: vd.dot_steps_cuda(
        torch.ones((256, 16), dtype=torch.bfloat16),
        torch.ones((2, 16, 16), dtype=torch.bfloat16)),
    "dot_batched": lambda: vd.dot_batched_cuda(torch.ones((256, 16)),
                                               torch.ones((16, 16))),
    "dots": lambda: vpu_probe2.dots_cuda(torch.ones((64, 16)),
                                         torch.ones((256, 8)), 8),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_refuse_cpu_tensors(name):
    with pytest.raises(ValueError, match="CUDA"):
        _WRAPPERS[name]()


def test_plain_probe_rejects_bad_input():
    with pytest.raises(ValueError, match="mode"):
        vd.dot_steps_torch(torch.ones((256, 8)), torch.ones((1, 8, 16)),
                           "mul")
    with pytest.raises(ValueError, match="S"):
        vd.dot_steps_torch(torch.ones((64, 8)), torch.ones((1, 8, 16)))


_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_113dot_steps_f32ILi0ELi16ELi9EEEvPKfS2_Pfiii
        /*0000*/                   FFMA R0, R1, R2, R0 ;                    /* 0x0000000000007223 */
        /*0010*/                   FMUL R3, R1, R2 ;                        /* 0x0000000000007220 */
        /*0020*/                   FADD R3, R1, R2 ;                        /* 0x0000000000007221 */
\t\tFunction : _ZN12_GLOBAL__N_113dot_steps_f32ILi0ELi16ELi1EEEvPKfS2_Pfiii
        /*0000*/                   FFMA R0, R1, R2, R0 ;                    /* 0x0000000000007223 */
\t\tFunction : _ZN12_GLOBAL__N_114dot_steps_bf16E14CUtensorMap_stS0_PKtPfiii
        /*0000*/                   HGMMA.64x32x16.F32.BF16 R24, R4, gdesc[UR4], R24, gsb0 ;  /* 0x0000000000007223 */
        /*0010*/                   HGMMA.64x8x16.F32.BF16 R88, R4, gdesc[UR8], R88, gsb0 ;  /* 0x0000000000007223 */
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;    /* 0x0000000000007223 */
\t\tFunction : _ZN12_GLOBAL__N_116dot_batched_bf16E14CUtensorMap_stS0_PKtix
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, R4, gdesc[UR4], RZ, !UPT ;  /* 0x0000000000007223 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R56, R8, gdesc[UR4], RZ, !UPT ;  /* 0x0000000000007223 */
\t\tFunction : _ZN12_GLOBAL__N_110dots_chainILi32ELi8EEEvPKfS2_Pfii
        /*0000*/                   FFMA R0, R1, R2, R0 ;                    /* 0x0000000000007223 */
        /*0010*/                   FFMA R0, R1, R2, R0 ;                    /* 0x0000000000007223 */
        /*0020*/                   FFMA R0, R1, R2, R0 ;                    /* 0x0000000000007223 */
        /*0030*/                   NOP;                                     /* 0x0000000000007918 */
"""


def test_sass_counts_read_cuobjdump(monkeypatch):
    """The per-step and per-dot counts read the kernels' template
    arguments and count only the named instructions (the f32 step
    kernel's: its 9-column build only; the bf16 step kernel's: its
    wgmma, HGMMA of any width, not HMMA)."""
    monkeypatch.setattr(_build, "sass", lambda: _SASS)
    counts = vd.sass_counts()
    assert counts["dot f32 K=16"] == 2 and counts["dot bf16 K=16"] == 2
    assert counts["dot_acs f32 K=16"] == 0
    assert counts["batched bf16 K=16"] == 2
    assert vpu_probe2.dot_sass_counts()["uv [32,8]"] == 3 / 8


@pytest.mark.parametrize("argv", [[], ["dot"], ["both"]])
def test_probe_mains_without_a_card_fail(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the probe")
    assert vpu_probe2.main(argv) == 1
    if not argv:
        assert vd.main() == 1
    err = capsys.readouterr()
    assert "no CUDA card" in err.err and not err.out


@pytest.mark.parametrize("mode", vd.MODES)
@pytest.mark.parametrize("lb", [16, 512, 528, 544, 4480, 4496])
def test_step_tiles_store_every_output_once(lb, mode):
    """D1's thread map (``step_tiles``, as ``csrc/dots.cu`` computes it):
    every output element is stored by exactly one thread at one column a
    warp (LB up to 4 x 132) and at 9, the last warp partial at 4480 and
    4496; each block is 4 warps; in ``dot`` the 16 rows e*64 + 4j + q of
    one (j) sit in lanes (j, 0) and (j, 1), e = h and h + 2, as the ACS of
    ``dot_acs`` needs them."""
    out = np.zeros((vd.ROWS if mode == "dot" else 64, lb), dtype=np.int64)
    kc = vd.step_cols(lb)
    assert kc == (1 if lb <= 4 * 132 else vd.WIDE_COLS)
    for block, warp, lane, rows, cols in vd.step_tiles(lb, mode):
        assert 0 <= warp < vd.STEP_WARPS
        assert cols == [c for c in range((4 * block + warp) * kc,
                                         (4 * block + warp + 1) * kc)
                        if c < lb]
        out[np.ix_(rows, cols)] += 1
        if mode == "dot":
            j, h = lane & 15, lane >> 4
            assert sorted(rows) == sorted(e * 64 + 4 * j + q for e in
                                          (h, h + 2) for q in range(4))
    assert (out == 1).all()


@pytest.mark.parametrize("lb", [16, 512, 4480, 4496])
def test_bf16_step_strips_cover_every_column_once(lb):
    """D2's blocks (``bf16_step_strips``, as ``csrc/dots.cu`` computes
    them): contiguous strips of whole 8-column units that cover every
    column once, at most 132 of them (one an SM) and at most 40 columns
    each, the busiest SM's share with 8-column units balanced over 132
    SMs; 132 blocks of 32 or 40 columns at LB 4480 (where strips of 32
    would be 140), 16 of 32 at LB 512."""
    strips = vd.bf16_step_strips(lb)
    out = np.zeros(lb, dtype=np.int64)
    for c0, cols in strips:
        assert cols % 8 == 0 and 0 < cols <= 8 * vd.BF16_UNITS == 40
        out[c0:c0 + cols] += 1
    assert (out == 1).all() and len(strips) <= 132
    assert [c0 for c0, _ in strips] == sorted(c0 for c0, _ in strips)
    widths = {cols for _, cols in strips}
    assert {4480: widths == {32, 40} and len(strips) == 132,
            4496: widths == {32, 40} and len(strips) == 132,
            512: widths == {32} and len(strips) == 16,
            16: strips == [(0, 16)]}[lb]
