"""The Hopper probes (``dabjax_torch.tools``) against the TPU probes of
``tools/``, on the same inputs.

The TPU kernels run in Pallas interpret mode on the CPU, each built here
with the probe's own kernel body and BlockSpecs (``tools/`` stays as it
is; its scripts are imported by path).  The port's side is the plain
version of each probe kernel, which the CUDA kernel is held against on
the card.  Arrays are compared after re-laying the TPU's [Tp2*8, Bp] /
[W, 64, Bp] onto the port's [B, ...] and dropping the lane padding.  The
tolerance is exact throughout: the branch metrics are integer dots, the
path metrics the same float32 adds in the same order, the copy and the
plane the same float32 product and int8 cast, and the per-step planes'
float -> int8 cast XLA's (truncated toward zero, saturated).
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

import dabjax.fec.viterbi_pallas as vp
from dabjax.fec import conv
from dabjax_torch import _build, tools
from dabjax_torch.fec import viterbi, viterbi_cuda
from dabjax_torch.tools import (hbm_probe, vit_split, vit_split2,
                                vit_variants, vit_variants2)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 128          # codewords: one TPU lane block, no lane padding
C = vp._PAIRS_PER_WORD


@functools.lru_cache(maxsize=None)
def _tool(name):
    """A TPU probe script of ``tools/``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_probe_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _soft(nbits, seed):
    """Half coded codewords under heavy noise (sd 80, near ties), half
    pure noise: integer soft bits in +-127, float32 [B, 4*(nbits+6)]."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B // 2, nbits), np.uint8)
    coded = np.stack([conv.encode(b) for b in bits]).astype(np.float32)
    noisy = (coded * 2 - 1) * 100 + np.round(
        rng.standard_normal(coded.shape) * 80)
    noise = tools.soft_bits(B // 2, nbits, seed)
    return np.clip(np.concatenate([noisy, noise]), -127, 127).astype(
        np.float32)


def _t2(nbits):
    return -(-(nbits + conv.K - 1) // 2)


def _tpu_words(kernel, s):
    """A word-forward kernel of the probes over the probe layout ``s``
    [Tp2*8, Bp] int8, with the BlockSpecs of ``tools/vit_variants2.py``
    (:101-114) and ``tools/vit_split2.py`` (:64-77) -> [W, 64, Bp]."""
    K8, Bp = s.shape
    W = K8 // 8 // C
    _, S4 = vp._radix4_matrices()
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(1, W),
        in_specs=[
            pl.BlockSpec((C * 8, Bp), lambda l, i: (i, l),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((256, 8), lambda l, i: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 64, Bp), lambda l, i: (i, 0, l),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((W, 64, Bp), jnp.int32),
        scratch_shapes=[pltpu.VMEM((64, Bp), jnp.float32)],
        interpret=True,
    )(s, jnp.asarray(S4)))


def _tpu_prep(soft, nbits):
    """``tools/vit_split2.py::prep_i8``: the probes' [Tp2*8, Bp] int8."""
    return _tool("vit_split2").prep_i8(jnp.asarray(soft), nbits)


@pytest.mark.parametrize("nbits", [100, 101])
@pytest.mark.parametrize("mode", vit_variants2.MODES)
def test_stage_words_match_tpu_probe(mode, nbits):
    soft = _soft(nbits, seed=nbits)
    x = vit_variants2.padded_pair_soft(torch.from_numpy(soft), nbits)
    Tp2 = vp._round_up(_t2(nbits), C)
    assert tuple(x.shape) == (B, Tp2, 8)
    got = vit_variants2.forward_words_stage_torch(x, mode).numpy()
    want = _tpu_words(_tool("vit_variants2").make_kernel(_t2(nbits), mode),
                      _tpu_prep(soft, nbits))
    assert got.shape == (Tp2 // C, 64, B)
    np.testing.assert_array_equal(got, want[..., :B])
    assert got.any()
    # CPU tensors reach no kernel
    assert _build.LAUNCHES["forward_words_stage"] == 0


def test_stages_differ():
    """Each stage computes something else on the same input."""
    nbits = 100
    x = vit_variants2.padded_pair_soft(torch.from_numpy(_soft(nbits, 3)),
                                       nbits)
    words = [vit_variants2.forward_words_stage_torch(x, m).numpy()
             for m in vit_variants2.MODES]
    for i in range(len(words)):
        for j in range(i):
            assert not np.array_equal(words[i], words[j])


@pytest.mark.parametrize("nbits", [100, 101])
def test_prep_and_kernel_match_tpu_probe(nbits):
    """vit_split2: the port's prep (``pair_soft``) is the probe's
    ``prep_i8`` without the lane transpose and the word padding, and the
    plain forward of K3 "i8" equals the probe's ``_forward_kernel(T2,
    "i8")`` run on that prepped input."""
    soft = _soft(nbits, seed=10 + nbits)
    T2 = _t2(nbits)
    s = _tpu_prep(soft, nbits)
    tpu_x = np.asarray(s).reshape(-1, 8, B).transpose(2, 0, 1)  # [B, Tp2, 8]
    x = vit_split2.prep(torch.from_numpy(soft), nbits).numpy()
    assert x.dtype == np.int8 and x.shape == (B, T2, 8)
    np.testing.assert_array_equal(x, tpu_x[:, :T2])
    assert not tpu_x[:, T2:].any()
    words, _ = viterbi.viterbi_forward_words_torch(torch.from_numpy(soft),
                                                   nbits, "i8")
    want = _tpu_words(vp._forward_kernel(T2, "i8"), s)
    np.testing.assert_array_equal(words.numpy(), want[..., :B])


@pytest.mark.parametrize("nbits", [100, 101])
def test_full_stage_equals_k3_words_below_t2(nbits):
    """``full`` computes every pair step of the padded input; below T2 its
    words are K3's "i8" words (the chip check of the kernels, here on
    their plain versions)."""
    soft = torch.from_numpy(_soft(nbits, seed=20 + nbits))
    full = vit_variants2.forward_words_stage_torch(
        vit_variants2.padded_pair_soft(soft, nbits), "full")
    k3, _ = viterbi.viterbi_forward_words_torch(soft, nbits, "i8")
    assert not torch.equal(full, k3)        # the padding steps differ
    assert torch.equal(vit_variants2.mask_padding(full, _t2(nbits)), k3)


def _tpu_plane_fwd(kernel, s, C):
    """A per-step-plane forward of the probes over their input ``s``
    [Tp2, K, Bp] float32, with the BlockSpecs of ``tools/vit_variants.py``
    (:114-127) and ``tools/vit_split.py`` (:109-122) -> int8
    [Tp2, 64, Bp]."""
    Tp2, K, Bp = s.shape
    _, S4 = vp._radix4_matrices()
    if K == 16:
        S4 = np.concatenate([S4, S4], axis=1)
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(1, Tp2 // C),
        in_specs=[
            pl.BlockSpec((C, K, Bp), lambda l, i: (i, 0, l),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((256, K), lambda l, i: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((C, 64, Bp), lambda l, i: (i, 0, l),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Tp2, 64, Bp), jnp.int8),
        scratch_shapes=[pltpu.VMEM((64, Bp), jnp.float32)],
        interpret=True,
    )(s, jnp.asarray(S4)))


def _plane_input(soft, nbits, ksplit, chunk=8):
    """(the probes' ``preprocess`` [Tp2, K, Bp], the port's
    ``plane_soft`` [B, Tp2, K]), checked equal."""
    s = _tool("vit_split").preprocess(jnp.asarray(soft), nbits, chunk=chunk,
                                      ksplit=ksplit)
    x = vit_variants.plane_soft(torch.from_numpy(soft), nbits, chunk, ksplit)
    np.testing.assert_array_equal(x.numpy(), np.asarray(s).transpose(2, 0, 1))
    return s, x


@pytest.mark.parametrize("nbits", [100, 101])
@pytest.mark.parametrize("ksplit", [True, False], ids=["ksplit", "k8"])
def test_plane_soft_matches_tpu_preprocess(ksplit, nbits):
    soft = _soft(nbits, seed=30 + nbits)
    soft[:, :8] = [300, -300, 128, -129, 255.5, -0.5, 383, 1000]  # hi != 0
    _, x = _plane_input(soft, nbits, ksplit)
    T2, Tp2 = vit_variants.pair_steps(nbits)
    assert tuple(x.shape) == (B, Tp2, 16 if ksplit else 8)
    assert Tp2 % 8 == 0 and Tp2 - 8 < T2 <= Tp2
    if ksplit:                                   # 1000 = 1024 - 24
        assert x[0, 0, 7] == 1024 and x[0, 0, 15] == -24


@pytest.mark.parametrize("nbits", [100, 101])
@pytest.mark.parametrize("ksplit", [True, False], ids=["ksplit", "k8"])
@pytest.mark.parametrize("mode", vit_variants.MODES)
def test_plane_forward_matches_tpu_probe(mode, ksplit, nbits):
    """``tools/vit_variants.py``'s ``make_kernel`` against the plain
    version, on the probes' own ``preprocess`` input."""
    soft = _soft(nbits, seed=40 + nbits)
    s, x = _plane_input(soft, nbits, ksplit)
    T2, Tp2 = vit_variants.pair_steps(nbits)
    got = vit_variants.forward_plane_torch(x, T2, mode).numpy()
    want = _tpu_plane_fwd(_tool("vit_variants").make_kernel(T2, 8, mode), s,
                          8)
    assert got.dtype == np.int8 and got.shape == (Tp2, 64, B)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1
    # CPU tensors reach no kernel
    assert _build.LAUNCHES["forward_plane"] == 0


@pytest.mark.parametrize("nbits", [100, 101])
@pytest.mark.parametrize("unroll", [False, True], ids=["loop", "unrolled"])
def test_make_fwd_matches_plane(unroll, nbits):
    """``tools/vit_split.py``'s ``make_fwd`` (mode full, chunk 16) against
    the plain version: unrolling changes nothing."""
    soft = _soft(nbits, seed=50 + nbits)
    s, x = _plane_input(soft, nbits, ksplit=True, chunk=16)
    T2, _ = vit_variants.pair_steps(nbits, 16)
    assert torch.equal(vit_split.preprocess(torch.from_numpy(soft), nbits,
                                            16), x)
    want = _tpu_plane_fwd(_tool("vit_split").make_fwd(T2, 16, unroll), s, 16)
    got = vit_variants.forward_plane_torch(x, T2, "full", chunk=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[T2:].any() and want[:T2].any()


@pytest.mark.parametrize("nbits", [100, 101])
@pytest.mark.parametrize("ksplit", [True, False], ids=["ksplit", "k8"])
def test_full_plane_packs_to_k3_words(ksplit, nbits):
    """The ``full`` plane, 16 steps per word, is K3 "i8"'s words."""
    soft = torch.from_numpy(_soft(nbits, seed=60 + nbits))
    T2, _ = vit_variants.pair_steps(nbits)
    plane = vit_variants.forward_plane_torch(
        vit_variants.plane_soft(soft, nbits, ksplit=ksplit), T2, "full")
    k3, _ = viterbi.viterbi_forward_words_torch(soft, nbits, "i8")
    assert torch.equal(vit_variants.pack_words(plane), k3)


def test_no_acs_saturates_as_xla():
    """``no_acs`` holds both ends of int8: XLA's cast truncates toward zero
    and saturates, where torch's ``.to(torch.int8)`` alone would wrap."""
    nbits = 100
    _, x = _plane_input(_soft(nbits, seed=70), nbits, ksplit=True)
    T2, _ = vit_variants.pair_steps(nbits)
    got = vit_variants.forward_plane_torch(x, T2, "no_acs")
    assert bool((got == -128).any()) and bool((got == 127).any())
    m = torch.tensor([-1e9, -128.9, -0.5, 126.99, 300.7])
    want = np.asarray(jnp.asarray(m.numpy()).astype(jnp.int8)).tolist()
    assert want == [-128, -128, 0, 126, 127]
    assert m.trunc().clamp(-128, 127).to(torch.int8).tolist() == want
    assert m.to(torch.int8).tolist() != want


def test_plane_input_checks():
    x = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="mode"):
        vit_variants.forward_plane_torch(x, 4, "acs")
    with pytest.raises(ValueError, match="chunk"):
        vit_variants.forward_plane_torch(x, 4, "full", chunk=4)
    with pytest.raises(ValueError, match="multiple of 16"):
        vit_variants.forward_plane_torch(x, 4, "full", chunk=16)
    with pytest.raises(ValueError, match="float32"):
        vit_variants.forward_plane_torch(x.double(), 4, "full")
    with pytest.raises(ValueError, match="soft"):
        vit_variants.plane_soft(torch.zeros((2, 10)), 1)


def _tpu_copy(x, C, LB):
    """``tools/hbm_probe.py``'s ``copy_kernel`` (:43-44) with its specs."""
    def copy_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 1.000001

    Tp, _, L = x.shape
    return np.asarray(pl.pallas_call(
        copy_kernel,
        grid=(L // LB, Tp // C),
        in_specs=[pl.BlockSpec((C, 16, LB), lambda l, i: (i, 0, l),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((C, 16, LB), lambda l, i: (i, 0, l),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))


def _tpu_plane(x, C):
    """``tools/hbm_probe.py``'s ``dec_kernel`` (:69-70) with its specs."""
    def dec_kernel(x_ref, o_ref):
        o_ref[:] = jnp.zeros_like(o_ref) + x_ref[0, 0, 0].astype(jnp.int8)

    Tp, _, LB = x.shape
    return np.asarray(pl.pallas_call(
        dec_kernel,
        grid=(1, Tp // C),
        in_specs=[pl.BlockSpec((C, 16, LB), lambda l, i: (i, 0, l),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((C, 64, LB), lambda l, i: (i, 0, l),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Tp, 64, LB), jnp.int8),
        interpret=True,
    )(jnp.asarray(x)))


def test_copy_matches_tpu_probe():
    """Arbitrary floats, bit for bit: one float32 product each."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((16, 16, 256)) * 100).astype(np.float32)
    got = hbm_probe.scale_copy_torch(torch.from_numpy(x)).numpy()
    want = _tpu_copy(x, C=8, LB=128)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("kind", ["seed6", "out_of_range"])
def test_decision_plane_matches_tpu_probe(kind):
    """Bit for bit with XLA's cast, which truncates and saturates (NaN to
    0), also where the 8-step blocks start outside int8."""
    if kind == "seed6":
        x = hbm_probe.input_block((24, 16, 256), seed=6)
    else:
        x = hbm_probe.odd_block((64, 16, 256), seed=6)
    got = hbm_probe.decision_plane_torch(x)
    want = _tpu_plane(x.numpy(), C=hbm_probe.PLANE_BLOCK)
    assert got.dtype == torch.int8 and tuple(got.shape) == (len(x), 64, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "seed6":
        assert len(np.unique(want)) == 3    # one value per 8-row block
    else:
        assert want[::8, 0, 0].tolist() == [127, -128, 127, -128, 0, 127,
                                            -128, 0]


def test_decision_plane_shape_checks():
    """The wrapper refuses T not a multiple of 8, no input row, and T
    above 65535 (the rows are the kernel's grid.y); a good shape stops
    only at the CPU tensor."""
    with pytest.raises(ValueError, match="multiple of 8"):
        hbm_probe.decision_plane_cuda(torch.zeros((12, 1, 4)))
    with pytest.raises(ValueError, match="multiple of 8"):
        hbm_probe.decision_plane_cuda(torch.zeros((8, 0, 4)))
    with pytest.raises(ValueError, match="65535"):
        hbm_probe.decision_plane_cuda(
            torch.zeros((1, 1, 1)).expand(65544, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        hbm_probe.decision_plane_cuda(torch.zeros((65528, 1, 4)))


def test_input_block_is_int8_valued():
    x = hbm_probe.input_block((8, 16, 32), seed=1)
    assert x.dtype == torch.float32
    assert torch.equal(x, x.round()) and float(x.abs().max()) <= 127


_WRAPPERS = {
    "forward_words_stage": lambda: vit_variants2.forward_words_stage_cuda(
        torch.zeros((2, 16, 8), dtype=torch.int8), "full"),
    "kernel_only": lambda: vit_split2.kernel_only(
        torch.zeros((2, 53, 8), dtype=torch.int8)),
    "scale_copy": lambda: hbm_probe.scale_copy_cuda(torch.zeros((8, 16, 4))),
    "decision_plane": lambda: hbm_probe.decision_plane_cuda(
        torch.zeros((8, 16, 4))),
    "forward_plane": lambda: vit_variants.forward_plane_cuda(
        torch.zeros((2, 8, 16)), 4),
    "vit_split_fwd": lambda: vit_split.fwd(torch.zeros((2, 16, 16)), 4,
                                           chunk=16, unroll=True),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_refuse_cpu_tensors(name):
    with pytest.raises(ValueError, match="CUDA"):
        _WRAPPERS[name]()


def test_stage_input_checks():
    x = torch.zeros((2, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="mode"):
        vit_variants2.forward_words_stage_torch(x, "acs")
    with pytest.raises(ValueError, match="multiple of 16"):
        vit_variants2.forward_words_stage_torch(x[:, :15], "full")


@pytest.mark.parametrize("mod", [vit_variants2, vit_split2, hbm_probe,
                                 vit_variants, vit_split],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_main_without_a_card_fails(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the probe")
    assert mod.main() == 1
    err = capsys.readouterr()
    assert "no CUDA card" in err.err and not err.out


def test_interleaved_ms_takes_runs_in_turns():
    """``tools.interleaved_ms`` times the functions in turns (a, b, b, a,
    ...) by the timer it is given, and keeps each one's median and range."""
    from dabjax_torch import tools
    calls = []

    def timer(fn, reps):
        assert reps == 10
        calls.append(fn())
        return float(len(calls))
    spread = tools.interleaved_ms({"a": lambda: "a", "b": lambda: "b"}, 3,
                                  10, timer)
    assert calls == ["a", "b", "b", "a", "a", "b"]
    assert spread == {"a": dict(median=4.0, min=1.0, max=5.0),
                      "b": dict(median=3.0, min=2.0, max=6.0)}
