"""Kernels of the port against their plain versions on a CUDA card.

Marked ``cuda``: each skips inside the test when there is no card.  The
file imports neither jax nor ``dabjax``, so it runs on a machine without
them: ``python -m pytest --noconftest -m cuda tests/test_torch_card.py``
(``tests/conftest.py`` imports jax).
"""

import numpy as np
import pytest
import torch

from dabjax_torch.fec import conv, viterbi, viterbi_cuda as vc
from dabjax_torch.fec.viterbi import viterbi_decode_np
from dabjax_torch.tools import vit_dotshapes as vd
from dabjax_torch.tools import vpu_probe2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _soft(B, nbits, seed):
    """[B, 4*(nbits+6)] integer soft bits: codeword i coded with noise,
    near a tie, or pure noise as i % 3."""
    rng = np.random.default_rng(seed)
    coded = np.stack([conv.encode(b) for b in
                      rng.integers(0, 2, (B, nbits), np.uint8)])
    clean = (coded.astype(np.float32) * 2 - 1) * 100
    sigma = np.array([40.0, 80.0, 0.0])[np.arange(B) % 3, None]
    soft = np.clip(clean + np.round(rng.standard_normal(clean.shape)
                                    * sigma), -127, 127)
    noise = np.arange(B) % 3 == 2
    soft[noise] = rng.integers(-127, 128, (int(noise.sum()), soft.shape[1]))
    return soft.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [100, 101, 768, 2304, 9216])
@pytest.mark.parametrize("B", [1, 31, 33, 384, 4428])
def test_traceback_kernel_bit_exact_on_card(B, nbits):
    """K2 against its plain version on K1's decisions, and K1 + K2
    against the numpy decoder (up to 384 codewords: the numpy decoder
    takes minutes at 4428 x 9216)."""
    dev = _card()
    soft = _soft(B, nbits, seed=B * 10007 + nbits)
    s = torch.from_numpy(soft).to(dev)
    dec = vc.viterbi_forward_cuda(vc.step_soft(s, nbits))
    got = vc.viterbi_traceback_cuda(dec, nbits)
    want = viterbi.viterbi_traceback_torch(vc.unpack_decisions(dec), nbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if B <= 384:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      viterbi_decode_np(soft, nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32 * 4480, 4488])
def test_batched_bf16_kernel_on_card(n):
    """D4 exact on integer inputs, within 1e-5 of max |plain| on the TPU
    probe's normal inputs, at the probe's width and a tail width; its
    SASS holds wgmma (HGMMA), one a 64-row slab."""
    dev = _card()
    rng = np.random.default_rng(n)
    si = torch.from_numpy(rng.integers(-1, 2, (256, 16)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-3, 4, (16, n)).astype(np.float32))
    si, xi = (t.to(torch.bfloat16).to(dev) for t in (si, xi))
    assert torch.equal(vd.dot_batched_cuda(si, xi),
                       vd.dot_batched_torch(si, xi))
    s, x = (t.to(dev) for t in vd.batched_inputs(16, n, 1, "bfloat16"))
    got, want = vd.dot_batched_cuda(s, x), vd.dot_batched_torch(s, x)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert vd.sass_counts()["batched bf16 K=16"] >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", vd.MODES)
def test_step_kernel_matches_plain_on_card(mode):
    dev = _card()
    s, x = (t.to(dev) for t in vd.probe_inputs(16, 512, 32))
    want = vd.dot_steps_torch(s, x, mode)
    got = vd.dot_steps_cuda(s, x, mode)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_dots_kernel_matches_plain_on_card():
    dev = _card()
    for _, x, w in vpu_probe2.dot_inputs():
        x, w = x.to(dev), w.to(dev)
        for n in vpu_probe2.DOT_NS:
            assert torch.equal(vpu_probe2.dots_cuda(x, w, n),
                               vpu_probe2.dots_torch(x, w, n))
