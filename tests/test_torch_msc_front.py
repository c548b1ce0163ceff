"""The MSC front-end kernel's host side (``dabjax_torch/msc/front_cuda.py``)
against the torch chain it replaces, on the CPU.

For every EEP-A/B protection level and every UEP profile, the wrapper's
table (the row after the frame's first and the column each full-rate
position reads, or a zero), applied by plain numpy gathers, and its
chunked form as the kernel reads it (``front_np``), equal
``step_soft(depuncture_profile(time_deinterleave(msc_soft(cat(hist,
cifs)))))`` over the subchannels' slices byte for byte, on float soft
values with +-127.5, +-0.9, +-1e6 and +-inf planted and on the int8
block.  The kernel itself is held to the chain on the card
(``tests/test_torch_card.py``)."""

import numpy as np
import pytest
import torch

from dabjax_torch.fec import puncture, viterbi_cuda
from dabjax_torch.msc import front_cuda
from dabjax_torch.msc.deinterleave import HISTORY, time_deinterleave
from dabjax_torch.msc.subchannel import _next_history, msc_soft

torch.set_num_threads(1)

_EEP = ([("A", br, lvl) for br in (8, 96, 384) for lvl in (1, 2, 3, 4)]
        + [("B", br, lvl) for br in (32, 64, 192) for lvl in (1, 2, 3, 4)])
_CASES = ([("UEP",) + k for k in sorted(puncture.UEP_PROFILES)]
          + [("EEP",) + e for e in _EEP])
_SPECIAL = np.array([127.5, -127.5, 0.9, -0.9, 1e6, -1e6, np.inf, -np.inf],
                    np.float32)


def _profile(case):
    if case[0] == "UEP":
        return puncture.uep_profile(case[1], case[2])
    return puncture.eep_profile(case[2], case[3], case[1])


def _chain(block, starts, n_cus, lengths, pis):
    """K1's input by the torch chain: int8 [n, T - 15, 4 * (nbits + 6)]."""
    soft = msc_soft(torch.from_numpy(block))
    slices = torch.stack([soft[:, 64 * s: 64 * (s + n_cus)] for s in starts])
    full = puncture.depuncture_profile(time_deinterleave(slices), lengths,
                                       pis)
    nbits = full.shape[-1] // 4 - 6
    return viterbi_cuda.step_soft(full, nbits).reshape(
        full.shape).numpy()


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(map(str, c)))
def test_front_table_equals_the_chain(case):
    lengths, pis = _profile(case)
    table = front_cuda.front_table(tuple(lengths), tuple(pis))
    n_tx = puncture.punctured_length(lengths, pis)
    n_cus = -(-n_tx // 64)
    # the kernel's limits: chunks of at most THREADS * WORDS words, runs
    # of columns on multiples of ALIGN, inside the subchannel's columns
    assert table.n_tx == n_tx and table.out_len == sum(lengths) * 128 + 24
    assert table.chunk_words <= front_cuda.THREADS * front_cuda.WORDS
    assert table.width <= front_cuda.MAX_WIDTH
    lo, width = table.chunks[:, 0], table.chunks[:, 1]
    assert not (lo % front_cuda.ALIGN).any()
    assert not (width % front_cuda.ALIGN).any()
    assert (width <= table.width).all() and (lo + width <= 64 * n_cus).all()

    rng = np.random.default_rng(n_tx)
    starts = [3, 4 + n_cus]                # odd start addresses
    T = HISTORY + 5
    block = rng.uniform(-160, 160, (T, 64 * (starts[-1] + n_cus) + 64))
    block = block.astype(np.float32)
    at = rng.integers(0, block.size, 64 * _SPECIAL.size)
    block.flat[at] = np.repeat(_SPECIAL, 64)
    want = _chain(block, starts, n_cus, lengths, pis)
    assert want.shape == (2, T - HISTORY, table.out_len)

    # the table per position, by plain numpy gathers
    rows, cols = front_cuda.sources(lengths, pis)
    soft = msc_soft(torch.from_numpy(block)).numpy()
    t = np.arange(T - HISTORY)[:, None]
    for b, s in enumerate(starts):
        got = np.where(cols >= 0, soft[t + rows, 64 * s + np.maximum(cols, 0)],
                       0)
        np.testing.assert_array_equal(got, want[b])
    # the chunked table as the kernel walks it, on float and int8 blocks
    np.testing.assert_array_equal(front_cuda.front_np(block, starts, table),
                                  want)
    np.testing.assert_array_equal(front_cuda.front_np(soft, starts, table),
                                  _chain(soft, starts, n_cus, lengths, pis))


@pytest.mark.parametrize("new", [4, 14, 15, 16])
@pytest.mark.parametrize("into_hist", [False, True])
def test_next_history_is_the_blocks_last_cifs(new, into_hist):
    """The kernel path's history without the block: the last 15 rows of
    ``cat(hist, cifs)``, into the history itself or a new tensor."""
    rng = np.random.default_rng(new)
    hist = torch.from_numpy(rng.standard_normal((HISTORY, 64), np.float32))
    cifs = torch.from_numpy(rng.standard_normal((new, 64), np.float32))
    want = torch.cat([hist, cifs])[-HISTORY:].clone()
    got = _next_history(hist, cifs, hist if into_hist else None)
    assert torch.equal(got, want)
    assert (got.data_ptr() == hist.data_ptr()) == into_hist
    if not into_hist and new >= HISTORY:
        assert got.data_ptr() != cifs[-HISTORY:].data_ptr()


def test_decoder_refuses_a_subchannel_outside_the_cif():
    """The front-end kernel reads each subchannel's columns by its start
    address, so the decoder refuses one that ends past the CIF's 864 CUs
    (the chain's gather would fail on it later)."""
    from dabjax_torch.constants import get_mode
    from dabjax_torch.msc.subchannel import EnsembleDecoder, SubchGeometry
    inside = SubchGeometry(0, 792, 72, 96, "EEP-A", 3)
    EnsembleDecoder([inside], get_mode(1), device="cpu")
    with pytest.raises(ValueError):
        EnsembleDecoder([inside, SubchGeometry(1, 800, 72, 96, "EEP-A", 3)],
                        get_mode(1), device="cpu")
