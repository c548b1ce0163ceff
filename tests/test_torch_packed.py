"""K2's packed epilogue on the CPU: the PRBS words it XORs, a lane-level
model of its store against the torch chain it replaces
(``pack_bits_u8(prbs.disperse(bits))``), its wrapper's refusals, and the
MSC chain's route to it.  The kernel itself is held to the chain on the
card (``tests/test_torch_card.py``)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from dabjax_torch.constants import CIF_BITS, get_mode
from dabjax_torch.fec import prbs, viterbi, viterbi_cuda as vc
from dabjax_torch.msc import subchannel
from dabjax_torch.msc.deinterleave import HISTORY
from dabjax_torch.msc.subchannel import (EnsembleDecoder, SubchGeometry,
                                         pack_bits_u8)

torch.set_num_threads(1)
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "dabbench" / "configs"


def _config_nbits() -> list:
    """24 x bitrate of every subchannel of the benchmark's configurations,
    and the FIC's 768."""
    rates = set()
    for path in sorted(CONFIGS.glob("*.json")):
        with open(path) as f:
            rates |= {s["bitrate"] for s in json.load(f)["services"]}
    return sorted({24 * r for r in rates} | {768})


def test_config_nbits_cover_both_configurations():
    assert _config_nbits() == [768, 1344, 1536, 1920, 2304, 3072, 4608]


def _kernel_bytes(word: int) -> bytes:
    """The kernel's 4 bytes of a 32-bit word: ``__byte_perm(__brev(w), 0,
    0x0123)`` stored little-endian."""
    rev = int(f"{word:032b}"[::-1], 2)
    return rev.to_bytes(4, "big")      # byte reversal, then little-endian


@pytest.mark.parametrize("nbits", _config_nbits())
def test_prbs_words_in_the_kernel_order_are_the_packed_prbs(nbits):
    """Bit j of word k is PRBS bit 32k + j (zeros past ``nbits``), and the
    kernel's reorder of the words gives ``np.packbits(prbs(nbits))``."""
    w = prbs.words(nbits)
    assert w.dtype == np.uint32 and w.shape == (-(-nbits // 32),)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(bits[:nbits], prbs.prbs(nbits))
    assert not bits[nbits:].any()
    got = b"".join(_kernel_bytes(int(x)) for x in w)[: nbits // 8]
    assert got == np.packbits(prbs.prbs(nbits)).tobytes()
    on = prbs.words_on(nbits, torch.device("cpu"))
    assert on.dtype == torch.int32
    assert on is prbs.words_on(nbits, torch.device("cpu"))
    np.testing.assert_array_equal(on.numpy().view(np.uint32), w)


@pytest.mark.parametrize("nbits", [8, 104, 768, 1344, 2304, 9216])
@pytest.mark.parametrize("B", [1, 5])
def test_packed_epilogue_model_equals_the_chain(B, nbits):
    """The lane model of the epilogue (tile mask ^ PRBS word, bits of each
    byte reversed) equals ``pack_bits_u8(prbs.disperse(bits))`` on random
    bits, also where ``nbits`` ends inside a tile."""
    g = torch.Generator().manual_seed(B * 1009 + nbits)
    bits = torch.randint(0, 2, (B, nbits), generator=g, dtype=torch.int32)
    got = viterbi.packed_epilogue_lanes_torch(bits, nbits)
    assert got.dtype == torch.uint8 and got.shape == (B, nbits // 8)
    assert torch.equal(got, pack_bits_u8(prbs.disperse(bits)))


@pytest.mark.parametrize("nbits", [768, 1344])
def test_packed_traceback_model_equals_the_plain_chain(nbits):
    """K2's walk and the packed epilogue, modelled lane by lane, on random
    decision words equal the plain traceback's bits dispersed and packed."""
    g = torch.Generator().manual_seed(nbits)
    dec = torch.randint(-2 ** 31, 2 ** 31, (3, nbits + 6, 2), generator=g,
                        dtype=torch.int64).to(torch.int32)
    bits = viterbi.viterbi_traceback_torch(vc.unpack_decisions(dec), nbits)
    assert torch.equal(viterbi.viterbi_traceback_packed_lanes_torch(dec, nbits),
                       pack_bits_u8(prbs.disperse(bits)))


def test_packed_wrapper_refuses_cpu_tensors_and_partial_bytes():
    dec = torch.zeros((2, 774, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor required"):
        vc.viterbi_traceback_packed_cuda(dec, 768)
    for nbits in (100, 767, 4):
        with pytest.raises(ValueError, match="not a multiple of 8"):
            vc.viterbi_traceback_packed_cuda(dec, nbits)


def _routed(monkeypatch, packed_calls):
    """Stand the packed wrapper in by its lane model, recording calls."""
    def packed(dec, nbits):
        packed_calls.append((tuple(dec.shape), nbits))
        return viterbi.viterbi_traceback_packed_lanes_torch(dec, nbits)
    monkeypatch.setattr(vc, "viterbi_traceback_packed_cuda", packed)


@pytest.mark.parametrize("fmt, packed", [("i8lane", True), ("i8lane2", True),
                                         ("i8mxu", False), ("f32", False)])
def test_bucket_bytes_route(monkeypatch, fmt, packed):
    """The kernel route (one CUDA device, no mesh) under a K1 + K2 format
    decodes by K1's decisions and K2's packed epilogue (here its lane
    model); under a word format, and off the kernel route, by the torch
    chain.  Both give the chain's bytes, in the bucket's shape."""
    monkeypatch.setattr(vc, "SOFT_FMT", fmt)
    calls = []
    _routed(monkeypatch, calls)
    g = SubchGeometry(0, 0, 6, 8, "EEP-A", 3)        # 192 bits
    rng = np.random.default_rng(7)
    full = torch.from_numpy(rng.integers(-127, 128, (2, 3, 4 * (192 + 6)))
                            .astype(np.float32))
    want = pack_bits_u8(subchannel.decode_full(full, g))
    assert torch.equal(subchannel._bucket_bytes(full, g), want)
    assert calls == []
    got = subchannel._bucket_bytes(full, g, kernel=True)
    assert got.shape == (2, 3, 24) and torch.equal(got, want)
    assert calls == ([((6, 198, 2), 192)] if packed else [])


def test_cpu_fused_bytes_are_the_packed_logical_frames():
    """On the CPU, ``_fused``'s merged blob is the blob followed by each
    bucket's logical frames from ``decode``, packed by numpy."""
    geoms = [SubchGeometry(1, 0, 6, 8, "EEP-A", 3),
             SubchGeometry(2, 6, 6, 8, "EEP-A", 3),
             SubchGeometry(3, 12, 12, 16, "EEP-A", 3)]
    dec = EnsembleDecoder(geoms, get_mode(1), device=torch.device("cpu"))
    rng = np.random.default_rng(11)
    block = torch.from_numpy(rng.integers(-127, 128, (HISTORY + 2, CIF_BITS))
                             .astype(np.float32))
    hist, cifs = block[:HISTORY], block[HISTORY:]
    blob = torch.arange(9, dtype=torch.uint8)
    merged, new_hist, meta = dec._fused(hist, cifs, blob)
    bits = dec.decode(block)
    want = [blob.numpy()]
    for geoms_b, shape in meta:
        frames = np.stack([bits[g.subch_id] for g in geoms_b])
        assert frames.shape[:-1] + (frames.shape[-1] // 8,) == shape
        want.append(np.packbits(frames.astype(np.uint8), axis=-1).reshape(-1))
    np.testing.assert_array_equal(merged.numpy(), np.concatenate(want))
    assert torch.equal(new_hist, block[-HISTORY:])
