"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the port, on a small run on the
CPU (the look for a card skipped).  One chip only: no cell has an
exchange between chips to leave out."""

import json

import pytest
import torch

from dabbench import run
from dabbench.tests.conftest import (bench_with_left_out, small_config,
                                     small_workload)


def state_unchanged(monkeypatch):
    """The MSC step hands back the CIF history it was given."""
    from dabjax_torch.msc.subchannel import EnsembleDecoder
    fused = EnsembleDecoder.fused

    def broken(self, hist, cifs, blob):
        merged, _, meta = fused(self, hist, cifs, blob)
        return merged, hist, meta

    monkeypatch.setattr(EnsembleDecoder, "fused", broken)


def half_batch(monkeypatch):
    """The block graph demodulates half of the block's frames and repeats
    them in place of the rest."""
    from dabjax_torch.runtime.receiver import BlockFn
    frames = BlockFn.frames

    def broken(self, rows, coarse):
        half = rows[::2].repeat_interleave(2, dim=0)[: rows.shape[0]]
        return frames(self, half, coarse)

    monkeypatch.setattr(BlockFn, "frames", broken)


def answer_altered(monkeypatch):
    """One bit of every subchannel's first logical-frame byte flipped
    where the MSC chain packs it."""
    from dabjax_torch.msc import subchannel
    bucket_bytes = subchannel._bucket_bytes

    def broken(slices, g):
        out = bucket_bytes(slices, g).clone()   # [subch, frames, bytes]
        out[:, 0, 0] ^= 1
        return out

    monkeypatch.setattr(subchannel, "_bucket_bytes", broken)


def stale_upload(monkeypatch):
    """The receiver's upload hands the block graph the rows of the first
    block it was given, whatever rows come after."""
    from dabjax_torch.runtime.receiver import Receiver
    upload = Receiver._upload
    first = {}

    def broken(self, rows):
        first.setdefault(id(self), rows.clone())
        return upload(self, first[id(self)])

    monkeypatch.setattr(Receiver, "_upload", broken)


CASES = [(cell, fault) for cell in ("dabplus12_eep3a.core",
                                    "mixed12_uep.live",
                                    "dabplus12_eep3a.core_upload")
         for fault in (state_unchanged, half_batch, answer_altered)]
CASES += [("dabplus12_eep3a.core_upload", stale_upload),
          ("mixed12_uep.live", stale_upload)]
CASES += [("dabplus12_eep3a.bank8", answer_altered),
          ("dabplus12_eep3a.bank8", half_batch),
          ("mixed12_uep.audio", answer_altered),
          ("mixed12_uep.audio", state_unchanged)]


def _run(cell, capsys):
    wl = small_workload(cell)
    cfg = small_config(wl["config"], n=3 if "mixed" in cell else 2)
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 9),
                   "--seconds", "1", "--trace", "0"], device="cpu",
                  workload=wl, config=cfg, bench=bench_with_left_out())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    out = _run(cell, capsys)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", ["dabplus12_eep3a.core", "mixed12_uep.live",
                                  "dabplus12_eep3a.bank8",
                                  "mixed12_uep.audio",
                                  "dabplus12_eep3a.core_upload"])
def test_sound_run_is_correct(cell, capsys):
    out = _run(cell, capsys)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"


@pytest.mark.cuda
def test_core_cell_on_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc = run.main(["--workload", "dabplus12_eep3a.core", "--seed", "5",
                   "--seconds", "2", "--trace", "1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["busy_s"] > 0
