"""The comparison that decides ``correct``: the port's outputs against
the plain reference's, number by number, each beside its limit.

Exact numbers (counts of things that differ or are missing) have the
limit 0.  The float numbers compare the demodulator's taps; their limits
were set between the largest reading of sound runs of the port and the
smallest reading of the control (the reference at bfloat16), as
``PERF.md`` records.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

__all__ = ["LIMITS", "Checks", "parse_blob", "compare_taps",
           "compare_frames", "compare_db"]

#: name -> limit; a run is correct when every number is at most its limit
LIMITS = {
    # exact: things that differ from the reference, or are missing
    "blocks_differ": 0,      # window blocks whose blob differs from block 0's
    "frames_bad": 0,         # logical frames differing from the reference
    "frames_missing": 0,     # logical frames never handed to the host
    "fibs_bad": 0,           # FIB rows whose bytes or CRC flag differ
    "timing_bad": 0,         # frames whose PRS timing, its flag or coarse CFO differ
    "fic_crc_bad": 0,        # the receiver's FIC CRC failures
    "sync_bad": 0,           # resyncs, or a receiver that lost sync
    "db_bad": 0,             # ensemble database entries that differ
    "audio_bad": 0,          # bad AUs, superframes, MP2 frames, RS corrections
    "audio_missing": 0,      # AUs or MP2 frames fewer than the frames routed carry
    # float: the taps, set from sound runs and the control
    "snr_err_db": 1e-4,      # max |SNR - reference|, dB
    "cfo_err_hz": 1e-5,      # max |fine CFO - reference|, Hz
    "spectrum_err": 3e-5,    # max |spectrum - reference| / max(reference)
    "constel_diff": 8,       # constellation soft bits that differ
}


class Checks:
    """The numbers compared in one run, in the order they were taken."""

    def __init__(self):
        self.values: Dict[str, float] = {}
        #: counts of what was compared, printed beside the numbers
        self.info: Dict[str, int] = {}

    def add_info(self, name: str, n: int) -> None:
        self.info[name] = self.info.get(name, 0) + int(n)

    def add(self, name: str, value) -> None:
        if name not in LIMITS:
            raise KeyError(f"no limit for {name}")
        v = float(value)
        if name not in self.values:
            self.values[name] = v
        elif LIMITS[name] == 0:          # counts add up over blocks
            self.values[name] += v
        else:                            # readings keep the worst
            self.values[name] = max(self.values[name], v)

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(
            np.isfinite(v) and v <= LIMITS[k] for k, v in self.values.items())

    def table(self) -> Dict[str, List[float]]:
        return {k: [v, LIMITS[k]] for k, v in self.values.items()}

    def lines(self) -> List[str]:
        return ([f"compared {k} {v}" for k, v in self.info.items()]
                + [f"check {k} {v!r} limit {LIMITS[k]!r}"
                   for k, v in self.values.items()])


def parse_blob(big: np.ndarray, F: int, n_fib: int, T_u: int, K: int,
               buckets: Iterable[Tuple[List[int], Tuple[int, ...]]]
               ) -> Dict:
    """The port's merged blob (float32 taps as bytes, FIB bytes, then each
    bucket's bit-packed logical frames) -> named arrays.  ``buckets``:
    (subch ids, shape) in merge order."""
    n_taps = 5 * F + F * n_fib + T_u + 2 * K
    taps = np.frombuffer(big[: 4 * n_taps].tobytes(), np.float32)
    out, pos = {}, 0
    for name, n in (("snr", F), ("fine", F), ("coarse", F), ("t_off", F),
                    ("t_ok", F), ("fic_ok", F * n_fib), ("spectrum", T_u),
                    ("constel", 2 * K)):
        out[name] = taps[pos: pos + n]
        pos += n
    out["fic_ok"] = out["fic_ok"].reshape(F, n_fib)
    off = 4 * n_taps
    out["fib"] = big[off: off + F * n_fib * 30].reshape(F, n_fib, 30)
    off += F * n_fib * 30
    frames = {}
    for ids, shape in buckets:
        n = int(np.prod(shape))
        arr = big[off: off + n].reshape(shape)
        off += n
        for i, sid in enumerate(ids):
            frames[sid] = arr[i]
    out["frames"] = frames
    if off != big.shape[0]:
        raise ValueError(f"blob has {big.shape[0]} bytes, layout {off}")
    return out


def compare_taps(checks: Checks, port: Dict, ref: Dict) -> None:
    """Taps and FIBs of one block.  ``ref`` holds the reference's
    per-frame arrays for the block's frames, in order."""
    checks.add("timing_bad", np.sum(
        (port["t_off"].astype(np.int64) != ref["t_off"])
        | ((port["t_ok"] > 0) != ref["t_ok"])
        | (port["coarse"].astype(np.int64) != ref["coarse"])))
    fib_bad = ((port["fic_ok"] > 0) != ref["fic_ok"]) | np.any(
        port["fib"] != ref["fib"], axis=-1)
    checks.add("fibs_bad", np.sum(fib_bad))
    checks.add("snr_err_db", np.max(np.abs(port["snr"] - ref["snr"])))
    checks.add("cfo_err_hz", np.max(np.abs(port["fine"] - ref["fine"])))
    spec = ref["spectra"].mean(axis=0)
    checks.add("spectrum_err", np.max(np.abs(port["spectrum"] - spec))
               / np.max(spec))
    checks.add("constel_diff", np.sum(port["constel"] != ref["constel"][0]))
    checks.add_info("frames_demodulated", len(port["snr"]))


def align(first: np.ndarray, expected: np.ndarray) -> List[int]:
    """Loop CIFs at which the reference's frame equals ``first``."""
    hits = np.nonzero(np.all(expected == first[None], axis=-1))[0]
    return [int(h) for h in hits]


def compare_frames(checks: Checks, got: Dict[int, List[Tuple[int, np.ndarray]]],
                   expected: Dict[int, np.ndarray]) -> None:
    """Logical frames a receiver handed to the host: ``got`` {subch:
    [(index in its stream, bytes), ...]}, ``expected`` {subch: the
    reference's frames of one loop period [120, bytes]}.  One loop offset
    for all subchannels of the channel: the one under which the most
    frames agree."""
    period = next(iter(expected.values())).shape[0]
    # a subchannel with no frame kept: its frames never came
    checks.add("frames_missing", sum(not got.get(sid) for sid in expected))
    cands = None
    for sid, rows in got.items():
        if not rows:
            continue
        k, first = rows[0]
        offs = {(h - k) % period for h in align(first, expected[sid])}
        cands = offs if cands is None else cands & offs
    best = None
    for c0 in sorted(cands or {0}):
        bad = sum(int(not np.array_equal(b, expected[sid][(c0 + k) % period]))
                  for sid, rows in got.items() for k, b in rows)
        best = bad if best is None else min(best, bad)
    checks.add("frames_bad", best if best is not None
               else sum(len(r) for r in got.values()))
    checks.add_info("frames_compared", sum(len(r) for r in got.values()))


def compare_db(checks: Checks, db, cfg: Dict) -> None:
    """A receiver's ensemble database against the configuration."""
    bad = int(db.ensemble_id != cfg["ensemble"]["eid"])
    bad += int(db.ensemble_label.strip() != cfg["ensemble"]["label"].strip())
    for s in cfg["services"]:
        svc = db.services.get(s["sid"])
        comps = [c for c in db.components
                 if c.sid == s["sid"] and c.tmid == 0]
        sc = db.subchannels.get(s["subch"])
        if svc is None or len(comps) != 1 or sc is None:
            bad += 1
            continue
        want_uep = 0 if s["protection"] == "UEP" else 1
        bad += int(svc.label.strip() != s["label"].strip())
        bad += int(comps[0].subch_id != s["subch"])
        bad += int(comps[0].ascty != (63 if s["kind"] == "DAB+" else 0))
        bad += int(sc.start_addr != s["start_cu"])
        bad += int(sc.bitrate != s["bitrate"])
        bad += int(sc.uep_flag != want_uep)
        bad += int(sc.prot_level != s["level"])
        if want_uep:
            bad += int(sc.eep_profile != s["protection"][-1])
    bad += abs(len(db.services) - len(cfg["services"]))
    checks.add("db_bad", bad)
