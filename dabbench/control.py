"""Readings the limits of ``dabbench.check`` were set from.

    python -m dabbench.control --config <name> --frames 360,4 \\
        --program-seeds 1,2,... --control-seeds 101,102,103 --periods 12

For each program seed, the port's decode core (the core cell's driver,
its timed path at the core cell's size) decodes one block after a warm
one, and its numbers are taken as a run takes them: the lower readings.
For each control seed, the control (the plain reference computed at
bfloat16, ``Reference(precision="bfloat16")``) is put in the port's
place: its taps, FIBs and frames of the first ``frames`` frames of the
loop are held against the float64 reference's by the same comparison:
the upper readings.  Prints one JSON line a reading, then the largest
program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["control_checks", "program_checks", "main"]


def control_checks(cfg, seed: int, frames: int, device):
    """The control's numbers for one seed at a block of ``frames``."""
    from dabbench.common import reference_of
    from dabbench.drivers.core import judge
    from dabbench.gen.loop import make_loop, period
    loop = make_loop(cfg, seed)
    p = loop.p
    ref = reference_of(loop, device, "float64")
    ctl = reference_of(loop, device, "bfloat16")
    f = np.arange(frames) % period(p).frames
    port = {k: ctl[k][f] for k in ("snr", "fine", "coarse", "t_off",
                                   "t_ok", "fic_ok", "fib")}
    port["spectrum"] = ctl["spectra"][f].mean(axis=0)
    port["constel"] = ctl["constel"][0]
    port["frames"] = {sid: fr[np.arange(p.cifs_per_frame * frames)
                              % fr.shape[0]]
                      for sid, fr in ctl["frames"].items()}
    return judge(port, ref, p, frames, 0)


def program_checks(cfg, seed: int, device, periods: int = 12):
    """The port's numbers for one seed: the core cell's path."""
    from dabbench.drivers.core import Driver
    from dabbench.trace import Spans
    wl = {"traffic": {"periods_per_block": periods}}
    d = Driver(cfg, wl, seed, device, Spans(False))
    d.setup()
    d.window(0.0)
    d.release()
    return d.check()


def main(argv=None) -> int:
    import torch
    from dabbench.gen.loop import load_config
    ap = argparse.ArgumentParser(prog="python -m dabbench.control")
    ap.add_argument("--config", required=True)
    ap.add_argument("--frames", default="360")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--periods", type=int, default=12,
                    help="loop periods a program block (the core cell's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    dev = torch.device(args.device)
    lower, upper = {}, {}
    for s in filter(None, args.program_seeds.split(",")):
        c = program_checks(cfg, int(s), dev, args.periods)
        print(json.dumps({"program": int(s), "correct": c.correct,
                          "checks": c.values}), flush=True)
        for k, v in c.values.items():
            lower[k] = max(lower.get(k, v), v)
    for frames in [int(x) for x in args.frames.split(",")]:
        for s in filter(None, args.control_seeds.split(",")):
            c = control_checks(cfg, int(s), frames, dev)
            print(json.dumps({"control": int(s), "frames": frames,
                              "correct": c.correct, "checks": c.values}),
                  flush=True)
            for k, v in c.values.items():
                upper.setdefault(frames, {})
                upper[frames][k] = min(upper[frames].get(k, v), v)
    print(json.dumps({"config": args.config, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
