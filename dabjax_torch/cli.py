"""Command-line control plane of the torch port: ``python -m dabjax_torch
info|decode|scan`` (port of :mod:`dabjax.cli`, same arguments).

The jax-free pieces (source specs, the service-list and scope printers,
the audio player) are dabjax's own; the commands are ported because they
reach dabjax's Receiver and band scan through that module's globals.  The
receiver runs on the first CUDA card when one is present, else on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from dabjax.cli import _print_db, _print_scopes, _spawn_player, open_source

__all__ = ["main", "cmd_info", "cmd_decode", "cmd_scan"]


def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _build_receiver(args, service: Optional[str] = None):
    from dabjax.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import Receiver
    if getattr(args, "config", None):
        cfg = ReceiverConfig.load(args.config)
        cfg.mode = args.mode
    else:
        cfg = ReceiverConfig(mode=args.mode)
    cfg.service = service
    if getattr(args, "save_config", None):
        cfg.save(args.save_config)
    return Receiver(open_source(args.source), cfg, device=_device())


def cmd_info(args) -> int:
    r = _build_receiver(args)
    if getattr(args, "watch", 0):
        # live dashboard: re-run block batches and redraw (the
        # scope/waterfall loop of the reference GUI, scope.cpp); the
        # waterfall panel keeps the last 12 block spectra (scope.cpp:384
        # scrolling history)
        from collections import deque
        from dabjax.runtime.scopes import render_waterfall
        history = deque(maxlen=12)
        for i in range(args.watch):
            r.run(1)
            print(f"\x1b[2J\x1b[H[block {i + 1}/{args.watch}]")
            if r.metrics.synced:
                history.append(np.asarray(r.metrics.spectrum))
                _print_db(r)
                if args.scope:
                    _print_scopes(r)
                    print("waterfall (oldest on top):")
                    print(render_waterfall(history))
            else:
                print("searching for DAB signal ...")
        return 0 if r.metrics.synced else 1
    r.run(args.blocks)
    if not r.metrics.synced:
        print("no DAB signal found")
        return 1
    _print_db(r)
    if getattr(args, "scope", False):
        _print_scopes(r)
    return 0


def cmd_decode(args) -> int:
    from dabjax.io.audio_out import WavSink
    from dabjax.audio.aac import sample_rate as aac_rate
    # with --out -, stdout carries raw PCM: all text goes to stderr
    info = sys.stderr if args.out == "-" else sys.stdout
    r = _build_receiver(args, service=args.service)
    r.run(args.blocks)
    if not r.metrics.synced:
        print("no DAB signal found", file=info)
        return 1
    _print_db(r, file=info)
    rc = 1
    for subch_id, svc in r.audio.items():
        rc = 0
        if svc.pcm:
            rate = (svc.mp2.sample_rate if svc.mp2 is not None
                    else aac_rate(svc.superframe.header.dac_rate,
                                  svc.superframe.header.sbr_flag))
            out = args.out or "audio.wav"
            if getattr(args, "play", False):
                from dabjax.io.audio_out import PcmPipeSink
                proc = _spawn_player(getattr(args, "player", None))
                if proc is None:
                    print("no audio player found (aplay/ffplay); "
                          "use --player CMD or --out", file=info)
                else:
                    w = PcmPipeSink(proc.stdin)
                    w.write(np.concatenate(svc.pcm), rate)
                    proc.stdin.close()
                    proc.wait()
                    print(f"subch {subch_id}: played {w.frames_written} "
                          "PCM frames", file=info)
                continue
            if out == "-":                 # live: raw PCM to stdout (aplay)
                from dabjax.io.audio_out import PcmPipeSink
                w = PcmPipeSink(sys.stdout.buffer)
                w.write(np.concatenate(svc.pcm), rate)
                print(f"subch {subch_id}: streamed {w.frames_written} PCM "
                      "frames to stdout", file=sys.stderr)
            else:
                with WavSink(out) as w:
                    w.write(np.concatenate(svc.pcm), rate)
                print(f"subch {subch_id}: wrote {w.frames_written} PCM "
                      f"frames -> {out}", file=info)
        elif svc.is_dab_plus and svc.aac.aus:
            out = (args.out or "audio.aus")
            with open(out, "wb") as f:
                for au in svc.aac.aus:
                    f.write(au)
            print(f"subch {subch_id}: wrote {len(svc.aac.aus)} AAC AUs "
                  f"-> {out} (no host AAC codec in this image)", file=info)
        if svc.dynamic_label:
            print(f"subch {subch_id}: dynamic label: {svc.dynamic_label!r}",
                  file=info)
        for obj in svc.slides:
            path = f"slide_{obj.transport_id:04x}_{obj.name or 'unnamed'}"
            with open(path, "wb") as f:
                f.write(obj.body)
            print(f"subch {subch_id}: MOT slide -> {path}", file=info)
    for subch_id, h in r.data_handlers.items():
        rc = 0
        objs = getattr(getattr(h, "handler", None), "objects", [])
        for obj in objs:
            path = f"mot_{obj.transport_id:04x}_{obj.name or 'unnamed'}"
            with open(path, "wb") as f:
                f.write(obj.body)
            print(f"subch {subch_id}: MOT object -> {path}", file=info)
        if hasattr(h, "error_rate"):
            print(f"subch {subch_id}: packet error rate "
                  f"{100 * h.error_rate:.1f}%", file=info)
    if args.json:
        print(json.dumps(r.metrics.as_dict()), file=info)
    return rc


def cmd_scan(args) -> int:
    """Band scan (gui.cpp:561-638): live tuner hop over Band III / L-band
    (``scan rtlsdr:all`` / ``rtlsdr:band3`` / ``rtlsdr:5A,7D,12C``) or the
    file-dict form (``scan 12C=file.raw 5A=null``) — both drive the same
    channel-hop loop in :mod:`dabjax_torch.runtime.scan`."""
    from dabjax.runtime.channels import channel_list
    from dabjax.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.scan import band_scan

    spec = args.channels
    if len(spec) == 1 and "=" not in spec[0]:
        dev, _, sel = spec[0].partition(":")
        if sel in ("", "all"):
            channels = channel_list("III") + channel_list("L")
        elif sel in ("band3", "III"):
            channels = channel_list("III")
        elif sel in ("lband", "L"):
            channels = channel_list("L")
        else:
            channels = sel.split(",")
        source = open_source(dev)
    else:
        from dabjax.io.sources import TunedSourceBank
        bank = {}
        channels = []
        for pair in spec:
            chan, _, path = pair.partition("=")
            try:
                bank[chan] = open_source(path)
            except SystemExit:
                print(f"{chan:>4}: unreadable source {path}")
                continue
            channels.append(chan)
        source = TunedSourceBank(bank)

    found = 0

    def show(res):
        nonlocal found
        if res.synced and res.ensemble_label:
            print(f"{res.channel:>4}: {res.ensemble_label!r} "
                  f"({res.n_services} services, "
                  f"SNR {res.snr_db:.1f} dB)")
            found += 1
        else:
            print(f"{res.channel:>4}: no signal")

    band_scan(source, channels, config=ReceiverConfig(mode=args.mode),
              blocks=args.blocks, on_result=show, device=_device())
    return 0 if found else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dabjax_torch",
        description="DAB/DAB+ receiver on PyTorch (CUDA when a card is "
                    "present)")
    ap.add_argument("-M", "--mode", type=int, default=1,
                    help="DAB transmission mode (1/2/4)")
    ap.add_argument("-i", "--config", default=None,
                    help="load receiver config JSON (the ini-file analog)")
    ap.add_argument("--save-config", default=None,
                    help="write the effective config to JSON")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="list ensemble services")
    p.add_argument("source")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--scope", action="store_true",
                   help="render spectrum + constellation scopes (text)")
    p.add_argument("--watch", type=int, default=0, metavar="N",
                   help="live view: redraw after each of N blocks")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("decode", help="decode service(s) to audio/files")
    p.add_argument("source")
    p.add_argument("--service", default=None,
                   help="service label (default: all)")
    p.add_argument("--out", default=None, help="output WAV/AU path")
    p.add_argument("--play", action="store_true",
                   help="play decoded audio live (spawns aplay/ffplay)")
    p.add_argument("--player", default=None, metavar="CMD",
                   help="player command reading S16LE 48k stereo on stdin")
    p.add_argument("--blocks", type=int, default=16)
    p.add_argument("--json", action="store_true",
                   help="print metrics as JSON")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("scan", help="scan channel=file pairs")
    p.add_argument("channels", nargs="+", metavar="CHAN=FILE")
    p.add_argument("--blocks", type=int, default=3)
    p.set_defaults(fn=cmd_scan)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
