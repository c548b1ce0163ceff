"""Command-line control plane of the torch port: ``python -m dabjax_torch
info|decode|scan`` (port of :mod:`dabjax.cli`, same arguments, plus
``--device``).

Subcommands (the reference's GUI actions, SURVEY.md §2.4):

* ``info``   — tune a source, decode the FIC, print the ensemble/service
               database (the service-list panel).
* ``decode`` — decode one service (or all) to WAV / AU streams, with PAD
               dynamic labels and MOT slides saved alongside.
* ``scan``   — band-scan over channel=file pairs or a live tuner.

Sources are IQ files (.raw u8 / .sdr/.wav float), ``rtl_tcp://host:port``,
a live device, or ``null``.  The source specs, the service-list and scope
printers and the audio player are dabjax's own, copied.  The receiver runs
on the first CUDA card (``--device cuda``, the default; without a card the
CLI stops with a message) or, when asked, on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

__all__ = ["main", "cmd_info", "cmd_decode", "cmd_scan", "open_source"]


def open_source(spec: str, frequency_hz: int = 0):
    """Source by spec: file path, ``null``, ``rtl_tcp://host:port``, or a
    live device ``rtlsdr`` / ``airspy`` / ``sdrplay`` / ``uhd``
    (optionally ``rtlsdr:CHANNEL``, e.g. ``rtlsdr:12C``)."""
    from dabjax_torch.io import sources
    if spec == "null":
        return sources.NullSource()
    if spec.startswith("rtl_tcp://"):
        from dabjax_torch.io.rtl_tcp import RtlTcpSource
        host, _, port = spec[len("rtl_tcp://"):].partition(":")
        src = RtlTcpSource(host, int(port or 1234))
        if frequency_hz:
            src.set_frequency(frequency_hz)
        return src
    dev, _, chan = spec.partition(":")
    if dev in ("rtlsdr", "airspy", "sdrplay", "uhd"):
        from dabjax_torch.io import devices
        from dabjax_torch.runtime.channels import frequency_khz
        if chan:
            frequency_hz = frequency_khz(chan) * 1000
        cls = {"rtlsdr": devices.RtlSdrSource,
               "airspy": devices.AirspySource,
               "sdrplay": devices.SdrplaySource,
               "uhd": devices.UhdSource}[dev]
        try:
            return cls(frequency_hz=frequency_hz)
        except devices.DeviceUnavailable as e:
            raise SystemExit(f"device {dev} unavailable: {e}")
    ext = os.path.splitext(spec)[1].lower()
    if ext == ".raw":
        from dabjax_torch.io import native
        if native.native_available():
            return native.NativeFileSource(spec)   # C++ feeder thread
        return sources.RawFileSource(spec, loop=False)
    if ext in (".sdr", ".wav"):
        return sources.WavFileSource(spec, loop=False)
    raise SystemExit(f"unrecognized source: {spec}")


def _build_receiver(args, service: Optional[str] = None):
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import Receiver
    if getattr(args, "config", None):
        cfg = ReceiverConfig.load(args.config)
        cfg.mode = args.mode
    else:
        cfg = ReceiverConfig(mode=args.mode)
    cfg.service = service
    if getattr(args, "save_config", None):
        cfg.save(args.save_config)
    return Receiver(open_source(args.source), cfg, device=args.device)


def _print_db(r, file=None) -> None:
    db = r.db
    print(f"ensemble: {db.ensemble_label!r} (EId {db.ensemble_id:04X})  "
          f"{r.metrics.dashboard()}", file=file)
    for svc in db.services.values():
        if not svc.has_label:
            continue
        ad = db.data_for_audio_service(svc.label)
        if ad is not None:
            kind = "DAB+" if ad.is_dab_plus else "DAB"
            print(f"  {svc.label:<16} SId={svc.sid:04X} {kind:>6} "
                  f"{ad.bitrate:3d}kbps subch={ad.subch_id:2d} "
                  f"start={ad.start_addr:3d} len={ad.length:3d}CU",
                  file=file)
            continue
        pd = db.data_for_data_service(svc.label)
        if pd is not None:
            print(f"  {svc.label:<16} SId={svc.sid:04X} packet "
                  f"DSCTy={pd.dscty} subch={pd.subch_id:2d} "
                  f"addr={pd.packet_address}", file=file)
    # secondary label planes (FIG 1 ext 3/4/6 — kept queryable here,
    # unlike the reference which parses and discards them)
    for (sid, scids), lbl in sorted(db.component_labels.items()):
        print(f"    component SId={sid:04X}.{scids}: {lbl.strip()!r}",
              file=file)
    for (sid, scids, aid), lbl in sorted(db.xpad_labels.items()):
        print(f"    x-pad SId={sid:04X}.{scids} apptype={aid}: "
              f"{lbl.strip()!r}", file=file)
    for rid, lbl in sorted(db.region_labels.items()):
        print(f"    region {rid:02X}: {lbl.strip()!r}", file=file)


def _print_scopes(r, file=None) -> None:
    from dabjax_torch.runtime.scopes import (render_constellation,
                                             render_spectrum)
    print("spectrum (PRS mean, dB):", file=file)
    print(render_spectrum(r.metrics.spectrum), file=file)
    print("constellation (first data symbol):", file=file)
    print(render_constellation(r.metrics.constellation), file=file)


def cmd_info(args) -> int:
    r = _build_receiver(args)
    if getattr(args, "watch", 0):
        # live dashboard: re-run block batches and redraw (the
        # scope/waterfall loop of the reference GUI, scope.cpp), with the
        # receiver's host time by span under the service list; the
        # waterfall panel keeps the last 12 block spectra (scope.cpp:384
        # scrolling history)
        from collections import deque
        from dabjax_torch.runtime.scopes import render_waterfall
        history = deque(maxlen=12)
        for i in range(args.watch):
            r.run(1)
            print(f"\x1b[2J\x1b[H[block {i + 1}/{args.watch}]")
            if r.metrics.synced:
                history.append(np.asarray(r.metrics.spectrum))
                _print_db(r)
                print(r.profiler.report())
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


def _spawn_player(cmd_override=None):
    """Live audio out: spawn a PCM player (the PortAudio callback sink
    analog, audiosink.cpp:129-220) reading S16LE 48 kHz stereo on stdin."""
    import shutil
    import subprocess
    if cmd_override:
        cmd = cmd_override.split()
    elif shutil.which("aplay"):
        cmd = ["aplay", "-q", "-f", "S16_LE", "-r", "48000", "-c", "2"]
    elif shutil.which("ffplay"):
        cmd = ["ffplay", "-nodisp", "-autoexit", "-loglevel", "quiet",
               "-f", "s16le", "-ar", "48000", "-ac", "2", "-"]
    else:
        return None
    return subprocess.Popen(cmd, stdin=subprocess.PIPE)


def cmd_decode(args) -> int:
    from dabjax_torch.io.audio_out import WavSink
    from dabjax_torch.audio.aac import sample_rate as aac_rate
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
                from dabjax_torch.io.audio_out import PcmPipeSink
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
                from dabjax_torch.io.audio_out import PcmPipeSink
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
    from dabjax_torch.runtime.channels import channel_list
    from dabjax_torch.runtime.config import ReceiverConfig
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
        from dabjax_torch.io.sources import TunedSourceBank
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
              blocks=args.blocks, on_result=show, device=args.device)
    return 0 if found else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dabjax_torch",
        description="DAB/DAB+ receiver on PyTorch and CUDA")
    ap.add_argument("-M", "--mode", type=int, default=1,
                    help="DAB transmission mode (1/2/4)")
    ap.add_argument("-i", "--config", default=None,
                    help="load receiver config JSON (the ini-file analog)")
    ap.add_argument("--save-config", default=None,
                    help="write the effective config to JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run the receiver on the first CUDA card (default) "
                         "or on the CPU")
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
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dabjax_torch: no CUDA card (torch.cuda.is_available() is "
              "false); pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
