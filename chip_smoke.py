#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dabjax_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
Viterbi kernels from ``dabjax_torch/csrc`` (first use, cached by source
hash in ``dabjax_torch/build/``) and then, in phases, stops with a
non-zero exit at the first failure:

1. the card (nvidia-smi name and power limit) and the kernel build;
2. kernels: the CUDA forward ACS (K1) and traceback (K2) against the
   plain torch version and the numpy reference decoder on coded+noise,
   near-tie and pure-noise integer soft bits at nbits 100, 768, 1024,
   2304 and 9216, then at the main-path shapes (MSC: 4428 codewords of
   2304 bits; FIC: 384 of 768), all bit-exact; each timed with CUDA
   events beside its plain version;
3. word kernels: the radix-4 word forward (K3) in the formats i8mxu, i8
   and f32 against its plain torch version (words equal element for
   element) and K3 + the word traceback (K4) against the numpy decoder,
   on the same three inputs at nbits 100, 101, 768, 1024, 2304 and 9216,
   plus f32 soft at +-300; then at the main-path shapes (MSC and FIC, as
   in phase 2) words, ``last`` and bits equal their plain versions, K3 and
   K4 timed there beside them;
4. pipeline: the 12 x 96 kbit/s EEP-A ensemble (Mode I, 96 frames, clean
   golden IQ) through ``full_ensemble_pipeline``: every FIB CRC passes and
   every subchannel's logical frames equal the transmitted payload;
5. receiver: ``Receiver.run()`` over a mixed MP2/DAB+ ensemble (u8 upload
   path, 64-frame blocks, audio decode on), and one all-zero block;
6. formats: the phase-4 ensemble again with ``SOFT_FMT`` i8mxu, then f32
   (K3 + K4 in place of K1 + K2), payload-exact;
7. stages: ``pipeline_stages`` on the phase-4 ensemble under i8lane and
   i8mxu, device ms of each prefix and of each stage;
8. entry points: ``python -m dabjax_torch info`` and ``scan`` in-process
   on a rendered ``.raw`` file, and a 3-channel ``MultiReceiver`` bank
   with one device-to-host copy per block period;
9. trace: ``device_trace`` around one phase-4 batch writes a Chrome trace
   holding the CUDA kernels;
10. probes (``dabjax_torch.tools``, the ports of the TPU probes in
    ``tools/``) at the main-path shape, 4428 codewords of 2304 bits: the
    stage-stripped word forward in its four modes (dot_store, repadd,
    maxtree, full) against its plain version, words equal, and ``full``
    against K3 "i8" on the pair steps < T2; K3 "i8" on prepped input
    against its plain version; the copy kernel and the int8
    decision-plane kernel bit for bit against theirs; the per-step-plane
    forward in its three modes (full, dot_only, no_acs), ksplit on and
    off, against its plain version, plane equal byte for byte, unrolled
    equal to not, chunk 16 equal to chunk 8, the ``full`` plane packed
    16 steps per word equal to K3 "i8" words, ``no_acs`` saturated at
    -128 and 127; the dependent-chain kernels (every dtype and op of
    ``vpu_probe``, every dtype of ``vpu_probe2``, every chain length
    built, integer adds wrapping) bit for bit against their plain
    versions, with the SASS instructions each op adds (none may be 0: a
    folded chain); each timed beside its plain version; then each
    probe's ``main()`` in process, one printed line per case.

The kernels' launch counts are reset just before phases 4-5 (K1, K2),
phase 6 (K3, K4) and the probes' ``main()`` runs of phase 10 (the probe
kernels, and K3 for ``vit_split2``) and read just after; each kernel
must have run there (the plane forward once for ``vit_variants`` and
once for ``vit_split``).
The last two lines are a JSON object describing each kernel and the
result line ``{"ok": true, "device": {...}}``.  Needs no network; uses
one card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FS = 2_048_000


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` by CUDA events after a warm-up call."""
    from dabjax_torch.tools import cuda_ms
    return cuda_ms(fn, reps)


def _soft_cases(nbits: int, rng):
    """(name, soft [B, 4*(nbits+6)]) integer soft bits in +-127."""
    import numpy as np
    from dabjax.fec import conv
    B = 6
    bits = rng.integers(0, 2, (B, nbits), np.uint8)
    coded = np.stack([conv.encode(b) for b in bits]).astype(np.float32)
    clean = (coded * 2 - 1) * 100
    yield "coded", np.clip(clean + np.round(rng.standard_normal(clean.shape)
                                            * 40), -127, 127)
    yield "near_tie", np.clip(clean + np.round(
        rng.standard_normal(clean.shape) * 80), -127, 127)
    yield "pure_noise", rng.integers(-127, 128, clean.shape).astype(
        np.float32)


def phase_kernels(dev, report):
    import numpy as np
    import torch
    from dabjax.fec.viterbi import viterbi_decode_np
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc

    rng = np.random.default_rng(2024)
    for nbits in (100, 768, 1024, 2304, 9216):
        for name, soft in _soft_cases(nbits, rng):
            want = viterbi_decode_np(soft, nbits)
            s = torch.from_numpy(soft).to(dev)
            got = viterbi.viterbi_decode(s, nbits).cpu().numpy()
            plain = viterbi.viterbi_decode_torch(s, nbits).cpu().numpy()
            _check(np.array_equal(got, want),
                   f"kernel != numpy at nbits={nbits} ({name})")
            _check(np.array_equal(plain, want),
                   f"plain != numpy at nbits={nbits} ({name})")
        print(f"kernels: nbits={nbits} coded/near_tie/pure_noise "
              "bit-exact vs numpy and plain torch")

    for label, B, nbits in (("msc", 4428, 2304), ("fic", 384, 768)):
        T = nbits + 6
        soft = torch.from_numpy(rng.integers(-127, 128, (B, T, 4)).astype(
            np.int8)).to(dev)
        dec = vc.viterbi_forward_cuda(soft)
        dec_plain = viterbi.viterbi_forward_torch(soft)
        err_k1 = int((vc.unpack_decisions(dec) != dec_plain).sum())
        bits = vc.viterbi_traceback_cuda(dec, nbits)
        bits_plain = viterbi.viterbi_traceback_torch(
            vc.unpack_decisions(dec), nbits)
        err_k2 = int((bits - bits_plain).abs().max())
        _check(err_k1 == 0, f"K1 decisions differ at {label} shape")
        _check(err_k2 == 0, f"K2 bits differ at {label} shape")
        k1_ms = _cuda_ms(lambda: vc.viterbi_forward_cuda(soft), 10)
        k1_plain = _cuda_ms(lambda: viterbi.viterbi_forward_torch(soft), 1)
        unpacked = vc.unpack_decisions(dec)
        k2_ms = _cuda_ms(lambda: vc.viterbi_traceback_cuda(dec, nbits), 10)
        k2_plain = _cuda_ms(
            lambda: viterbi.viterbi_traceback_torch(unpacked, nbits), 1)
        print(f"kernels: {label} B={B} nbits={nbits}: K1 {k1_ms:.4f} ms "
              f"(plain {k1_plain:.2f} ms), K2 {k2_ms:.4f} ms "
              f"(plain {k2_plain:.2f} ms), bit-exact")
        report[label] = dict(k1=(err_k1, k1_ms, k1_plain),
                             k2=(err_k2, k2_ms, k2_plain))


def phase_words(dev, report):
    import numpy as np
    import torch
    from dabjax.fec.viterbi import viterbi_decode_np
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc

    def k3(s, nbits, fmt):
        return vc.viterbi_forward_words_cuda(vc.pair_soft(s, nbits, fmt),
                                             fmt)

    rng = np.random.default_rng(2025)
    for nbits in (100, 101, 768, 1024, 2304, 9216):
        # coded, near-tie and pure-noise codewords in one batch
        soft = np.concatenate([c for _, c in _soft_cases(nbits, rng)])
        want = viterbi_decode_np(soft, nbits)
        s = torch.from_numpy(soft).to(dev)
        for fmt in vc.WORD_FORMATS:
            words, last = k3(s, nbits, fmt)
            plain_w, plain_l = viterbi.viterbi_forward_words_torch(s, nbits,
                                                                   fmt)
            _check(torch.equal(words, plain_w) and torch.equal(last, plain_l),
                   f"K3 words != plain at nbits={nbits} ({fmt})")
            bits = vc.viterbi_traceback_words_cuda(words, last, nbits)
            _check(np.array_equal(bits.cpu().numpy(), want),
                   f"K3+K4 != numpy at nbits={nbits} ({fmt})")
        print(f"words: nbits={nbits} coded/near_tie/pure_noise: K3 words "
              "equal plain, K3+K4 bits equal numpy (i8mxu, i8, f32)")

    # soft beyond the int8 range: f32 does not clip, i8 does
    for nbits in (101, 768):
        soft = rng.integers(-300, 301, (6, 4 * (nbits + 6))).astype(
            np.float32)
        s = torch.from_numpy(soft).to(dev)
        for fmt, ref in (("f32", soft), ("i8", np.clip(soft, -127, 127))):
            words, last = k3(s, nbits, fmt)
            plain_w, plain_l = viterbi.viterbi_forward_words_torch(s, nbits,
                                                                   fmt)
            _check(torch.equal(words, plain_w) and torch.equal(last, plain_l),
                   f"K3 words != plain at +-300, nbits={nbits} ({fmt})")
            bits = vc.viterbi_traceback_words_cuda(words, last, nbits)
            _check(np.array_equal(bits.cpu().numpy(),
                                  viterbi_decode_np(ref, nbits)),
                   f"K3+K4 != numpy at +-300, nbits={nbits} ({fmt})")
    print("words: +-300 soft: f32 (unclipped) and i8 (clipped) exact")

    # the main-path shapes, as phase_kernels: words, last and bits against
    # the plain versions
    for label, B, nbits in (("msc", 4428, 2304), ("fic", 384, 768)):
        soft = torch.from_numpy(rng.integers(-127, 128, (B, 4 * (nbits + 6)))
                                .astype(np.float32)).to(dev)
        for fmt in vc.WORD_FORMATS:
            x = vc.pair_soft(soft, nbits, fmt)
            words, last = vc.viterbi_forward_words_cuda(x, fmt)
            plain_w, plain_l = viterbi.viterbi_forward_words_torch(
                soft, nbits, fmt)
            err3 = max(int((words.long() - plain_w.long()).abs().max()),
                       int((last - plain_l).abs().max()))
            bits = vc.viterbi_traceback_words_cuda(words, last, nbits)
            plain_bits = viterbi.viterbi_traceback_words_torch(words, last,
                                                               nbits)
            err4 = int((bits - plain_bits).abs().max())
            _check(err3 == 0, f"K3 words differ at the {label} shape ({fmt})")
            _check(err4 == 0, f"K4 bits differ at the {label} shape ({fmt})")
            k3_ms = _cuda_ms(lambda: vc.viterbi_forward_words_cuda(x, fmt),
                             10)
            k3_plain = _cuda_ms(
                lambda: viterbi.viterbi_forward_words_torch(soft, nbits, fmt),
                1)
            k4_ms = _cuda_ms(
                lambda: vc.viterbi_traceback_words_cuda(words, last, nbits),
                10)
            k4_plain = _cuda_ms(
                lambda: viterbi.viterbi_traceback_words_torch(words, last,
                                                              nbits), 1)
            print(f"words: {label} B={B} nbits={nbits} {fmt}: K3 "
                  f"{k3_ms:.4f} ms (plain {k3_plain:.2f} ms), K4 "
                  f"{k4_ms:.4f} ms (plain {k4_plain:.2f} ms), exact")
            report[f"words_{label}_{fmt}"] = dict(
                k3=(err3, k3_ms, k3_plain), k4=(err4, k4_ms, k4_plain))


def _check_ensemble(ok, bits, golden):
    """Every FIB CRC passes and every logical frame equals the payload."""
    import numpy as np
    p, n_frames, mod = golden["p"], golden["n_frames"], golden["mod"]
    ok, bits = ok.cpu().numpy(), bits.cpu().numpy()
    _check(ok.shape == (n_frames, 12) and ok.all(), "FIB CRC failures")
    n_lf = n_frames * p.cifs_per_frame - 15
    _check(bits.shape == (12, n_lf, 2304), f"bits shape {bits.shape}")
    for s in golden["services"]:
        for t in range(n_lf):
            _check(np.array_equal(bits[s.subch_id, t],
                                  mod.payload_bits(s.subch_id, t)),
                   f"payload mismatch subch {s.subch_id} frame {t}")
    return ok.size, n_lf


def phase_pipeline(dev, report):
    import numpy as np
    import torch
    from dabjax.constants import get_mode
    from dabjax.tx.fig import ServiceSpec
    from dabjax_torch import testing
    from dabjax_torch.msc.subchannel import SubchGeometry
    from dabjax_torch.ofdm.demod import min_frame_samples
    from dabjax_torch.runtime.pipeline import full_ensemble_pipeline

    p, n_frames = get_mode(1), 96
    services = [ServiceSpec(label=f"S{i:02d}", sid=0x8100 + i, subch_id=i,
                            start_addr=i * 72, bitrate=96,
                            protection="EEP-A", prot_level=3, kind="DAB+")
                for i in range(12)]
    geoms = tuple(SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                                s.bitrate, s.protection, s.prot_level)
                  for s in services)
    t0 = time.perf_counter()
    mod = testing.golden_modulator(mode=1, services=services)
    iq = mod.iq(n_frames, snr_db=None)
    u0 = p.T_null + p.T_g
    need = min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    rows = torch.from_numpy(rows.view(np.float32).reshape(n_frames, need, 2))
    rows = rows.to(dev)
    print(f"pipeline: golden IQ rendered in {time.perf_counter() - t0:.1f} s")

    golden = dict(p=p, n_frames=n_frames, mod=mod, services=services,
                  geoms=geoms, rows=rows)
    pipe = full_ensemble_pipeline(p, geoms, device=dev)
    n_fib, n_lf = _check_ensemble(*pipe(rows), golden)
    sec = _cuda_ms(lambda: pipe(rows), 5) / 1e3
    rt = n_frames * p.T_F / FS / sec
    print(f"pipeline: 12 subchannels x {n_lf} logical frames exact, "
          f"{n_fib} FIBs pass CRC; {sec:.4f} s per {n_frames}-frame "
          f"batch = {rt:.2f}x realtime")
    report["pipeline"] = dict(seconds_per_batch=sec, realtime=rt)
    return golden


def _loop_iq(services, n_frames):
    """Golden IQ for a mixed MP2/DAB+ ensemble whose payloads repeat every
    120 CIFs, so a loop of ``n_frames`` (a multiple of 30 in Mode I) is
    seamless for the time interleaver and the audio streams."""
    import numpy as np
    import bench
    from dabjax_torch import testing
    payloads = {s.subch_id: (bench._mp2_payload_gen(0) if s.kind == "MP2"
                             else bench._dabplus_payload_gen(s.bitrate, 0))
                for s in services}
    mod = testing.golden_modulator(mode=1, services=services,
                                   payloads=payloads)
    return mod.iq(n_frames, snr_db=None).astype(np.complex64)


def phase_receiver(dev, report):
    import numpy as np
    import torch
    import bench
    from dabjax.constants import get_mode
    from dabjax.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import BlockFn, Receiver

    services = bench._bench_services("mixed")
    t0 = time.perf_counter()
    iq = _loop_iq(services, 60)
    print(f"receiver: loop IQ rendered in {time.perf_counter() - t0:.1f} s")
    rx = Receiver(bench._LoopSource(iq), ReceiverConfig(frames_per_block=64),
                  device=dev)
    try:
        t0 = time.perf_counter()
        m = rx.run(3)
        dt = time.perf_counter() - t0
    finally:
        rx.close()
    print(f"receiver: {m.dashboard()}; 3 blocks in {dt:.2f} s wall")
    _check(m.fic_ratio == 1.0, f"fic_ratio {m.fic_ratio}")
    _check(m.au_ok > 0 and m.au_bad == 0, f"au {m.au_ok}/{m.au_bad}")
    _check(m.mp2_frames_ok > 0, "no MP2 frame decoded")
    p = get_mode(1)
    report["receiver"] = dict(wall_s=dt, signal_s=3 * 64 * p.T_F / FS,
                              au_ok=m.au_ok, mp2_frames_ok=m.mp2_frames_ok)

    # one all-zero block: finite, zero soft bits (subnormal epsilon)
    for kind, fill in (("f32", 0.0), ("u8", 128)):
        fn = BlockFn(p, kind, device=dev)
        dtype = torch.float32 if kind == "f32" else torch.uint8
        rows = torch.full((2, (p.L - 1) * p.T_s + p.T_u, 2), fill,
                          dtype=dtype, device=dev)
        cifs, blob = fn(rows, torch.zeros(2, device=dev))
        _check(bool(torch.isfinite(cifs).all()) and not bool(cifs.any()),
               f"zero block ({kind}) gave non-zero or non-finite soft bits")
        _check(blob.dtype == torch.uint8, "blob dtype")
    print("receiver: all-zero blocks give finite zero soft bits")
    return iq


def phase_formats(dev, report, golden):
    """The phase-4 ensemble with the radix-4 word kernels (K3 + K4)."""
    from dabjax_torch.fec import viterbi_cuda as vc
    from dabjax_torch.runtime.pipeline import full_ensemble_pipeline

    p, n_frames = golden["p"], golden["n_frames"]
    rows = golden["rows"]
    pipe = full_ensemble_pipeline(p, golden["geoms"], device=dev)
    out = {}
    try:
        for fmt in ("i8mxu", "f32"):
            vc.SOFT_FMT = fmt
            before = (vc.FORWARD_LAUNCHES, vc.TRACEBACK_LAUNCHES,
                      vc.WORDS_FORWARD_LAUNCHES, vc.WORDS_TRACEBACK_LAUNCHES)
            n_fib, n_lf = _check_ensemble(*pipe(rows), golden)
            after = (vc.FORWARD_LAUNCHES, vc.TRACEBACK_LAUNCHES,
                     vc.WORDS_FORWARD_LAUNCHES, vc.WORDS_TRACEBACK_LAUNCHES)
            _check(after[:2] == before[:2],
                   f"{fmt}: K1/K2 launched ({before} -> {after})")
            _check(after[2] > before[2] and after[3] > before[3],
                   f"{fmt}: K3/K4 not launched ({before} -> {after})")
            sec = _cuda_ms(lambda: pipe(rows), 5) / 1e3
            print(f"formats: {fmt}: 12 subchannels x {n_lf} logical frames "
                  f"exact, {n_fib} FIBs pass CRC, through K3+K4 only; "
                  f"{sec:.4f} s per {n_frames}-frame batch = "
                  f"{n_frames * p.T_F / FS / sec:.2f}x realtime")
            out[fmt] = dict(seconds_per_batch=sec)
    finally:
        vc.SOFT_FMT = "i8lane"
    report["formats"] = out


def phase_stages(dev, report, golden):
    import math
    from dabjax_torch.fec import viterbi_cuda as vc
    from dabjax_torch.runtime.pipeline import pipeline_stages

    p, rows = golden["p"], golden["rows"]
    out = {}
    try:
        for fmt in ("i8lane", "i8mxu"):
            vc.SOFT_FMT = fmt
            fns = pipeline_stages(p, golden["geoms"], device=dev)
            for name, fn in fns.items():
                v = float(fn(rows))
                _check(math.isfinite(v), f"stage {name} ({fmt}) gave {v}")
            ms = {name: _cuda_ms(lambda f=fn: f(rows), 5)
                  for name, fn in fns.items()}
            stages = {
                "demod": ms["demod"],
                "fic": ms["fic"] - ms["demod"],
                "deint_depunct": ms["deint_depunct"] - ms["fic"],
                "viterbi_forward": ms["viterbi_forward"] - ms["deint_depunct"],
                "traceback_dispersal": ms["full"] - ms["viterbi_forward"]}
            print(f"stages ({fmt}): prefix ms " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items()))
            print(f"stages ({fmt}): stage ms " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()))
            out[fmt] = dict(prefix_ms=ms, stage_ms=stages)
    finally:
        vc.SOFT_FMT = "i8lane"
    report["stages"] = out


def phase_entry(dev, report, loop_iq):
    import numpy as np
    import bench
    from dabjax.runtime.config import ReceiverConfig
    from dabjax.tx.fig import ServiceSpec
    from dabjax_torch import cli, testing
    from dabjax_torch.parallel.multihost import MultiReceiver

    services = [ServiceSpec(label="SMOKE MP2", sid=0x9101, subch_id=1,
                            start_addr=0, bitrate=96, protection="EEP-A",
                            prot_level=3, kind="DAB"),
                ServiceSpec(label="SMOKE PLUS", sid=0x9102, subch_id=2,
                            start_addr=72, bitrate=96, protection="EEP-A",
                            prot_level=3, kind="DAB+")]
    mod = testing.golden_modulator(mode=1, services=services,
                                   ensemble_label="SMOKE ENSEMBLE",
                                   amplitude=0.3)
    iq = mod.iq(12, snr_db=40.0, seed=1)
    u8 = np.empty(2 * iq.shape[0], np.uint8)
    u8[0::2] = np.clip(np.real(iq) * 128 + 128, 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.imag(iq) * 128 + 128, 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "smoke.raw")
        with open(raw, "wb") as f:
            f.write(u8.tobytes())
        for argv in (["info", raw, "--blocks", "2"],
                     ["scan", f"12C={raw}", "5A=null", "--blocks", "2"]):
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                rc = cli.main(argv)
            text = buf.getvalue()
            print("\n".join(f"cli {argv[0]}: {line}"
                            for line in text.splitlines()))
            _check(rc == 0, f"cli {argv[0]} exited {rc}")
            if argv[0] == "info":
                _check("'SMOKE ENSEMBLE'" in text and "SMOKE MP2" in text
                       and "SMOKE PLUS" in text, "info: service list")
            else:
                _check("12C: 'SMOKE ENSEMBLE' (2 services" in text
                       and "5A: no signal" in text, "scan: results")

    bank = MultiReceiver({f"ch{i}": bench._LoopSource(loop_iq)
                          for i in range(3)},
                         ReceiverConfig(frames_per_block=64), device=dev)
    pulls = []
    pull = bank._pull

    def counted(blob):
        pulls.append(int(blob.shape[0]))
        return pull(blob)

    bank._pull = counted
    try:
        t0 = time.perf_counter()
        metrics = bank.run(3)
        dt = time.perf_counter() - t0
    finally:
        bank.close()
    for name, m in metrics.items():
        _check(m.fic_ratio == 1.0, f"bank {name}: fic_ratio {m.fic_ratio}")
        _check(m.au_ok > 0 and m.au_bad == 0, f"bank {name}: au")
    _check(len(pulls) == 3, f"bank: {len(pulls)} pulls for 3 blocks")
    print(f"bank: 3 channels x 3 blocks in {dt:.2f} s wall, fic 100 %, "
          f"one pull per block ({pulls[0]} bytes)")
    report["bank"] = dict(wall_s=dt, pulls=len(pulls))


def phase_trace(dev, report, golden):
    import torch
    from dabjax_torch.runtime.pipeline import full_ensemble_pipeline
    from dabjax_torch.runtime.profiling import device_trace

    pipe = full_ensemble_pipeline(golden["p"], golden["geoms"], device=dev)
    rows = golden["rows"]
    pipe(rows)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as prof:
            pipe(rows)
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = " ".join(e.get("name", "") for e in kernels)
    _check(kernels and "forward_acs" in names and "traceback" in names,
           "trace holds no Viterbi kernel events")
    busy = sum(float(e.get("dur", 0.0)) for e in kernels) / 1e3
    print(f"trace: {len(kernels)} CUDA kernel events, {busy:.3f} ms of "
          "kernel time in one batch")
    report["trace"] = dict(kernel_events=len(kernels), kernel_ms=busy)


def _probe_checks(dev, report):
    """Phase 10, checks: every probe kernel against its plain version at
    the main-path shape, each timed beside it."""
    import torch
    from dabjax_torch import tools
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc
    from dabjax_torch.tools import hbm_probe, vit_split2
    from dabjax_torch.tools import vit_variants2 as vv2

    B, nbits = tools.CODEWORDS, tools.NBITS
    T2 = -(-(nbits + 6) // 2)
    soft = torch.from_numpy(tools.soft_bits(B, nbits, seed=7)).to(dev)

    def err(a, b):
        return int((a.long() - b.long()).abs().max())

    # vit_variants2: each stage against its plain version, full against K3
    x = vv2.padded_pair_soft(soft, nbits)
    modes, stage_err = {}, 0
    for mode in vv2.MODES:
        e = err(vv2.forward_words_stage_cuda(x, mode),
                vv2.forward_words_stage_torch(x, mode))
        _check(e == 0, f"vit_variants2 {mode}: words differ from plain")
        stage_err = max(stage_err, e)
        modes[mode] = dict(
            ms=_cuda_ms(lambda: vv2.forward_words_stage_cuda(x, mode), 10),
            plain_ms=_cuda_ms(lambda: vv2.forward_words_stage_torch(x, mode),
                              1))
        print(f"probes: vit_variants2 {mode}: {modes[mode]['ms']:.4f} ms "
              f"(plain {modes[mode]['plain_ms']:.2f} ms), exact")
    k3_words, _ = vc.viterbi_forward_words_cuda(
        vit_split2.prep(soft, nbits), "i8")
    full = vv2.forward_words_stage_cuda(x, "full")
    _check(torch.equal(vv2.mask_padding(full, T2), k3_words),
           "vit_variants2 full != K3 i8 words on pair steps < T2")
    print(f"probes: vit_variants2 full equals K3 i8 on the {T2} pair "
          f"steps < T2 (of {x.shape[1]})")
    report["vit_variants2"] = dict(err=stage_err, modes=modes)

    # vit_split2: K3 i8 on prepped input against its plain version
    words, last = vit_split2.kernel_only(vit_split2.prep(soft, nbits))
    plain_w, plain_l = viterbi.viterbi_forward_words_torch(soft, nbits, "i8")
    e = max(err(words, plain_w), err(last, plain_l))
    _check(e == 0, "vit_split2: K3 i8 on prepped input != plain")
    xp = vit_split2.prep(soft, nbits)
    split = dict(
        err=e, prep_ms=_cuda_ms(lambda: vit_split2.prep(soft, nbits), 10),
        ms=_cuda_ms(lambda: vit_split2.kernel_only(xp), 10),
        full_ms=_cuda_ms(lambda: vit_split2.full_forward(soft, nbits), 10),
        plain_ms=_cuda_ms(lambda: viterbi.viterbi_forward_words_torch(
            soft, nbits, "i8"), 1))
    print(f"probes: vit_split2: prep {split['prep_ms']:.4f} ms, kernel "
          f"{split['ms']:.4f} ms, full {split['full_ms']:.4f} ms (plain "
          f"{split['plain_ms']:.2f} ms), exact")
    report["vit_split2"] = split

    _plane_checks(report, soft, k3_words)
    _chain_checks(dev, report)

    # hbm_probe: copy and plane bit for bit
    xb = hbm_probe.input_block().to(dev)
    xb += torch.rand_like(xb)                # arbitrary floats for the copy
    got, want = hbm_probe.scale_copy_cuda(xb), hbm_probe.scale_copy_torch(xb)
    e_copy = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    _check(e_copy == 0, f"copy kernel: {e_copy} words differ from x * 1.000001")
    xb = hbm_probe.input_block(seed=8).to(dev)
    e_plane = err(hbm_probe.decision_plane_cuda(xb),
                  hbm_probe.decision_plane_torch(xb))
    _check(e_plane == 0, "decision plane differs from its plain version")
    n = xb.numel()
    plane_bytes = n // 16 * hbm_probe.PLANE_ROWS
    for key, fn, plain, nbytes, e in (
            ("copy", hbm_probe.scale_copy_cuda, hbm_probe.scale_copy_torch,
             8 * n, e_copy),
            ("plane", hbm_probe.decision_plane_cuda,
             hbm_probe.decision_plane_torch, plane_bytes, e_plane)):
        ms = _cuda_ms(lambda: fn(xb), 10)
        plain_ms = _cuda_ms(lambda: plain(xb), 10)
        report[f"hbm_{key}"] = dict(err=e, ms=ms, plain_ms=plain_ms,
                                    gb_per_s=nbytes / ms / 1e6,
                                    plain_gb_per_s=nbytes / plain_ms / 1e6)
        print(f"probes: hbm {key}: {ms:.4f} ms = {nbytes / ms / 1e6:.1f} "
              f"GB/s (plain {plain_ms:.4f} ms), bit for bit")


def _plane_checks(report, soft, k3_words):
    """Phase 10, planes: the per-step-plane forward in every mode, ksplit
    on and off, against its plain version bit for bit; unrolled against
    not; chunk 16 against chunk 8; the ``full`` plane packed 16 steps per
    word against K3 "i8" words; ``no_acs`` saturated at both ends."""
    import torch
    from dabjax_torch import tools
    from dabjax_torch.tools import vit_split, vit_variants as vv

    nbits = tools.NBITS
    T2, Tp2 = vv.pair_steps(nbits)
    modes, plane_err, full = {}, 0, None
    for ksplit in (True, False):
        x = vv.plane_soft(soft, nbits, 8, ksplit)
        for mode in vv.MODES:
            plane = vv.forward_plane_cuda(x, T2, mode)
            e = int((plane.int() - vv.forward_plane_torch(x, T2, mode).int())
                    .abs().max())
            _check(e == 0, f"forward_plane {mode} (ksplit {ksplit}) differs "
                   "from plain")
            plane_err = max(plane_err, e)
            _check(torch.equal(vv.forward_plane_cuda(x, T2, mode, unroll=True),
                               plane),
                   f"forward_plane {mode} (ksplit {ksplit}): unroll 1 != 0")
            if mode == "full":
                _check(torch.equal(vv.pack_words(plane), k3_words),
                       f"full plane (ksplit {ksplit}) != K3 i8 words")
                if ksplit:
                    full = plane
            if mode == "no_acs":
                _check(bool((plane == -128).any() and (plane == 127).any()),
                       "no_acs plane holds not both -128 and 127")
            # the plain version timed at ksplit on (the probe's default)
            key = mode if ksplit else f"{mode}_k8"
            modes[key] = dict(
                ms=_cuda_ms(lambda: vv.forward_plane_cuda(x, T2, mode), 10),
                unroll_ms=_cuda_ms(lambda: vv.forward_plane_cuda(
                    x, T2, mode, unroll=True), 10))
            if ksplit:
                modes[key]["plain_ms"] = _cuda_ms(
                    lambda: vv.forward_plane_torch(x, T2, mode), 1)
            print(f"probes: vit_variants {key}: {modes[key]['ms']:.4f} ms, "
                  f"unrolled {modes[key]['unroll_ms']:.4f} ms" +
                  (f" (plain {modes[key]['plain_ms']:.2f} ms)" if ksplit
                   else "") + ", exact")
        print(f"probes: vit_variants ksplit={ksplit}: three modes equal "
              "plain, unroll 0 = 1, full packs to K3 i8, no_acs saturates")
    report["vit_variants"] = dict(err=plane_err, modes=modes)

    # vit_split: chunk 8 and 16, unrolled or not; the padding steps of
    # chunk 16 (past T2) are 0
    split = dict(err=plane_err, prep_ms={}, ms={})
    for chunk in vv.CHUNKS:
        split["prep_ms"][chunk] = _cuda_ms(
            lambda: vit_split.preprocess(soft, nbits, chunk), 10)
        x = vit_split.preprocess(soft, nbits, chunk)
        for unroll in (False, True):
            plane = vit_split.fwd(x, T2, chunk, unroll)
            _check(torch.equal(plane[:Tp2], full)
                   and not bool(plane[Tp2:].any()),
                   f"vit_split C={chunk} unroll={unroll} != the C=8 plane")
            split["ms"][f"C{chunk}_unroll{int(unroll)}"] = _cuda_ms(
                lambda: vit_split.fwd(x, T2, chunk, unroll), 10)
    split["plain_ms"] = modes["full"]["plain_ms"]
    print(f"probes: vit_split: prep ms {split['prep_ms']}, kernel ms "
          f"{split['ms']}, exact")
    report["vit_split"] = split


def _chain_checks(dev, report):
    """Phase 10, chains: every dtype x op of ``vpu_probe`` and every dtype
    of ``vpu_probe2`` against their plain versions bit for bit at every
    chain length built (integer adds wrap to 0 at the long ones); per-op
    us from the slopes; the SASS instructions each op adds."""
    import torch
    from dabjax_torch.tools import vpu_probe, vpu_probe2

    def compare(got, want, what):
        same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        _check(same, f"{what}: kernel differs from plain")
        d = (got.double() - want.double()).abs()
        return float(torch.nan_to_num(d, nan=0.0).max())

    sass = dict(chain=vpu_probe.sass_op_counts(),
                chain_long=vpu_probe.sass_op_counts(512, 2048),
                pair=vpu_probe2.sass_op_counts(),
                pair_long=vpu_probe2.sass_op_counts(512, 2048))
    for key in ("chain", "chain_long"):
        _check(all(c > 0 for ops in sass[key].values() for c in ops.values()),
               f"a chain was folded ({key}): {sass[key]}")
    for key in ("pair", "pair_long"):
        _check(all(c > 0 for c in sass[key].values()),
               f"a pair chain was folded ({key}): {sass[key]}")
    print(f"probes: SASS per op, chain n 8->64 {sass['chain']}; pair n "
          f"16->96 {sass['pair']}")

    chain, chain_err = {}, 0.0
    for dtype in vpu_probe.DTYPES:
        x = vpu_probe.tile(dtype, seed=9).to(dev)
        for op in vpu_probe.OPS:
            nonzero = []
            for n in vpu_probe.CHAIN_NS:
                got = vpu_probe.elementwise_chain_cuda(x, op, n)
                chain_err = max(chain_err, compare(
                    got, vpu_probe.elementwise_chain_torch(x, op, n),
                    f"vpu_probe {dtype} {op} n={n}"))
                nonzero.append(bool(got.ne(0).any()))
            _check(nonzero[0], f"vpu_probe {dtype} {op}: all zero at n=3")
            _check(op != "add" or dtype[:3] != "int" or not nonzero[-1],
                   f"vpu_probe {dtype} add: did not wrap to 0")
            chain.setdefault(dtype, {})[op] = dict(
                vpu_probe.rates(x, op), sass=sass["chain"][dtype][op],
                sass_long=sass["chain_long"][dtype][op])
        print(f"probes: vpu_probe {dtype}: add/max/mix at n "
              f"{vpu_probe.CHAIN_NS} bit for bit; us/op (n 512->2048) " +
              ", ".join(f"{op} {r['long_us']:.4f}"
                        for op, r in chain[dtype].items()))
    x = vpu_probe.tile("float32", seed=9).to(dev)
    report["vpu_probe"] = dict(
        err=chain_err, per_op=chain,
        ms=_cuda_ms(lambda: vpu_probe.elementwise_chain_cuda(x, "mix", 64),
                    100),
        plain_ms=_cuda_ms(
            lambda: vpu_probe.elementwise_chain_torch(x, "mix", 64), 3))

    pair, pair_err = {}, 0.0
    for dtype in vpu_probe2.DTYPES:
        x, y = (t.to(dev) for t in vpu_probe2.pair_tiles(dtype, seed=9))
        for n in vpu_probe2.PAIR_NS:
            got = vpu_probe2.pair_chain_cuda(x, y, n)
            pair_err = max(pair_err, compare(
                got, vpu_probe2.pair_chain_torch(x, y, n),
                f"vpu_probe2 {dtype} n={n}"))
            _check(bool(got.ne(x).any()), f"vpu_probe2 {dtype} n={n}: v == x")
        pair[dtype] = dict(vpu_probe2.rates(x, y), sass=sass["pair"][dtype],
                           sass_long=sass["pair_long"][dtype])
        print(f"probes: vpu_probe2 {dtype}: n {vpu_probe2.PAIR_NS} bit for "
              f"bit; us/op (n 512->2048) {pair[dtype]['long_us']:.4f}")
    x, y = (t.to(dev) for t in vpu_probe2.pair_tiles("float32", seed=9))
    report["vpu_probe2"] = dict(
        err=pair_err, per_op=pair,
        ms=_cuda_ms(lambda: vpu_probe2.pair_chain_cuda(x, y, 96), 100),
        plain_ms=_cuda_ms(lambda: vpu_probe2.pair_chain_torch(x, y, 96), 3))


def phase_probes(dev, report):
    """Phase 10: the probe kernels checked, then each probe's main() run
    in process with the launch counts set to 0 just before."""
    import torch
    from dabjax_torch.fec import viterbi_cuda as vc
    from dabjax_torch.tools import (hbm_probe, vit_split, vit_split2,
                                    vit_variants, vpu_probe, vpu_probe2)
    from dabjax_torch.tools import vit_variants2 as vv2

    _probe_checks(dev, report)
    # (module, printed lines, what each line holds)
    cases = [(vv2, 2 * len(vv2.MODES), " ms"), (vit_split2, 4, " ms"),
             (hbm_probe, 4, " ms"),
             (vit_variants, 2 * len(vit_variants.MODES), " ms"),
             (vit_split, 3 * len(vit_variants.CHUNKS) + 1, " ms"),
             (vpu_probe, 2 * len(vpu_probe.DTYPES) * len(vpu_probe.OPS),
              "us/op"),
             (vpu_probe2, 2 * len(vpu_probe2.DTYPES), "us/op")]
    torch.cuda.synchronize()
    for mod in (vc, vv2, hbm_probe, vit_variants, vpu_probe, vpu_probe2):
        mod.reset_launches()
    plane_launches = {}
    for mod, n_cases, unit in cases:
        name = mod.__name__.rsplit(".", 1)[1]
        before = vit_variants.LAUNCHES
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = mod.main()
        plane_launches[name] = vit_variants.LAUNCHES - before
        lines = buf.getvalue().splitlines()
        print("\n".join(f"probe {name}: {line}" for line in lines))
        _check(rc == 0, f"{name}.main() returned {rc}")
        _check(len(lines) == n_cases and all(unit in s for s in lines),
               f"{name}.main() printed {len(lines)} lines, not {n_cases}")
    torch.cuda.synchronize()
    launches = {"vit_variants2": vv2.LAUNCHES,
                "vit_split2": vc.WORDS_FORWARD_LAUNCHES,
                "hbm_copy": hbm_probe.COPY_LAUNCHES,
                "hbm_plane": hbm_probe.PLANE_LAUNCHES,
                "vit_variants": plane_launches["vit_variants"],
                "vit_split": plane_launches["vit_split"],
                "vpu_probe": vpu_probe.LAUNCHES,
                "vpu_probe2": vpu_probe2.LAUNCHES}
    _check(all(n > 0 for n in launches.values()),
           f"the probes did not launch every kernel: {launches}")
    print(f"launches of the probes' main(): {launches}")
    report["probe_launches"] = launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dabjax_torch")):
        return _fail("run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        return _fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dabjax_torch import _build
    from dabjax_torch.fec import viterbi_cuda as vc
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")

    report = {}
    phase_kernels(dev, report)
    phase_words(dev, report)
    vc.reset_launches()
    golden = phase_pipeline(dev, report)
    loop_iq = phase_receiver(dev, report)
    torch.cuda.synchronize()
    launches = {"k1": vc.FORWARD_LAUNCHES, "k2": vc.TRACEBACK_LAUNCHES}
    _check(all(n > 0 for n in launches.values()),
           f"main path did not launch every kernel: {launches}")
    vc.reset_launches()
    phase_formats(dev, report, golden)
    torch.cuda.synchronize()
    launches.update(k3=vc.WORDS_FORWARD_LAUNCHES,
                    k4=vc.WORDS_TRACEBACK_LAUNCHES)
    _check(launches["k3"] > 0 and launches["k4"] > 0,
           f"the word-format path did not launch K3/K4: {launches}")
    print(f"launches on the main path: {launches}")
    phase_stages(dev, report, golden)
    phase_entry(dev, report, loop_iq)
    phase_trace(dev, report, golden)
    phase_probes(dev, report)

    src = "dabjax_torch/csrc/viterbi.cu"
    # times at the MSC shape (i8mxu for K3/K4); errors the largest over
    # both main-path shapes (and every word format)
    msc, words = report["msc"], report["words_msc_i8mxu"]
    checked = {"k1": [report["msc"], report["fic"]],
               "k2": [report["msc"], report["fic"]],
               "k3": [report[f"words_{s}_{f}"] for s in ("msc", "fic")
                      for f in vc.WORD_FORMATS]}
    checked["k4"] = checked["k3"]
    err = {k: max(r[k][0] for r in rs) for k, rs in checked.items()}
    kernels = [
        {"name": "viterbi_forward_acs", "route": "cuda", "source": src,
         "replaces": "dabjax/fec/viterbi_pallas.py:85",
         "launches": launches["k1"], "max_abs_err": err["k1"],
         "ms": msc["k1"][1], "plain_ms": msc["k1"][2]},
        {"name": "viterbi_traceback", "route": "cuda", "source": src,
         "replaces": "dabjax/fec/viterbi_pallas.py:218",
         "launches": launches["k2"], "max_abs_err": err["k2"],
         "ms": msc["k2"][1], "plain_ms": msc["k2"][2]},
        {"name": "viterbi_forward_acs_words", "route": "cuda", "source": src,
         "replaces": "dabjax/fec/viterbi_pallas.py:149",
         "launches": launches["k3"], "max_abs_err": err["k3"],
         "ms": words["k3"][1], "plain_ms": words["k3"][2]},
        {"name": "viterbi_traceback_words", "route": "cuda", "source": src,
         "replaces": "dabjax/fec/viterbi_pallas.py:218",
         "launches": launches["k4"], "max_abs_err": err["k4"],
         "ms": words["k4"][1], "plain_ms": words["k4"][2]},
    ]
    probes, pl = "dabjax_torch/csrc/probes.cu", report["probe_launches"]
    stages, split = report["vit_variants2"], report["vit_split2"]
    kernels += [
        {"name": "forward_words_stage", "route": "cuda", "source": probes,
         "replaces": "tools/vit_variants2.py:47",
         "launches": pl["vit_variants2"], "max_abs_err": stages["err"],
         "ms": stages["modes"]["full"]["ms"],
         "plain_ms": stages["modes"]["full"]["plain_ms"],
         "modes": stages["modes"]},
        {"name": "viterbi_forward_acs_words_i8_prepped", "route": "cuda",
         "source": src, "replaces": "tools/vit_split2.py:54",
         "launches": pl["vit_split2"], "max_abs_err": split["err"],
         "ms": split["ms"], "plain_ms": split["plain_ms"],
         "prep_ms": split["prep_ms"], "full_ms": split["full_ms"]},
    ]
    for key, line, name in (("copy", 43, "scale_copy"),
                            ("plane", 69, "decision_plane")):
        r = report[f"hbm_{key}"]
        kernels.append(
            {"name": name, "route": "cuda", "source": probes,
             "replaces": f"tools/hbm_probe.py:{line}",
             "launches": pl[f"hbm_{key}"], "max_abs_err": r["err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "gb_per_s": r["gb_per_s"], "plain_gb_per_s": r["plain_gb_per_s"]})
    # the plane forward: full mode, ksplit, C = 8; the chains: one launch
    # at the TPU probe's longest chain (float32 mix n 64, pair n 96), the
    # per-op us of every dtype in the sub-object
    plane, split = report["vit_variants"], report["vit_split"]
    chains = "dabjax_torch/csrc/chains.cu"
    kernels += [
        {"name": "forward_plane", "route": "cuda", "source": probes,
         "replaces": "tools/vit_variants.py:38",
         "launches": pl["vit_variants"], "max_abs_err": plane["err"],
         "ms": plane["modes"]["full"]["ms"],
         "plain_ms": plane["modes"]["full"]["plain_ms"],
         "modes": plane["modes"]},
        {"name": "forward_plane_full", "route": "cuda", "source": probes,
         "replaces": "tools/vit_split.py:59",
         "launches": pl["vit_split"], "max_abs_err": split["err"],
         "ms": split["ms"]["C8_unroll0"], "plain_ms": split["plain_ms"],
         "unroll_ms": split["ms"], "prep_ms": split["prep_ms"]},
    ]
    for name, key, line in (("elementwise_chain", "vpu_probe", 39),
                            ("pair_chain", "vpu_probe2", 37)):
        r = report[key]
        kernels.append(
            {"name": name, "route": "cuda", "source": chains,
             "replaces": f"tools/{key}.py:{line}", "launches": pl[key],
             "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "per_op_us": r["per_op"]})
    print(json.dumps({"kernels": kernels, "card": card,
                      "pipeline": report["pipeline"],
                      "receiver": report["receiver"],
                      "fic_shape": report["fic"],
                      "word_formats": {f"{s}_{f}": report[f"words_{s}_{f}"]
                                       for s in ("msc", "fic")
                                       for f in vc.WORD_FORMATS},
                      "formats": report["formats"],
                      "stages": report["stages"],
                      "bank": report["bank"], "trace": report["trace"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
