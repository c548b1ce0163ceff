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
3. pipeline: the 12 x 96 kbit/s EEP-A ensemble (Mode I, 96 frames, clean
   golden IQ) through ``full_ensemble_pipeline``: every FIB CRC passes and
   every subchannel's logical frames equal the transmitted payload;
4. receiver: ``Receiver.run()`` over a mixed MP2/DAB+ ensemble (u8 upload
   path, 64-frame blocks, audio decode on), and one all-zero block.

The kernels' launch counts are reset just before phases 3-4 and read just
after; each kernel must have run there.  The last two lines are a JSON
object describing each kernel and the result line
``{"ok": true, "device": {...}}``.  Needs no network; uses one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
    import torch
    fn()                                             # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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

    pipe = full_ensemble_pipeline(p, geoms, device=dev)
    ok, bits = pipe(rows)
    ok, bits = ok.cpu().numpy(), bits.cpu().numpy()
    _check(ok.shape == (n_frames, 12) and ok.all(), "FIB CRC failures")
    n_lf = n_frames * p.cifs_per_frame - 15
    _check(bits.shape == (12, n_lf, 2304), f"bits shape {bits.shape}")
    for s in services:
        for t in range(n_lf):
            _check(np.array_equal(bits[s.subch_id, t],
                                  mod.payload_bits(s.subch_id, t)),
                   f"payload mismatch subch {s.subch_id} frame {t}")
    sec = _cuda_ms(lambda: pipe(rows), 5) / 1e3
    rt = n_frames * p.T_F / FS / sec
    print(f"pipeline: 12 subchannels x {n_lf} logical frames exact, "
          f"{ok.size} FIBs pass CRC; {sec:.4f} s per {n_frames}-frame "
          f"batch = {rt:.2f}x realtime")
    report["pipeline"] = dict(seconds_per_batch=sec, realtime=rt)


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
    vc.reset_launches()
    phase_pipeline(dev, report)
    phase_receiver(dev, report)
    torch.cuda.synchronize()
    launches = {"k1": vc.FORWARD_LAUNCHES, "k2": vc.TRACEBACK_LAUNCHES}
    _check(all(n > 0 for n in launches.values()),
           f"main path did not launch every kernel: {launches}")
    print(f"launches on the main path: {launches}")

    src = "dabjax_torch/csrc/viterbi.cu"
    msc = report["msc"]
    kernels = [
        {"name": "viterbi_forward_acs", "route": "cuda", "source": src,
         "replaces": "dabjax/fec/viterbi_pallas.py:85",
         "launches": launches["k1"], "max_abs_err": msc["k1"][0],
         "ms": msc["k1"][1], "plain_ms": msc["k1"][2]},
        {"name": "viterbi_traceback", "route": "cuda", "source": src,
         "replaces": "dabjax/fec/viterbi_pallas.py:218",
         "launches": launches["k2"], "max_abs_err": msc["k2"][0],
         "ms": msc["k2"][1], "plain_ms": msc["k2"][2]},
    ]
    print(json.dumps({"kernels": kernels, "card": card,
                      "pipeline": report["pipeline"],
                      "receiver": report["receiver"],
                      "fic_shape": report["fic"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
