#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dabjax_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
Viterbi kernels from ``dabjax_torch/csrc`` (first use, cached by source
hash in ``dabjax_torch/build/``) and then, in phases, stops with a
non-zero exit at the first failure:

1. the card (nvidia-smi name and power limit; its SM clock and maximum
   under a device sleep) and the kernel build;
2. kernels: the CUDA forward ACS (K1) and traceback (K2) on coded+noise,
   near-tie, pure-noise and saturated (a codeword all +127 or all -127)
   integer soft bits at nbits 100, 101, 768, 2304 and 9216 and batches of
   1, 3, 4, 5, 31, 33, 384 and 4428 codewords: K1 against its plain torch
   version (int32 metrics) decision for decision, K2 against its plain
   version on K1's decisions, K1 + K2 against the numpy reference decoder
   (every batch up to 5 codewords, and the others of 1, 31, 33, 384 and
   4428 but 4428 x 9216 and the saturated ones), all bit-exact; the
   shuffles a step in K1's SASS (fewer than the first K1's 5); on every
   input of that grid also the radix-4 word forward (K3) in the formats
   i8mxu, i8 and f32 against its plain version (words and ``last``) and
   K3 + the word traceback (K4) against the numpy decoder where K1 + K2
   is checked against it, else against K1 + K2's bits; then at the
   main-path shapes (MSC: 4428 codewords of 2304 bits; FIC: 384 of 768)
   K1 and K2 against their plain versions, each timed with CUDA events
   beside it (the median and spread of 5 runs), and the run fails if K1
   takes more than 0.25 ms or K2 more than 0.060 ms at the MSC shape;
3. word kernels: K3 in each word format against its plain torch version
   (words equal element for element) and K3 + K4 against the numpy
   decoder, on coded, near-tie and pure-noise input at nbits 100, 101,
   768, 1024, 2304 and 9216, plus soft at +-300 (f32 unclipped, i8
   clipped); then at the main-path shapes words, ``last`` and bits equal
   their plain versions, K3 and K4 timed there beside them (the median
   and spread of 5 runs), and the run fails at the MSC shape if K3 takes
   more than 0.37 ms (i8mxu, i8) or 0.48 ms (f32), or K4 more than 0.10
   ms on any format's words; K3's SASS shuffles and votes;
4. pipeline: the 12 x 96 kbit/s EEP-A ensemble (Mode I, 96 frames, clean
   golden IQ) through ``full_ensemble_pipeline``: every FIB CRC passes and
   every subchannel's logical frames equal the transmitted payload; K1's
   and K2's launches in one batch (2 and 2), what the batch clips and
   casts to int8 (the CIF block and the FIC stream, not the MSC
   codewords' full-rate stream), and its time (the median of 10 runs;
   the run fails if the least of them is above 3.75 ms);
5. receiver: ``Receiver.run()`` over a mixed MP2/DAB+ ensemble (u8 upload
   path, 64-frame blocks, audio decode on), then the same blocks with the
   audio decoded in one spawned worker process (``audio_workers=1``: the
   same AU, superframe, RS and MP2 counters, summed over the services),
   and one all-zero block;
6. formats: the phase-4 ensemble again with ``SOFT_FMT`` i8mxu, then f32
   (K3 + K4 in place of K1 + K2), payload-exact, timed as in phase 4;
   the run fails if the least of the i8mxu runs is above 3.6 ms;
7. stages: ``pipeline_stages`` on the phase-4 ensemble under i8lane and
   i8mxu, device ms of each prefix (enqueued behind a device sleep, so
   the host's issue rate does not enter) and of each stage, the median
   and spread of 5 rounds; the run fails if the median
   ``traceback_dispersal`` stage is not above 0;
8. entry points: ``python -m dabjax_torch info`` and ``scan`` in-process
   on a rendered ``.raw`` file, and a 3-channel ``MultiReceiver`` bank
   with one device-to-host copy per block period;
9. trace: ``device_trace`` around one phase-4 batch writes a Chrome trace
   holding the CUDA kernels;
10. probes (``dabjax_torch.tools``, the ports of the TPU probes in
    ``tools/``) at the main-path shape, 4428 codewords of 2304 bits: the
    stage-stripped word forward (P1) in its four modes (dot_store,
    repadd, maxtree, and full, which is K3 "i8" on the padded input)
    against its plain version, words equal, and ``full`` against K3 "i8"
    on the pair steps < T2, each mode's median of 5 runs of 10 calls
    beside its earlier design's time, its plain version and its bound,
    the run failing if ``maxtree`` takes more than 0.48 ms or ``full``
    more than 0.44 ms; K3 "i8" on prepped input against its plain version; the
    copy kernel and the int8 decision-plane kernel bit for bit against
    theirs (the plane on the seed-8 input and on one whose 8-step blocks
    start with 300, -200.5, +-inf, NaN, 127.9, -128.9 and -0.7, saturated
    as XLA casts); the per-step-plane forward (P4) in its three modes (full,
    dot_only, no_acs) x ksplit on and off x chunk 8 and 16 x unroll 0
    and 1 against its plain version, plane equal byte for byte, the
    ``full`` plane packed 16 steps per word equal to K3 "i8" words,
    ``no_acs`` saturated at -128 and 127, ``vit_split``'s chunk 16 plane
    equal to chunk 8's, each mode at chunk 8 timed as P1's, the run
    failing if ``full`` (ksplit) takes more than 0.60 ms; the
    dependent-chain kernels (every dtype and op of
    ``vpu_probe``, every dtype of ``vpu_probe2``, every chain length
    built, integer adds wrapping) bit for bit against their plain
    versions, with the SASS instructions each op adds (none may be 0: a
    folded chain), a call of each timed on the device (behind a device
    sleep, ``tools.device_ms``) beside the host's issue time; the
    dot-shape kernels (the step loop in every case of
    ``vit_dotshapes``' main() at both lane counts, the batched product in
    f32 and bf16, the chained dots of ``vpu_probe2`` at its three shapes)
    against their plain versions, within ``vit_dotshapes.DOT_TOL`` on
    the TPU probes' standard-normal inputs and bit for bit on integer
    inputs, with the FFMA of one f32 step and one dot and the HGMMA of one
    bf16 ring stage (each at least the products its thread tile or
    warpgroup must compute); each timed beside its plain version and a
    library call: the step loop (f32 and bf16, per step) beside one GEMM
    of the whole loop, ``[S ... S] @ X.view(16 steps, LB)``
    (``torch.matmul`` in f32, ``torch.mm`` with f32 out in bf16; per step
    by the same slope) and one such call of a single step, the bf16 one
    also past the L2 (512 -> 2048 steps); the batched product also at a
    tail width, N 4488, and beside ``torch.mm`` with f32 out, its bf16
    kernel's HGMMA counted in the SASS; the chained dots beside one
    ``torch.matmul`` of a dot; the
    run failing if the step loop (f32 or bf16, K 16, LB 4480) or the
    [256, 8] chained dots take more than ``DOT_GATES_US`` per step or
    per dot (medians of 5 slopes, beside the SM clock); the copy kernel
    against ``torch.mul`` and the plane kernel against one ``fill_`` of
    the plane over 7 interleaved runs each (the plane's by events and
    again by device time), the run failing if the plane kernel's median
    is above 1.05x that of ``fill_`` of the host int in the same runs by
    either timer; then each probe's ``main()``
    in process, one printed line per case;
11. mesh: the multi-device path (``dabjax_torch.parallel``) on a (2, 4)
    mesh whose 8 positions are all the one card: the sharded step on
    phase 4's rows (48 frames and 192 CIFs a time row, 3 subchannels a
    position) under i8lane and i8mxu, FIC ratio 1.0, ``bits[:, 15:]``
    equal to phase 4's bits and the payload, time row 1's 15 halo outputs
    equal to phase 4's at the same CIFs, time row 0's equal to the decode
    over a zero history (the int8 soft bits of its 48-frame demod counted
    against the whole batch's), K1 + K2 (i8lane) or K3 + K4 (i8mxu) launched 10
    times each (2 FIC and 8 MSC decodes); 10 repeats equal to the first,
    the median wall ms gated at 20 ms; ``Receiver(mesh=...)`` against the
    single-device ``Receiver`` on phase 5's ensemble (3 blocks of 64
    frames, audio off), every logical frame bit-identical; every K1-K4
    launch of the step's first runs and of the mesh ``Receiver``'s first
    run held against its plain version at the shape the mesh gave it;
    the device ms of the mesh MSC chain with pad rows;
    ``dryrun_multichip``;
12. demod: the demod kernels (``csrc/demod.cu``: ``guard_corr``,
    ``mix_windows``, ``dqpsk_soft``) at the core cell's shape (360 frames
    of mode I) on u8 rows of phase 4's golden IQ, each frame shifted by a
    known fine CFO: windows, soft bits, CIF block and PRS spectrum equal
    the plain chain's bit for bit given the same CFO; the fine CFO no
    further from a float64 sum than the plain float32 sum's but 4 ulp,
    and within ``DEMOD_OFFSET_HZ`` of the known offsets; the total CFO
    fine + coarse bit for bit; one launch of each a call.  The device
    time of each kernel and of its own plain step, of the FFT between
    them, of the whole ``demodulate_rows`` and of the whole plain chain
    (medians of 5 runs), each kernel beside its bytes at 3.35 TB/s.

The kernels' launch counts are reset just before phases 4-5 (K1, K2
and the demod kernels),
phase 6 (K3, K4), the probes' ``main()`` runs of phase 10 (the probe
kernels, and K3 for ``vit_split2``) and phase 11 (K1-K4; counted around
the mesh path's own calls, not the references it is held to) and read
just after; each kernel must have run there (the plane forward once for
``vit_variants`` and once for ``vit_split``).  The ``launches`` of K1-K4
in the kernels line are their main path's; ``launches_by_path`` gives
the main path's and the mesh path's apart.
The last two lines are a JSON object describing each kernel (with its
bound, the least time the card could take for the same work, and the
time of one library call computing the same function where there is
one) and the result line ``{"ok": true, "device": {...}}``.  Needs no
network; uses one card.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FS = 2_048_000


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _clocks() -> str:
    """The card's SM clock and its maximum as nvidia-smi reads them while
    a device sleep keeps the card busy for about a second (a card held
    below its maximum clock runs every kernel slower)."""
    import torch
    torch.cuda._sleep(2_000_000_000)        # cycles: 1 s at 2 GHz
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    torch.cuda.synchronize()
    return (smi.stdout or smi.stderr).strip()


def _cuda_ms(fn, reps: int, host: dict | None = None) -> float:
    """Mean ms of ``fn()`` by CUDA events after a warm-up call (for calls
    that keep the device busy longer than the host takes to issue them);
    ``host`` as ``tools.cuda_ms``'s."""
    from dabjax_torch.tools import cuda_ms
    return cuda_ms(fn, reps, host)


def _device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls enqueued behind a
    device sleep, which must outlast their issue (``tools.device_ms``):
    for short kernels, whose back-to-back calls ``_cuda_ms`` times at the
    host's issue rate, and for a batch of a few hundred small PyTorch
    calls, whose issue on a loaded host outlasts the device work."""
    from dabjax_torch.tools import device_ms
    return device_ms(fn, reps)


def _median_runs(fn, runs: int = 5, reps: int = 10) -> dict:
    """{median, min, max, runs_ms}: device ms of ``runs`` runs of ``reps``
    calls of ``fn``."""
    import statistics
    v = sorted(_device_ms(fn, reps) for _ in range(runs))
    return dict(median=statistics.median(v), min=v[0], max=v[-1], runs_ms=v)


def _interleaved_ms(fns: dict, runs: int, reps: int = 10,
                    timer=_cuda_ms) -> dict:
    """{name: {median, min, max}} ms of each ``fns[name]()`` over ``runs``
    runs of ``reps`` calls (each run timed by ``timer``), the runs taken
    in turns (a, b, b, a, ...): ``tools.interleaved_ms``."""
    from dabjax_torch.tools import interleaved_ms
    return interleaved_ms(fns, runs, reps, timer)


def _spread_text(spread: dict) -> str:
    return ", ".join(f"{k} {v['median']:.4f} ({v['min']:.4f}-{v['max']:.4f})"
                     for k, v in spread.items())


def _soft_cases(nbits: int, rng, B: int = 6):
    """(name, soft [B, 4*(nbits+6)]) integer soft bits in +-127."""
    import numpy as np
    from dabjax_torch.fec import conv
    bits = rng.integers(0, 2, (B, nbits), np.uint8)
    coded = np.stack([conv.encode(b) for b in bits]).astype(np.float32)
    clean = (coded * 2 - 1) * 100
    yield "coded", np.clip(clean + np.round(rng.standard_normal(clean.shape)
                                            * 40), -127, 127)
    yield "near_tie", np.clip(clean + np.round(
        rng.standard_normal(clean.shape) * 80), -127, 127)
    yield "pure_noise", rng.integers(-127, 128, clean.shape).astype(
        np.float32)


def _k2_batches(B: int, nbits: int, rng):
    """(name, soft [B, 4*(nbits+6)]): codeword i coded, near-tie or pure
    noise as i % 3 (one batch of each kind when B < 3)."""
    import numpy as np
    cases = dict(_soft_cases(nbits, rng, B))
    if B < 3:
        return list(cases.items())
    kinds = np.arange(B) % 3
    soft = np.stack([cases[name][i] for i, name in
                     enumerate(np.array(list(cases))[kinds])])
    return [("mixed", soft)]


#: K2's card checks: batch sizes (one codeword, a warp's worth and one
#: either side of it, the FIC and MSC batches) and lengths (odd, DAB's)
K2_BATCHES = (1, 31, 33, 384, 4428)
K2_NBITS = (100, 101, 768, 2304, 9216)
#: K1's card checks: K2's batches and a block's worth of codewords and one
#: either side of it; every batch also with saturated soft values
K1_BATCHES = (1, 3, 4, 5, 31, 33, 384, 4428)
#: gates of the main-path shapes, ms: K1 and K2 at the MSC shape (medians
#: of 5 runs of 10 calls), the 96-frame batch under i8lane (the least of
#: 10 runs of 5 batches)
K1_GATE_MS, K2_GATE_MS, BATCH_GATE_MS = 0.25, 0.060, 3.75
#: gates of the word kernels at the MSC shape, ms (medians of 5 runs of
#: 10 calls): K3 by format, about 9 % above its bring-up times (0.338 and
#: 0.444 ms on an H100 at 700 W; the pack is half of it, PERF.md), K4 on
#: each format's words; the 96-frame batch under i8mxu (the least of 10
#: runs of 5 batches)
K3_GATE_MS = {"i8mxu": 0.37, "i8": 0.37, "f32": 0.48}
K4_GATE_MS, WORDS_BATCH_GATE_MS = 0.10, 3.6
#: the numpy reference decodes batches up to this many bits
NUMPY_LIMIT = 4428 * 2304
#: warp shuffles a step of the first K1 (one soft broadcast, four metrics)
K1_OLD_SHUFFLES = 5


def _saturated(B: int, nbits: int, rng):
    """soft [B, 4*(nbits+6)]: every value of a codeword +127, or -127."""
    import numpy as np
    sign = rng.choice(np.array([-127.0, 127.0], np.float32), (B, 1))
    return np.broadcast_to(sign, (B, 4 * (nbits + 6))).copy()


def _k1_mismatches(dec, soft8) -> int:
    """Decisions of K1 (``dec``, its words) that differ from the plain
    forward's on ``soft8`` int8 [B, T, 4]; some codewords at a time, so
    that the unpacked planes stay small."""
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc
    B, T, _ = soft8.shape
    step = max(1, 10_000_000 // T)
    return sum(int((vc.unpack_decisions(dec[i: i + step])
                    != viterbi.viterbi_forward_torch(soft8[i: i + step]))
                   .sum()) for i in range(0, B, step))


def _runs_ms(fn, runs: int = 5, reps: int = 10) -> list:
    """Sorted ms of ``runs`` runs of ``reps`` calls of ``fn``."""
    return sorted(_cuda_ms(fn, reps) for _ in range(runs))


def _word_grid_checks(s, nbits, name, k2_bits, want):
    """K3 in each word format against its plain version (words and
    ``last``) on the soft bits ``s`` of phase 2's grid, and K3 + K4 bits
    against the numpy decoder's ``want`` where phase 2 computed it, else
    against K1 + K2's bits (equal to their plain versions there)."""
    import numpy as np
    import torch
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc
    B = s.shape[0]
    for fmt in vc.WORD_FORMATS:
        words, last = vc.viterbi_forward_words_cuda(
            vc.pair_soft(s, nbits, fmt), fmt)
        plain_w, plain_l = viterbi.viterbi_forward_words_torch(s, nbits, fmt)
        _check(torch.equal(words, plain_w) and torch.equal(last, plain_l),
               f"K3 != plain at B={B} nbits={nbits} ({name}, {fmt})")
        del plain_w, plain_l
        bits = vc.viterbi_traceback_words_cuda(words, last, nbits)
        if want is None:
            _check(torch.equal(bits, k2_bits),
                   f"K3+K4 != K1+K2 at B={B} nbits={nbits} ({name}, {fmt})")
        else:
            _check(np.array_equal(bits.cpu().numpy(), want),
                   f"K3+K4 != numpy at B={B} nbits={nbits} ({name}, {fmt})")


def phase_kernels(dev, report):
    import numpy as np
    import torch
    from dabjax_torch.fec.viterbi import viterbi_decode_np
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc

    rng = np.random.default_rng(2024)
    for nbits in K2_NBITS:
        t0 = time.perf_counter()
        for B in K1_BATCHES:
            cases = _k2_batches(B, nbits, rng)
            cases.append(("saturated", _saturated(B, nbits, rng)))
            for name, soft in cases:
                s = torch.from_numpy(soft).to(dev)
                s8 = vc.step_soft(s, nbits)
                dec = vc.viterbi_forward_cuda(s8)
                _check(_k1_mismatches(dec, s8) == 0,
                       f"K1 != plain at B={B} nbits={nbits} ({name})")
                got = vc.viterbi_traceback_cuda(dec, nbits)
                plain = viterbi.viterbi_traceback_torch(
                    vc.unpack_decisions(dec), nbits)
                _check(torch.equal(got, plain),
                       f"K2 != plain at B={B} nbits={nbits} ({name})")
                del dec, plain
                # the numpy decoder: on K2's grid (but for the largest
                # batch at the longest codeword, minutes of numpy, which
                # the plain versions above and 384 x 9216 and 4428 x 2304
                # cover) and on every batch up to 5 codewords
                k2_grid = (name != "saturated" and B in K2_BATCHES
                           and B * nbits <= NUMPY_LIMIT)
                want = None
                if k2_grid or B <= 5:
                    want = viterbi_decode_np(soft, nbits)
                    _check(np.array_equal(got.cpu().numpy(), want),
                           f"K1+K2 != numpy at B={B} nbits={nbits} ({name})")
                _word_grid_checks(s, nbits, name, got, want)
                if not k2_grid:
                    continue
                _check(torch.equal(viterbi.viterbi_decode(s, nbits), got),
                       f"viterbi_decode != K1+K2 at B={B} nbits={nbits}")
                if B <= 33:
                    _check(np.array_equal(viterbi.viterbi_decode_torch(
                        s, nbits).cpu().numpy(), want),
                        f"plain decode != numpy at B={B} nbits={nbits}")
        print(f"kernels: nbits={nbits} B={K1_BATCHES} coded/near_tie/"
              "pure_noise/saturated: K1 and K2 bit-exact vs plain torch, "
              "K1+K2 vs numpy; K3 words equal plain and K3+K4 bits equal "
              f"numpy (or K1+K2) in i8mxu, i8, f32 "
              f"({time.perf_counter() - t0:.0f} s)")

    sass = vc.forward_sass_counts()
    per_step = sass["SHFL"] / vc.TILE
    print(f"kernels: K1 SASS: {sass['total']} instructions, of them "
          f"{sass['SHFL']} SHFL and {sass['VOTE']} VOTE with {vc.TILE} "
          f"steps unrolled: {per_step:.2f} shuffles a step (the first K1: "
          f"{K1_OLD_SHUFFLES})")
    _check(0 < per_step < K1_OLD_SHUFFLES, f"K1 SASS shuffles: {sass}")
    report["k1_sass"] = dict(sass, shuffles_per_step=per_step)

    for label, B, nbits in (("msc", 4428, 2304), ("fic", 384, 768)):
        T = nbits + 6
        soft = torch.from_numpy(rng.integers(-127, 128, (B, T, 4)).astype(
            np.int8)).to(dev)
        dec = vc.viterbi_forward_cuda(soft)
        err_k1 = _k1_mismatches(dec, soft)
        bits = vc.viterbi_traceback_cuda(dec, nbits)
        unpacked = vc.unpack_decisions(dec)
        bits_plain = viterbi.viterbi_traceback_torch(unpacked, nbits)
        err_k2 = int((bits - bits_plain).abs().max())
        _check(err_k1 == 0, f"K1 decisions differ at {label} shape")
        _check(err_k2 == 0, f"K2 bits differ at {label} shape")
        # 5 runs of 10 calls each, the median and the spread
        k1_runs = _runs_ms(lambda: vc.viterbi_forward_cuda(soft))
        k1_ms = k1_runs[2]
        k1_plain = _cuda_ms(lambda: viterbi.viterbi_forward_torch(soft), 1)
        k2_runs = _runs_ms(lambda: vc.viterbi_traceback_cuda(dec, nbits))
        k2_ms = k2_runs[2]
        k2_plain = _cuda_ms(
            lambda: viterbi.viterbi_traceback_torch(unpacked, nbits), 1)
        print(f"kernels: {label} B={B} nbits={nbits}: K1 {k1_ms:.4f} ms "
              f"(min {k1_runs[0]:.4f}, max {k1_runs[-1]:.4f}; plain "
              f"{k1_plain:.2f} ms), K2 {k2_ms:.4f} ms (min "
              f"{k2_runs[0]:.4f}, max {k2_runs[-1]:.4f}; plain "
              f"{k2_plain:.2f} ms), bit-exact")
        report[label] = dict(k1=(err_k1, k1_ms, k1_plain),
                             k2=(err_k2, k2_ms, k2_plain),
                             k1_runs_ms=k1_runs, k2_runs_ms=k2_runs)
    _check(report["msc"]["k1"][1] <= K1_GATE_MS,
           f"K1 at the MSC shape: {report['msc']['k1'][1]:.4f} ms, above "
           f"{K1_GATE_MS}")
    _check(report["msc"]["k2"][1] <= K2_GATE_MS,
           f"K2 at the MSC shape: {report['msc']['k2'][1]:.4f} ms, above "
           f"{K2_GATE_MS}")


def phase_words(dev, report):
    import numpy as np
    import torch
    from dabjax_torch.fec.viterbi import viterbi_decode_np
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
    # the plain versions; K3 and K4 timed there (5 runs of 10 calls, the
    # median and the spread)
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
            k3_runs = _runs_ms(lambda: vc.viterbi_forward_words_cuda(x, fmt))
            k3_plain = _cuda_ms(
                lambda: viterbi.viterbi_forward_words_torch(soft, nbits, fmt),
                1)
            k4_runs = _runs_ms(
                lambda: vc.viterbi_traceback_words_cuda(words, last, nbits))
            k4_plain = _cuda_ms(
                lambda: viterbi.viterbi_traceback_words_torch(words, last,
                                                              nbits), 1)
            k3_ms, k4_ms = k3_runs[2], k4_runs[2]
            print(f"words: {label} B={B} nbits={nbits} {fmt}: K3 "
                  f"{k3_ms:.4f} ms (min {k3_runs[0]:.4f}, max "
                  f"{k3_runs[-1]:.4f}; plain {k3_plain:.2f} ms), K4 "
                  f"{k4_ms:.4f} ms (min {k4_runs[0]:.4f}, max "
                  f"{k4_runs[-1]:.4f}; plain {k4_plain:.2f} ms), exact")
            report[f"words_{label}_{fmt}"] = dict(
                k3=(err3, k3_ms, k3_plain), k4=(err4, k4_ms, k4_plain),
                k3_runs_ms=k3_runs, k4_runs_ms=k4_runs)
    for fmt in vc.WORD_FORMATS:
        k3_ms = report[f"words_msc_{fmt}"]["k3"][1]
        k4_ms = report[f"words_msc_{fmt}"]["k4"][1]
        _check(k3_ms <= K3_GATE_MS[fmt],
               f"K3 ({fmt}) at the MSC shape: {k3_ms:.4f} ms, above "
               f"{K3_GATE_MS[fmt]}")
        _check(k4_ms <= K4_GATE_MS,
               f"K4 on {fmt} words at the MSC shape: {k4_ms:.4f} ms, above "
               f"{K4_GATE_MS}")

    # K3's SASS: the core's tile of 32 steps is unrolled (two votes a
    # step), word 0's pair step is a rolled loop
    sass = {fmt: vc.forward_words_sass_counts(fmt) for fmt in vc.WORD_FORMATS}
    for fmt, c in sass.items():
        print(f"words: K3 {fmt} SASS: {c['total']} instructions, of them "
              f"{c['SHFL']} SHFL and {c['VOTE']} VOTE (one tile of "
              f"{vc.TILE} steps unrolled, word 0's pair step rolled)")
        _check(c["VOTE"] >= 2 * vc.TILE and 0 < c["SHFL"] < 2 * vc.TILE,
               f"K3 {fmt} SASS: {c}")
    report["k3_sass"] = sass


def _check_ensemble(ok, bits, golden):
    """Every FIB CRC passes and every logical frame equals the payload."""
    ok = ok.cpu().numpy()
    _check(ok.shape == (golden["n_frames"], 12) and ok.all(),
           "FIB CRC failures")
    return ok.size, _check_payload(bits, golden)


def _check_payload(bits, golden):
    """Every logical frame of ``bits`` [12, T-15, 2304] equals the
    payload; returns T-15."""
    import numpy as np
    p, n_frames, mod = golden["p"], golden["n_frames"], golden["mod"]
    bits = bits.cpu().numpy()
    n_lf = n_frames * p.cifs_per_frame - 15
    _check(bits.shape == (12, n_lf, 2304), f"bits shape {bits.shape}")
    for s in golden["services"]:
        for t in range(n_lf):
            _check(np.array_equal(bits[s.subch_id, t],
                                  mod.payload_bits(s.subch_id, t)),
                   f"payload mismatch subch {s.subch_id} frame {t}")
    return n_lf


def phase_pipeline(dev, report):
    import numpy as np
    import torch
    from dabjax_torch.constants import get_mode
    from dabjax_torch.tx.fig import ServiceSpec
    from dabjax_torch import testing
    from dabjax_torch.msc.subchannel import SubchGeometry
    from dabjax_torch.ofdm.demod import min_frame_samples
    from dabjax_torch.runtime.pipeline import full_ensemble_pipeline
    from dabjax_torch.fec import viterbi_cuda as vc

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
    ok, golden["bits"] = pipe(rows)
    n_fib, n_lf = _check_ensemble(ok, golden["bits"], golden)
    # the kernels' launches in one batch (counts read as differences: the
    # main path's counts run on), and what that batch clips and casts to
    # int8: the CIF block and the FIC stream, never the MSC codewords'
    # full-rate stream (an int8 tensor passes through ``to_int8``)
    before = (vc.FORWARD_LAUNCHES, vc.TRACEBACK_LAUNCHES)
    casts, to_int8 = [], vc.to_int8

    def recording(soft):
        casts.append((str(soft.dtype).replace("torch.", ""), soft.numel()))
        return to_int8(soft)

    vc.to_int8 = recording
    try:
        pipe(rows)
    finally:
        vc.to_int8 = to_int8
    per_batch = dict(k1=vc.FORWARD_LAUNCHES - before[0],
                     k2=vc.TRACEBACK_LAUNCHES - before[1])
    _check(per_batch == dict(k1=2, k2=2),
           f"launches per batch {per_batch}, not 2 and 2")
    full_rate = len(geoms) * n_lf * 4 * (2304 + 6)
    cif_block = n_frames * p.cifs_per_frame * 55296
    cast = sorted(n for dtype, n in casts if dtype != "int8")
    _check(cif_block in cast and max(cast) < full_rate,
           f"a batch casts {casts}: the CIF block is {cif_block} values, "
           f"the full-rate stream {full_rate}")
    # 10 runs of 5 batches each, the median and the spread.  The gate
    # is on the least of them: the device bounds a run's time from below,
    # and a loaded host (the batch is a few hundred small PyTorch calls)
    # only adds to it.
    runs = _runs_ms(lambda: pipe(rows), runs=10, reps=5)
    sec = (runs[4] + runs[5]) / 2e3
    rt = n_frames * p.T_F / FS / sec
    print(f"pipeline: 12 subchannels x {n_lf} logical frames exact, "
          f"{n_fib} FIBs pass CRC; {sec:.4f} s per {n_frames}-frame "
          f"batch (min {runs[0]:.4f}, max {runs[-1]:.4f} ms) = {rt:.2f}x "
          f"realtime; launches per batch {per_batch}")
    print(f"pipeline: int8 casts of one batch (dtype in, values): {casts}; "
          f"no clip or cast touches the {full_rate} values of the "
          "full-rate MSC stream")
    _check(runs[0] <= BATCH_GATE_MS,
           f"the batch takes {runs[0]:.4f} ms at the least, above "
           f"{BATCH_GATE_MS}")
    report["pipeline"] = dict(seconds_per_batch=sec, realtime=rt,
                              launches_per_batch=per_batch,
                              int8_casts=casts, batch_runs_ms=runs)
    return golden


def _loop_iq(services, n_frames):
    """Golden IQ for a mixed MP2/DAB+ ensemble whose payloads repeat every
    120 CIFs, so a loop of ``n_frames`` (a multiple of 30 in Mode I) is
    seamless for the time interleaver and the audio streams."""
    import numpy as np
    from dabjax_torch import testing
    payloads = {s.subch_id: (testing.mp2_payload_gen(0) if s.kind == "MP2"
                             else testing.dabplus_payload_gen(s.bitrate, 0))
                for s in services}
    mod = testing.golden_modulator(mode=1, services=services,
                                   payloads=payloads)
    return mod.iq(n_frames, snr_db=None).astype(np.complex64)


def phase_receiver(dev, report):
    import numpy as np
    import torch
    from dabjax_torch import testing
    from dabjax_torch.constants import get_mode
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import BlockFn, Receiver

    services = testing.bench_services("mixed")
    t0 = time.perf_counter()
    iq = _loop_iq(services, 60)
    print(f"receiver: loop IQ rendered in {time.perf_counter() - t0:.1f} s")
    rx = Receiver(testing.LoopSource(iq), ReceiverConfig(frames_per_block=64),
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
                              au_ok=m.au_ok, mp2_frames_ok=m.mp2_frames_ok,
                              superframes_ok=m.superframes_ok)

    # the same blocks with the audio decoded in a spawned worker process
    # (the port's own audio pool: the card machine has no jax)
    rx = Receiver(testing.LoopSource(iq),
                  ReceiverConfig(frames_per_block=64, audio_workers=1),
                  device=dev)
    try:
        t0 = time.perf_counter()
        mw = rx.run(3)
        dtw = time.perf_counter() - t0
    finally:
        rx.close()
    counters = ("au_ok", "au_bad", "superframes_ok", "superframes_bad",
                "rs_corrected", "mp2_frames_ok", "mp2_frames_bad")
    print(f"receiver: audio_workers=1: {mw.dashboard()}; 3 blocks in "
          f"{dtw:.2f} s wall")
    _check(mw.fic_ratio == 1.0, f"audio_workers=1: fic_ratio {mw.fic_ratio}")
    _check(all(getattr(mw, f) == getattr(m, f) for f in counters),
           "audio_workers=1: audio counters differ from the threaded run: "
           + ", ".join(f"{f} {getattr(mw, f)} vs {getattr(m, f)}"
                       for f in counters))
    print("receiver: audio_workers=1 gives the threaded run's AU, "
          "superframe, RS and MP2 counters: " + ", ".join(
              f"{f} {getattr(m, f)}" for f in counters))
    report["receiver"]["workers"] = dict(
        wall_s=dtw, **{f: getattr(mw, f) for f in counters})

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
            runs = _runs_ms(lambda: pipe(rows), runs=10, reps=5)
            sec = (runs[4] + runs[5]) / 2e3
            print(f"formats: {fmt}: 12 subchannels x {n_lf} logical frames "
                  f"exact, {n_fib} FIBs pass CRC, through K3+K4 only; "
                  f"{sec:.4f} s per {n_frames}-frame batch (min "
                  f"{runs[0]:.4f}, max {runs[-1]:.4f} ms) = "
                  f"{n_frames * p.T_F / FS / sec:.2f}x realtime")
            out[fmt] = dict(seconds_per_batch=sec, batch_runs_ms=runs)
    finally:
        vc.SOFT_FMT = "i8lane"
    report["formats"] = out
    least = out["i8mxu"]["batch_runs_ms"][0]
    _check(least <= WORDS_BATCH_GATE_MS,
           f"the i8mxu batch takes {least:.4f} ms at the least, above "
           f"{WORDS_BATCH_GATE_MS}")


#: rounds of the stage timing: each round times every prefix (mean of 5
#: calls), and a stage's spread is over the rounds
STAGE_ROUNDS = 5


def phase_stages(dev, report, golden):
    import math
    import statistics
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
            rounds = [{name: _device_ms(lambda f=fn: f(rows), 5)
                       for name, fn in fns.items()}
                      for _ in range(STAGE_ROUNDS)]
            stage_rounds = [{
                "demod": ms["demod"],
                "fic": ms["fic"] - ms["demod"],
                "deint_depunct": ms["deint_depunct"] - ms["fic"],
                "viterbi_forward": ms["viterbi_forward"] - ms["deint_depunct"],
                "traceback_dispersal": ms["full"] - ms["viterbi_forward"]}
                for ms in rounds]
            ms = {name: statistics.median(r[name] for r in rounds)
                  for name in fns}
            stages = {name: statistics.median(r[name] for r in stage_rounds)
                      for name in stage_rounds[0]}
            spread = {name: (min(r[name] for r in stage_rounds),
                             max(r[name] for r in stage_rounds))
                      for name in stages}
            print(f"stages ({fmt}): prefix ms (median of {STAGE_ROUNDS} "
                  "rounds) " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         ms.items()))
            print(f"stages ({fmt}): stage ms, median (min-max) " +
                  ", ".join(f"{k} {v:.4f} ({spread[k][0]:.4f}-"
                            f"{spread[k][1]:.4f})" for k, v in stages.items()))
            _check(stages["traceback_dispersal"] > 0,
                   f"stages ({fmt}): traceback_dispersal "
                   f"{stages['traceback_dispersal']:.4f} ms, not above 0")
            out[fmt] = dict(prefix_ms=ms, stage_ms=stages,
                            stage_spread_ms=spread)
    finally:
        vc.SOFT_FMT = "i8lane"
    report["stages"] = out


def phase_entry(dev, report, loop_iq):
    import numpy as np
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.tx.fig import ServiceSpec
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

    bank = MultiReceiver({f"ch{i}": testing.LoopSource(loop_iq)
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


#: runs in turns of the copy kernel and torch.mul, and of the plane
#: kernel and fill_ (phase 10)
COPY_REPS = 7
#: the plane kernel's gate: its median at most this times fill_'s of the
#: host int, in the same runs (a ratio, so the card's SM clock cancels)
PLANE_FILL_GATE = 1.05
#: the redesigned probes' earlier designs at the main-path shape, ms, as
#: the printed lines quote them beside this run's times (not measured
#: here, and not in the kernels line): phase 10 of this script's last run
#: before their redesign (NVIDIA H100 80GB HBM3, 700 W; PERF.md section
#: 6): P4 (forward_plane, ksplit, chunk 8) by mode, and P1
#: (forward_words_stage) by stage
PLANE_OLD_MS = {"full": 0.9933, "dot_only": 0.3281, "no_acs": 0.4615,
                "full_k8": 0.8861, "dot_only_k8": 0.2697, "no_acs_k8": 0.3878}
STAGE_OLD_MS = {"dot_store": 0.1470, "repadd": 0.2185, "maxtree": 0.4168,
                "full": 0.5238}
#: gates of the redesigned probes, ms (medians of 5 runs of 10 calls):
#: P4 full (ksplit, chunk 8), with room for a card that runs 1.23x slow
#: (one of the pool did); P1 at 1.3x its times on an H100 at 700 W, in
#: the deepest stage its own kernel runs (maxtree, 0.3703 ms) and in
#: full, which is K3 "i8" (0.3393 ms)
PLANE_GATE_MS = 0.60
STAGE_GATES_MS = {"maxtree": 0.48, "full": 0.44}


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

    # vit_variants2 (P1, redesigned; its full stage is K3 "i8"): each
    # stage against its plain version, timed beside its earlier design,
    # its plain version and the bound; maxtree and full gated
    x = vv2.padded_pair_soft(soft, nbits)
    modes, stage_err = {}, 0
    for mode in vv2.MODES:
        e = err(vv2.forward_words_stage_cuda(x, mode),
                vv2.forward_words_stage_torch(x, mode))
        _check(e == 0, f"vit_variants2 {mode}: words differ from plain")
        stage_err = max(stage_err, e)
        r = _median_runs(lambda: vv2.forward_words_stage_cuda(x, mode))
        bound = _words_stage_bound(B, x.shape[1],
                                   mode in ("maxtree", "full"))
        modes[mode] = dict(
            ms=r["median"], runs_ms=r["runs_ms"],
            kernel="viterbi_forward_acs_words" if mode == "full"
            else "forward_words_stage",
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            plain_ms=_cuda_ms(lambda: vv2.forward_words_stage_torch(x, mode),
                              1))
        print(f"probes: vit_variants2 {mode}: {r['median']:.4f} ms "
              f"({r['min']:.4f}-{r['max']:.4f}, median of 5 runs of 10), "
              f"earlier design {STAGE_OLD_MS[mode]:.4f} ms (recorded "
              f"before the redesign), {modes[mode]['kernel']}, plain "
              f"{modes[mode]['plain_ms']:.2f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{r['median'] / bound['bound_ms']:.2f}x), exact")
    for mode, gate in STAGE_GATES_MS.items():
        _check(modes[mode]["ms"] <= gate,
               f"vit_variants2 {mode} takes {modes[mode]['ms']:.4f} ms, "
               f"above {gate}")
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
    _dot_checks(dev, report)

    # hbm_probe: copy and plane bit for bit
    xb = hbm_probe.input_block().to(dev)
    xb += torch.rand_like(xb)                # arbitrary floats for the copy
    got, want = hbm_probe.scale_copy_cuda(xb), hbm_probe.scale_copy_torch(xb)
    e_copy = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    _check(e_copy == 0, f"copy kernel: {e_copy} words differ from x * 1.000001")
    xo = hbm_probe.odd_block().to(dev)
    want = hbm_probe.decision_plane_torch(xo)
    _check(want[:8 * len(hbm_probe.ODD_STARTS):8, 0, 0].tolist()
           == [127, -128, 127, -128, 0, 127, -128, 0],
           "plain decision plane does not saturate as XLA casts")
    e_plane = err(hbm_probe.decision_plane_cuda(xo), want)
    del xo, want
    xb = hbm_probe.input_block(seed=8).to(dev)
    e_plane = max(e_plane, err(hbm_probe.decision_plane_cuda(xb),
                               hbm_probe.decision_plane_torch(xb)))
    _check(e_plane == 0, "decision plane differs from its plain version")
    n = xb.numel()
    plane_bytes = n // 16 * hbm_probe.PLANE_ROWS
    for key, fn, plain, nbytes, e in (
            ("copy", hbm_probe.scale_copy_cuda, hbm_probe.scale_copy_torch,
             8 * n, e_copy),
            ("plane", hbm_probe.decision_plane_cuda,
             hbm_probe.decision_plane_torch, plane_bytes, e_plane)):
        host = {}
        ms = _cuda_ms(lambda: fn(xb), 10, host)
        plain_ms = _cuda_ms(lambda: plain(xb), 10)
        report[f"hbm_{key}"] = dict(err=e, ms=ms, plain_ms=plain_ms,
                                    gb_per_s=nbytes / ms / 1e6,
                                    plain_gb_per_s=nbytes / plain_ms / 1e6,
                                    elements=n, nbytes=nbytes)
        # where the host's issue of the 10 calls comes near 10 x ms, the
        # card waited on the host (a GC pass, a thread, the scheduler)
        print(f"probes: hbm {key}: {ms:.4f} ms = {nbytes / ms / 1e6:.1f} "
              f"GB/s (plain {plain_ms:.4f} ms), bit for bit; by events, "
              f"the host issued the 10 calls in {host['issue_ms']:.3f} ms "
              f"({host['gc']} GC passes, {host['mallocs']} device "
              f"mallocs, {threading.active_count()} threads alive)")
    # the library's own call for the same product (torch's elementwise
    # multiply), as the copy's yardstick: COPY_REPS runs in turns
    xc = hbm_probe.input_block().to(dev)
    spread = _interleaved_ms(
        {"kernel": lambda: hbm_probe.scale_copy_cuda(xc),
         "mul": lambda: torch.mul(xc, 1.000001)}, COPY_REPS)
    del xc
    nbytes = report["hbm_copy"]["nbytes"]
    report["hbm_copy"].update(ms=spread["kernel"]["median"],
                              gb_per_s=nbytes / spread["kernel"]["median"]
                              / 1e6,
                              library_ms=spread["mul"]["median"],
                              spread_ms=spread)
    print(f"probes: scale_copy vs torch.mul over {COPY_REPS} runs in turns, "
          f"ms median (min-max): {_spread_text(spread)}")
    # the plane's library call: one fill_ of the int8 plane with the
    # saturated cast of x[0, 0, 0], made on the device beforehand (a
    # broadcast copy of the device scalar) and, as fill_int, read to the
    # host once beforehand; on an input whose 8-step blocks all start with
    # that value it is the kernel's output. COPY_REPS runs in turns with
    # the kernel on the seed-8 input checked above, by events and then by
    # device time (behind a device sleep, so the host's issue of the
    # first call, longer through the wrapper than for fill_, is left
    # out); the gate holds on both
    xe = hbm_probe.input_block(seed=8).to(dev)
    xe[::hbm_probe.PLANE_BLOCK, 0, 0] = xe[0, 0, 0]
    v = xe[0, 0, 0].clamp(-128, 127).to(torch.int8)
    iv = int(v)
    plane = torch.empty((xe.shape[0], hbm_probe.PLANE_ROWS, xe.shape[2]),
                        dtype=torch.int8, device=dev)
    want = hbm_probe.decision_plane_cuda(xe)
    for fill in (v, iv):
        _check(torch.equal(plane.fill_(fill), want),
               "fill_ of x[0, 0, 0] is not the plane kernel's output")
    del want
    fns = {"kernel": lambda: hbm_probe.decision_plane_cuda(xb),
           "fill": lambda: plane.fill_(v),
           "fill_int": lambda: plane.fill_(iv)}
    nbytes = report["hbm_plane"]["nbytes"]
    ratios = {}
    for timer, key, label in ((_cuda_ms, "events", "events"),
                              (_device_ms, "device", "device time")):
        spread = _interleaved_ms(fns, COPY_REPS, timer=timer)
        ratios[key] = (spread["kernel"]["median"]
                       / spread["fill_int"]["median"])
        print(f"probes: decision_plane vs fill_ over {COPY_REPS} runs in "
              f"turns by {label}, ms median (min-max): "
              f"{_spread_text(spread)}; kernel {ratios[key]:.4f}x fill_int "
              f"(gate {PLANE_FILL_GATE}x)")
        report["hbm_plane"][f"{key}_spread_ms"] = spread
    spread = report["hbm_plane"]["device_spread_ms"]
    report["hbm_plane"].update(
        ms=spread["kernel"]["median"],
        gb_per_s=nbytes / spread["kernel"]["median"] / 1e6,
        library_ms=min(spread["fill"]["median"],
                       spread["fill_int"]["median"]),
        x_fill_int=ratios["device"], x_fill_int_events=ratios["events"])
    for key, ratio in ratios.items():
        _check(ratio <= PLANE_FILL_GATE,
               f"decision_plane takes {ratio:.4f}x fill_ of the host int "
               f"({key}), above {PLANE_FILL_GATE}x")


def _plane_checks(report, soft, k3_words):
    """Phase 10, planes: the per-step-plane forward (P4, redesigned) in
    every mode, ksplit on and off, chunk 8 and 16, unrolled or not,
    against its plain version byte for byte; the ``full`` plane packed 16
    steps per word against K3 "i8" words; ``no_acs`` saturated at both
    ends; each mode at chunk 8 timed (median of 5 runs of 10 calls)
    beside its earlier design, its plain version and the bound, ``full``
    (ksplit) gated at PLANE_GATE_MS; ``vit_split``'s chunk 16 plane equal
    to chunk 8's, zero past it."""
    import torch
    from dabjax_torch import tools
    from dabjax_torch.tools import vit_split, vit_variants as vv

    B, nbits = tools.CODEWORDS, tools.NBITS
    modes, plane_err, full = {}, 0, None
    for chunk in vv.CHUNKS:
        T2, Tp2 = vv.pair_steps(nbits, chunk)
        for ksplit in (True, False):
            x = vv.plane_soft(soft, nbits, chunk, ksplit)
            bound = _plane_bound(B, Tp2, x.shape[2])
            for mode in vv.MODES:
                want = vv.forward_plane_torch(x, T2, mode, chunk)
                for unroll in (False, True):
                    plane = vv.forward_plane_cuda(x, T2, mode, chunk, unroll)
                    e = int((plane.int() - want.int()).abs().max())
                    _check(e == 0, f"forward_plane {mode} (ksplit {ksplit}, "
                           f"chunk {chunk}, unroll {unroll}) differs from "
                           "plain")
                    plane_err = max(plane_err, e)
                if mode == "full":
                    _check(torch.equal(vv.pack_words(plane), k3_words),
                           f"full plane (ksplit {ksplit}, chunk {chunk}) != "
                           "K3 i8 words")
                    if ksplit and chunk == 8:
                        full = plane
                if mode == "no_acs":
                    _check(bool((plane == -128).any()
                                and (plane == 127).any()),
                           "no_acs plane holds not both -128 and 127")
                if chunk != 8:
                    continue
                key = mode if ksplit else f"{mode}_k8"
                r = _median_runs(lambda: vv.forward_plane_cuda(x, T2, mode))
                ru = _median_runs(lambda: vv.forward_plane_cuda(
                    x, T2, mode, unroll=True))
                modes[key] = dict(ms=r["median"], runs_ms=r["runs_ms"],
                                  unroll_ms=ru["median"],
                                  bound_ms=bound["bound_ms"],
                                  bound_by=bound["bound_by"])
                plain = ""
                if ksplit:   # the plain version timed at the probe's default
                    modes[key]["plain_ms"] = _cuda_ms(
                        lambda: vv.forward_plane_torch(x, T2, mode), 1)
                    plain = f", plain {modes[key]['plain_ms']:.2f} ms"
                print(f"probes: vit_variants {key}: {r['median']:.4f} ms "
                      f"({r['min']:.4f}-{r['max']:.4f}, median of 5 runs of "
                      f"10), unrolled {ru['median']:.4f} ms, earlier design "
                      f"{PLANE_OLD_MS[key]:.4f} ms (recorded before the "
                      f"redesign){plain}, bound "
                      f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
                      f"{r['median'] / bound['bound_ms']:.2f}x), exact")
        print(f"probes: vit_variants chunk={chunk}: three modes x ksplit on "
              "and off x unroll 0 and 1 equal plain, full packs to K3 i8, "
              "no_acs saturates")
    report["vit_variants"] = dict(err=plane_err, modes=modes)
    _check(modes["full"]["ms"] <= PLANE_GATE_MS,
           f"forward_plane full takes {modes['full']['ms']:.4f} ms, above "
           f"{PLANE_GATE_MS}")

    # vit_split: chunk 8 and 16, unrolled or not; the padding steps of
    # chunk 16 (past T2) are 0
    T2, Tp2 = vv.pair_steps(nbits)
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
            split["ms"][f"C{chunk}_unroll{int(unroll)}"] = _device_ms(
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
    # one call at the TPU probe's longest chain (float32 mix, n 64): device
    # ms behind a sleep, beside the host's issue time (back-to-back calls
    # timed by events alone)
    x = vpu_probe.tile("float32", seed=9).to(dev)
    report["vpu_probe"] = dict(
        err=chain_err, per_op=chain,
        **_short_call(lambda: vpu_probe.elementwise_chain_cuda(x, "mix", 64),
                      lambda: vpu_probe.elementwise_chain_torch(x, "mix", 64),
                      "vpu_probe float32 mix n 64"))

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
        **_short_call(lambda: vpu_probe2.pair_chain_cuda(x, y, 96),
                      lambda: vpu_probe2.pair_chain_torch(x, y, 96),
                      "vpu_probe2 float32 n 96"))


def _short_call(kernel, plain, what: str) -> dict:
    """{ms, runs_ms, host_ms, plain_ms} of a kernel call shorter than the
    host's time to issue it: the device's median of 5 runs of 100 calls,
    the host's issue time (the same calls timed by events alone) and the
    plain version's device ms; prints them."""
    r = _median_runs(kernel, reps=100)
    out = dict(ms=r["median"], runs_ms=r["runs_ms"],
               host_ms=_cuda_ms(kernel, 100), plain_ms=_device_ms(plain, 3))
    print(f"probes: {what}: {out['ms'] * 1e3:.3f} us a call on the device "
          f"({r['min'] * 1e3:.3f}-{r['max'] * 1e3:.3f}, median of 5 runs of "
          f"100), {out['host_ms'] * 1e3:.3f} us by events alone (the host's "
          f"issue time), plain {out['plain_ms'] * 1e3:.1f} us")
    return out


#: a batched-product width that ends in a partial 64-column tile
BATCHED_TAIL_N = 4488
#: gates of the redesigned dot probes, us (medians of 5 slopes): D1 (f32
#: dot, K 16, LB 4480, per step between 32 and 256 steps; 0.9316), D2 (the
#: same in bf16; 0.0609) and D5 ([256, 8] @ [8, 4480], per dot between 40
#: and 1000 dots; 0.4093), each at 1.3x its median on an H100 at 700 W,
#: 1980 MHz (PERF.md section 6)
DOT_GATES_US = {"dot_steps": 1.21, "dot_steps_bf16": 0.079, "dots_chain": 0.53}


def _per_slope(ms_of, n1: int, n2: int, runs: int = 5) -> dict:
    """{median, min, max, runs_ms}: ms per unit, the slope of ``ms_of(n)``
    (the device ms of one call of length n) from n1 to n2, over ``runs``
    runs."""
    import statistics
    v = sorted((ms_of(n2) - ms_of(n1)) / (n2 - n1) for _ in range(runs))
    return dict(median=statistics.median(v), min=v[0], max=v[-1], runs_ms=v)


def _dot_checks(dev, report):
    """Phase 10, dot shapes: the step loop (every case of the TPU probe's
    main(), at both lane counts, the larger step count), the batched
    product and the chained dots against their plain versions, within
    DOT_TOL on the TPU probes' inputs and bit for bit on integer inputs
    (the chained dots' own inputs are integers); the FFMA / HGMMA of one
    step, stage and dot in the SASS; times per step and per dot beside the
    plain version and the library calls; the step loops gated."""
    import numpy as np
    import torch
    from dabjax_torch.tools import vit_dotshapes as vd, vpu_probe2

    steps_sass, dots_sass = vd.sass_counts(), vpu_probe2.dot_sass_counts()
    # D1's wide build: a thread's step is 8 rows x WIDE_COLS columns x K
    # FFMA (3 FADD a column in repeat_add); D2 one wgmma (HGMMA) a 64-row
    # slab a step, in one ring stage of each of its two paths (40 and 32
    # columns); the batched bf16 product one wgmma a 64-row slab, 4 a tile
    want = {f"{m} f32 K={k}": 8 * vd.WIDE_COLS * k for m in ("dot", "dot_acs")
            for k in vd.KS}
    want.update({"repeat_add f32": 3 * vd.WIDE_COLS,
                 "dot bf16 K=16": 2 * vd.BF16_STAGE_STEPS * 4,
                 "batched bf16 K=16": 4})
    _check(all(steps_sass[c] >= n for c, n in want.items()),
           f"a step kernel lost work: {steps_sass}, want at least {want}")
    for rows, kdim, tag in vpu_probe2.DOT_SHAPES:
        # a lane's rows (rows / 32) x the columns it runs together x kdim
        # FFMA a dot
        n = rows // 32 * vpu_probe2.DOT_GROUP[rows] * kdim
        _check(dots_sass[tag] >= n, f"dots {tag}: SASS per dot "
               f"{dots_sass[tag]}, want at least {n} FFMA a thread")
    print(f"probes: SASS of one step {steps_sass}; of one dot {dots_sass}")

    rng = np.random.default_rng(11)

    def ints(shape, bound, dtype):
        v = rng.integers(-bound, bound + 1, size=shape).astype(np.float32)
        return torch.from_numpy(v).to(vd.DTYPES[dtype]).to(dev)

    def err(got, want):
        d = float((got - want).abs().max())
        return d, d / float(want.abs().max())

    def hold(got, want, what, worst):
        """Within vd.DOT_TOL of plain; the largest error so far in worst."""
        if not torch.equal(got.nan_to_num(), want.nan_to_num()):
            a, r = err(got, want)
            _check(r <= vd.DOT_TOL, f"{what}: {r:.2e} of max |plain| > "
                   f"{vd.DOT_TOL}")
            worst["abs"], worst["rel"] = (max(worst["abs"], a),
                                         max(worst["rel"], r))

    worst = {dtype: dict(abs=0.0, rel=0.0) for dtype in vd.DTYPES}

    for lb in vd.LBS:
        steps = vd.steps_for(lb)[1]
        for name, k, mode, dtype in vd.CASES:
            s, x = (t.to(dev) for t in vd.probe_inputs(k, lb, steps, dtype))
            got = vd.dot_steps_cuda(s, x, mode)
            want = vd.dot_steps_torch(s, x, mode)
            if mode == "repeat_add":   # the same adds in the same order
                _check(torch.equal(got, want),
                       f"{name} LB={lb}: repeat_add differs from plain")
            hold(got, want, f"{name} LB={lb}", worst[dtype])
            si, xi = ints((256, k), 1, dtype), ints((steps, k, lb), 3, dtype)
            _check(torch.equal(vd.dot_steps_cuda(si, xi, mode),
                               vd.dot_steps_torch(si, xi, mode)),
                   f"{name} LB={lb}: not exact on integer inputs")
        print(f"probes: vit_dotshapes LB={lb} steps={steps}: every case "
              f"within {vd.DOT_TOL} of plain, exact on integer inputs")

    # per step at LB 4480, K 16 (the TPU probe's first line, and its bf16
    # line), from the slope between 32 and 256 steps (the device's time),
    # the kernel's the median of 5 slopes; the library's: one call of the
    # loop's function, [S ... S] @ X.view(16 steps, LB) (the repeat made
    # once a length, outside the timing; torch.matmul in f32, torch.mm
    # with f32 out in bf16), per step by the same slope (median of 3), and
    # one such call of a single step
    clocks = _clocks()
    s1, s2 = vd.steps_long(4480)
    timed = {}
    for dtype, key in (("float32", "dot_steps"), ("bfloat16", "dot_bf16")):
        kern = _per_slope(lambda n, dtype=dtype: vd.probe(
            "loop dot", 16, 4480, n, "dot", dtype, "kernel", 10), s1, s2)
        t1, t2 = (vd.probe("loop dot", 16, 4480, n, "dot", dtype, "plain",
                           3) for n in (s1, s2))
        s, x = (t.to(dev) for t in vd.probe_inputs(16, 4480, s2, dtype))
        rep = {n: s.repeat(1, n) for n in (1, s1, s2)}

        def gemm(n, dtype=dtype, s=s, x=x, rep=rep):
            a, b = rep[n], x[:n].reshape(16 * n, 4480)
            if dtype == "float32":
                return lambda: torch.matmul(a, b)
            return lambda: torch.mm(a, b, out_dtype=torch.float32)
        hold(gemm(s2)(), vd.dot_steps_torch(s, x), f"the {dtype} GEMM of "
             f"{s2} steps", dict(abs=0.0, rel=0.0))
        lib = _per_slope(lambda n: _device_ms(gemm(n), 10), s1, s2, runs=3)
        timed[key] = dict(
            err=worst[dtype]["abs"], rel_err=worst[dtype]["rel"],
            tolerance=vd.DOT_TOL, ms=kern["median"], runs_ms=kern["runs_ms"],
            plain_ms=(t2 - t1) / (s2 - s1), library_ms=lib["median"],
            library_runs_ms=lib["runs_ms"],
            library_step_ms=_device_ms(gemm(1), 100), shape=(16, 4480),
            clocks=clocks)
        print(f"probes: vit_dotshapes {dtype} dot K=16 LB=4480: kernel "
              f"{kern['median'] * 1e3:.4f} us/step ({kern['min'] * 1e3:.4f}"
              f"-{kern['max'] * 1e3:.4f}, 5 slopes {s1}->{s2} steps; "
              f"clocks {clocks}), plain {timed[key]['plain_ms'] * 1e3:.2f}, "
              f"library: one GEMM of the loop {lib['median'] * 1e3:.4f} us "
              f"a step ({lib['min'] * 1e3:.4f}-{lib['max'] * 1e3:.4f}, 3 "
              f"slopes), one step's call "
              f"{timed[key]['library_step_ms'] * 1e3:.3f} us")
    timed["dot_steps"]["sass_per_step"] = steps_sass
    timed["dot_bf16"]["sass_per_stage"] = steps_sass["dot bf16 K=16"]
    # D2 past the L2: X of 73 to 294 MB, read from device memory each call
    l1, l2 = vd.STEPS_PAST_L2
    gen = torch.Generator(device=dev).manual_seed(12)
    sl = torch.randn((256, 16), generator=gen, device=dev).to(torch.bfloat16)
    xl = torch.randn((l2, 16, 4480), generator=gen, device=dev).to(
        torch.bfloat16)
    far = _per_slope(lambda n: _device_ms(
        lambda: vd.dot_steps_cuda(sl, xl[:n]), 5), l1, l2, runs=3)
    del xl
    timed["dot_bf16"].update(beyond_l2_ms=far["median"],
                             beyond_l2_runs_ms=far["runs_ms"])
    print(f"probes: vit_dotshapes bfloat16 dot K=16 LB=4480 past the L2: "
          f"kernel {far['median'] * 1e3:.4f} us/step ({far['min'] * 1e3:.4f}"
          f"-{far['max'] * 1e3:.4f}, 3 slopes {l1}->{l2} steps)")
    for key, name, probe in (("dot_steps", "dot_steps", "D1 f32"),
                             ("dot_bf16", "dot_steps_bf16", "D2 bf16")):
        gate = DOT_GATES_US[name]
        _check(timed[key]["ms"] * 1e3 <= gate,
               f"{probe} dot K=16 LB=4480 {timed[key]['ms'] * 1e3:.4f} us a "
               f"step > {gate} us")
    # D1's other cases (not gated): one slope each
    other = {}
    for label, k, mode, lb in vd.F32_TIMED[1:]:
        n1, n2 = vd.steps_long(lb)
        other[f"{label} LB={lb}"] = per = _per_slope(
            lambda n, k=k, mode=mode, lb=lb: vd.probe(
                label, k, lb, n, mode, "float32", "kernel", 10), n1, n2,
            runs=1)["median"]
        print(f"probes: vit_dotshapes {label} LB={lb}: kernel "
              f"{per * 1e3:.4f} us/step ({n1}->{n2} steps)")
    timed["dot_steps"]["other_cases_ms"] = other
    report["dot_steps"], report["dot_steps_bf16"] = (timed["dot_steps"],
                                                     timed["dot_bf16"])

    # the batched product at the probe's N (32 steps x LB 4480) and at a
    # tail N (not a multiple of D4's 64-column tiles); timed at the
    # probe's N in 5 runs in turns with its plain version, one
    # torch.matmul (out in the input's dtype) and the library call with
    # the kernel's function (f32 out: torch.mm's out_dtype for bf16)
    batched = {}
    for dtype in vd.DTYPES:
        worst = dict(abs=0.0, rel=0.0)
        for n in (32 * 4480, BATCHED_TAIL_N):
            s, x = (t.to(dev) for t in vd.batched_inputs(16, n, 1, dtype))
            hold(vd.dot_batched_cuda(s, x), vd.dot_batched_torch(s, x),
                 f"batched {dtype} N={n}", worst)
            si, xi = ints((256, 16), 1, dtype), ints((16, n), 3, dtype)
            _check(torch.equal(vd.dot_batched_cuda(si, xi),
                               vd.dot_batched_torch(si, xi)),
                   f"batched {dtype} N={n}: not exact on integer inputs")
        s, x = (t.to(dev) for t in vd.batched_inputs(16, 4480, 32, dtype))
        fns = {"kernel": lambda: vd.dot_batched_cuda(s, x),
               "plain": lambda: vd.dot_batched_torch(s, x),
               "matmul": lambda: torch.matmul(s, x)}
        if dtype == "bfloat16":
            fns["library"] = lambda: torch.mm(s, x, out_dtype=torch.float32)
        spread = _interleaved_ms(fns, 5)
        med = {k: v["median"] for k, v in spread.items()}
        batched[dtype] = dict(
            err=worst["abs"], rel_err=worst["rel"], ms=med["kernel"],
            plain_ms=med["plain"], matmul_ms=med["matmul"],
            library_ms=med.get("library", med["matmul"]), spread_ms=spread,
            x_bytes=x.numel() * x.element_size())
        print(f"probes: vit_dotshapes batched {dtype}: N 143360 and "
              f"{BATCHED_TAIL_N} within {vd.DOT_TOL} (worst "
              f"{worst['rel']:.2e}), exact on integers; ms median (min-max) "
              f"of 5 runs: "
              f"{_spread_text(spread)}")
    report["dot_batched"] = dict(tolerance=vd.DOT_TOL,
                                 sass_hgmma=steps_sass["batched bf16 K=16"],
                                 **batched)

    dots = {}
    for (rows, kdim, tag), (_, x, w) in zip(vpu_probe2.DOT_SHAPES,
                                            vpu_probe2.dot_inputs()):
        x, w = x.to(dev), w.to(dev)
        for n in vpu_probe2.DOT_NS:
            _check(torch.equal(vpu_probe2.dots_cuda(x, w, n),
                               vpu_probe2.dots_torch(x, w, n)),
                   f"dots {tag} n={n}: differs from plain")
        r = vpu_probe2.dot_rates(x, w)
        # the kernel's per dot: the median of 5 slopes from 40 to 1000
        kern = _per_slope(lambda n: _device_ms(
            lambda: vpu_probe2.dots_cuda(x, w, n), 10),
            *vpu_probe2.DOT_NS_LONG)
        dots[tag] = dict(ms=kern["median"], runs_ms=kern["runs_ms"],
                         short_ms=r["us"] / 1e3, plain_ms=r["plain_us"] / 1e3,
                         library_ms=_device_ms(lambda: torch.matmul(
                             w, x[:kdim]), 100),
                         rows=rows, kdim=kdim, sass_per_dot=dots_sass[tag])
        print(f"probes: vpu_probe2 dot {tag}: n {vpu_probe2.DOT_NS} bit for "
              f"bit; kernel {kern['median'] * 1e3:.4f} us/dot "
              f"({kern['min'] * 1e3:.4f}-{kern['max'] * 1e3:.4f}, 5 slopes "
              f"n 40->1000; n 8->40 {r['us']:.4f}; plain "
              f"{r['plain_us']:.2f}, torch.matmul "
              f"{dots[tag]['library_ms'] * 1e3:.2f} us a dot)")
    gate = DOT_GATES_US["dots_chain"]
    bm = dots["bm [256,8]"]["ms"] * 1e3
    _check(bm <= gate,
           f"D5 [256,8] {bm:.4f} us a dot > {gate} us")
    report["dots"] = dict(err=0, per_shape=dots, clocks=clocks)


def phase_probes(dev, report):
    """Phase 10: the probe kernels checked, then each probe's main() run
    in process with the launch counts set to 0 just before."""
    import torch
    from dabjax_torch.fec import viterbi_cuda as vc
    from dabjax_torch.tools import (hbm_probe, vit_dotshapes, vit_split,
                                    vit_split2, vit_variants, vpu_probe,
                                    vpu_probe2)
    from dabjax_torch.tools import vit_variants2 as vv2

    _probe_checks(dev, report)
    # (module, main()'s arguments, printed lines, what each line holds)
    dots_lines = (2 * len(vit_dotshapes.LBS) * len(vit_dotshapes.CASES)
                  + 2 * len(vit_dotshapes.BATCHED_CASES))
    cases = [(vv2, None, 2 * len(vv2.MODES), " ms"),
             (vit_split2, None, 4, " ms"), (hbm_probe, None, 5, " ms"),
             (vit_variants, None, 2 * len(vit_variants.MODES), " ms"),
             (vit_split, None, 3 * len(vit_variants.CHUNKS) + 1, " ms"),
             (vpu_probe, None,
              2 * len(vpu_probe.DTYPES) * len(vpu_probe.OPS), "us/op"),
             (vpu_probe2, ["vpu"], 2 * len(vpu_probe2.DTYPES), "us/op"),
             (vit_dotshapes, None, dots_lines, "us/step"),
             (vpu_probe2, ["dot"], 2 * len(vpu_probe2.DOT_SHAPES), "us/dot")]
    torch.cuda.synchronize()
    for mod in (vc, vv2, hbm_probe, vit_variants, vpu_probe, vpu_probe2,
                vit_dotshapes):
        mod.reset_launches()
    plane_launches = {}
    for mod, argv, n_cases, unit in cases:
        name = mod.__name__.rsplit(".", 1)[1]
        before = vit_variants.LAUNCHES
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = mod.main() if argv is None else mod.main(argv)
        plane_launches[name] = vit_variants.LAUNCHES - before
        lines = [line for line in buf.getvalue().splitlines() if line]
        print("\n".join(f"probe {name}: {line}" for line in lines))
        _check(rc == 0, f"{name}.main({argv or ''}) returned {rc}")
        _check(len(lines) == n_cases and all(unit in s for s in lines),
               f"{name}.main({argv or ''}) printed {len(lines)} lines, not "
               f"{n_cases}")
    torch.cuda.synchronize()
    launches = {"vit_variants2": vv2.LAUNCHES,
                "vit_split2": vc.WORDS_FORWARD_LAUNCHES,
                "hbm_copy": hbm_probe.COPY_LAUNCHES,
                "hbm_plane": hbm_probe.PLANE_LAUNCHES,
                "vit_variants": plane_launches["vit_variants"],
                "vit_split": plane_launches["vit_split"],
                "vpu_probe": vpu_probe.LAUNCHES,
                "vpu_probe2": vpu_probe2.LAUNCHES,
                "dot_steps": vit_dotshapes.LAUNCHES,
                "dot_steps_bf16": vit_dotshapes.BF16_LAUNCHES,
                "dot_batched": vit_dotshapes.BATCHED_LAUNCHES,
                "dot_batched_bf16": vit_dotshapes.BATCHED_BF16_LAUNCHES,
                "dots_chain": vpu_probe2.DOT_LAUNCHES}
    _check(all(n > 0 for n in launches.values()),
           f"the probes did not launch every kernel: {launches}")
    print(f"launches of the probes' main(): {launches}")
    report["probe_launches"] = launches


#: phase 11's (time, subch) mesh, every position on the one card, and
#: the gate on its sharded step's median wall ms (the step is host-bound
#: at a few ms on one card; a path that left the card takes seconds)
MESH_GRID, MESH_STEP_GATE_MS = (2, 4), 20.0


def _launch_counts():
    from dabjax_torch.fec import viterbi_cuda as vc
    return {"k1": vc.FORWARD_LAUNCHES, "k2": vc.TRACEBACK_LAUNCHES,
            "k3": vc.WORDS_FORWARD_LAUNCHES,
            "k4": vc.WORDS_TRACEBACK_LAUNCHES}


@contextlib.contextmanager
def _counted(acc: dict):
    """Add the Viterbi kernels' launches made in the block to ``acc``."""
    before = _launch_counts()
    yield
    for k, n in _launch_counts().items():
        acc[k] = acc.get(k, 0) + n - before[k]


#: the Viterbi kernels' wrappers, by their launch counts' names
_WRAPPERS = {"k1": "viterbi_forward_cuda", "k2": "viterbi_traceback_cuda",
             "k3": "viterbi_forward_words_cuda",
             "k4": "viterbi_traceback_words_cuda"}


@contextlib.contextmanager
def _recorded(calls: list):
    """Append ``(kernel, args, output)`` to ``calls`` for every Viterbi
    kernel launch made in the block, through its wrapper, so that each
    can be held against its plain version at the shape the path gave
    it."""
    from dabjax_torch.fec import viterbi_cuda as vc
    saved = {k: getattr(vc, name) for k, name in _WRAPPERS.items()}

    def recording(k, fn):
        def call(*args):
            out = fn(*args)
            calls.append((k, args, out))
            return out
        return call

    for k, fn in saved.items():
        setattr(vc, _WRAPPERS[k], recording(k, fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(vc, _WRAPPERS[k], fn)


def _hold_plain(calls: list, what: str) -> dict:
    """Each recorded launch against its kernel's plain version on the same
    inputs, exactly: K1's decisions, K2's bits, K3's words and ``last``
    (the plain forward over K3's pair-step input, its odd step's zero pad
    included), K4's bits.  Returns the shapes held by kernel: (B, T, 4)
    for K1, (B, T2, 8) for K3, (B, nbits) for K2 and K4."""
    import torch
    from dabjax_torch.fec import viterbi, viterbi_cuda as vc
    held = {}
    for k, args, out in calls:
        if k == "k1":
            (s8,) = args
            shape, ok = tuple(s8.shape), _k1_mismatches(out, s8) == 0
        elif k == "k2":
            dec, nbits = args
            shape = (dec.shape[0], nbits)
            ok = torch.equal(out, viterbi.viterbi_traceback_torch(
                vc.unpack_decisions(dec), nbits))
        elif k == "k3":
            x, fmt = args
            B, T2, _ = x.shape
            shape = tuple(x.shape)
            words, last = viterbi.viterbi_forward_words_torch(
                x.reshape(B, -1), 2 * T2 - 6, fmt)
            ok = torch.equal(out[0], words) and torch.equal(out[1], last)
        else:
            words, last, nbits = args
            shape = (words.shape[2], nbits)
            ok = torch.equal(out, viterbi.viterbi_traceback_words_torch(
                words, last, nbits))
        _check(ok, f"{what}: {k.upper()} != plain at {shape}")
        held.setdefault(k, set()).add(shape)
    return {k: sorted(v) for k, v in sorted(held.items())}


def _mesh_step_checks(dev, report, golden, mesh, path):
    """Phase 11a: the sharded step on phase 4's rows under i8lane and
    i8mxu, against phase 4's bits, the payload and the zero-history
    decode of time row 0, then 10 repeats, each equal to the first.
    The step's launches are added to ``path``."""
    import statistics
    import numpy as np
    import torch
    from dabjax_torch.fec import viterbi_cuda as vc
    from dabjax_torch.msc.cif import cifs_from_soft
    from dabjax_torch.msc.deinterleave import HISTORY
    from dabjax_torch.msc.subchannel import decode_subchannel, msc_soft
    from dabjax_torch.ofdm import demod
    from dabjax_torch.parallel.sharding import (make_sharded_inputs,
                                                sharded_ensemble_step)

    p, geoms, rows = golden["p"], golden["geoms"], golden["rows"]
    single = golden["bits"]                  # phase 4's [12, T - 15, 2304]
    T = golden["n_frames"] * p.cifs_per_frame
    T_row = T // MESH_GRID[0]
    step = sharded_ensemble_step(mesh, p, geoms[0])
    inputs = make_sharded_inputs(mesh, rows,
                                 np.array([g.start_addr for g in geoms]))
    runs, calls = {}, []
    for fmt, kernels in (("i8lane", ("k1", "k2")), ("i8mxu", ("k3", "k4"))):
        vc.SOFT_FMT = fmt
        n = {}
        try:
            with _counted(n), _counted(path), _recorded(calls):
                ratio, bits = step(*inputs)
        finally:
            vc.SOFT_FMT = "i8lane"
        # 2 FIC decodes (one a time row) and 8 MSC decodes (one a position)
        want = {k: 10 if k in kernels else 0 for k in n}
        _check(n == want, f"mesh {fmt}: launches {n}, not {want}")
        _check(float(ratio) == 1.0, f"mesh {fmt}: fic_ratio {float(ratio)}")
        _check(tuple(bits.shape) == (12, T, 2304),
               f"mesh {fmt}: bits {tuple(bits.shape)}")
        _check(torch.equal(bits[:, HISTORY:], single),
               f"mesh {fmt}: bits[:, 15:] differ from phase 4's")
        _check(torch.equal(bits[:, T_row: T_row + HISTORY],
                           single[:, T_row - HISTORY: T_row]),
               f"mesh {fmt}: time row 1's halo outputs differ")
        _check_payload(bits[:, HISTORY:], golden)
        runs[fmt] = dict(launches=n, bits=bits)
        print(f"mesh: sharded step {fmt} on {MESH_GRID}: fic_ratio 1.0, "
              f"bits[:, 15:] equal phase 4's and the payload, time row "
              f"1's 15 halo outputs equal; launches {n}")
    held = _hold_plain(calls, "mesh step")
    print(f"mesh: each of the step's {len(calls)} launches equals its "
          f"kernel's plain version; shapes {held}")
    del calls

    # time row 0 decodes over a zero history; its int8 soft bits, from a
    # demod of its 48 frames, against those of the whole 96-frame batch
    first = runs["i8lane"]["bits"]

    @torch.no_grad()
    def int8_cifs(frames):
        x = torch.view_as_complex(frames.contiguous())
        soft = demod.demodulate_frames_cfo(
            x, demod.fine_cfo_estimate(x, p), p)[0]
        return msc_soft(cifs_from_soft(soft, p))

    cifs = int8_cifs(rows[: rows.shape[0] // MESH_GRID[0]])
    n_soft = int((cifs != int8_cifs(rows)[:T_row]).sum())
    with torch.no_grad():
        block = torch.cat([cifs.new_zeros((HISTORY, cifs.shape[1])), cifs])
        idx = torch.tensor([[g.start_addr * 64 + j
                             for j in range(g.length_cus * 64)]
                            for g in geoms], device=dev)
        warm = decode_subchannel(block[:, idx].transpose(0, 1), geoms[0])
    _check(torch.equal(first[:, :T_row], warm),
           "time row 0 differs from the zero-history decode")
    print(f"mesh: time row 0's {T_row} outputs equal the decode over a "
          f"zero history; its int8 soft bits from a 48-frame demod differ "
          f"from the 96-frame batch's in {n_soft} of {cifs.numel()} "
          "values")

    # 10 repeats, each equal to the first; wall ms (host clock to a
    # synchronize) and device ms (behind a device sleep)
    wall = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _counted(path):
            ratio, bits = step(*inputs)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        _check(float(ratio) == 1.0 and torch.equal(bits, first),
               f"mesh: repeat {i} differs from the first run")
    with _counted(path):
        # single calls: a step's few hundred launches, five times over,
        # would fill the launch queue behind the sleep
        device_ms = _median_runs(lambda: step(*inputs), reps=1)["median"]
    median = statistics.median(wall)
    batch_ms = report["pipeline"]["seconds_per_batch"] * 1e3
    print(f"mesh: 10 repeats equal the first; step {median:.4f} ms wall "
          f"median (min {min(wall):.4f}, max {max(wall):.4f}), "
          f"{device_ms:.4f} ms of device time; phase 4's batch "
          f"{batch_ms:.4f} ms")
    _check(median <= MESH_STEP_GATE_MS,
           f"the sharded step takes {median:.4f} ms, above "
           f"{MESH_STEP_GATE_MS}")
    return dict(launches={f: r["launches"] for f, r in runs.items()},
                held_shapes=held, soft_int8_differing=n_soft,
                step_wall_ms=sorted(wall), step_median_ms=median,
                step_device_ms=device_ms, phase4_batch_ms=batch_ms)


def _mesh_receiver_checks(dev, mesh, loop_iq, path):
    """Phase 11b: ``Receiver(mesh=...)`` against the single-device
    ``Receiver`` on phase 5's ensemble, audio off, every logical frame
    captured; each runs twice, in turns (single, mesh, mesh, single), and
    the first run of each is compared, and every kernel launch of the
    first mesh run is held against its plain version.  The mesh
    receiver's launches are added to ``path``."""
    import numpy as np
    import torch
    from dabjax_torch import testing
    from dabjax_torch.parallel.dryrun import FrameCapture
    from dabjax_torch.runtime.config import ReceiverConfig
    from dabjax_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig(frames_per_block=64, decode_audio=False)
    wall = {"single": [], "mesh": []}
    frames, calls = {}, []
    for name in ("single", "mesh", "mesh", "single"):
        first = not wall[name]
        store = frames.setdefault(name, {}) if first else {}
        rx = Receiver(testing.LoopSource(loop_iq), cfg,
                      lambda db, sid, store=store: store.setdefault(
                          sid, FrameCapture()),
                      mesh=mesh if name == "mesh" else None, device=dev)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _counted(path if name == "mesh" else {}), (
                    _recorded(calls) if name == "mesh" and first
                    else contextlib.nullcontext()):
                m = rx.run(3)
            wall[name].append(time.perf_counter() - t0)
        finally:
            rx.close()
        _check(m.fic_ratio == 1.0, f"{name} receiver: {m.dashboard()}")
    held = _hold_plain(calls, "mesh receiver")
    n_held = len(calls)
    del calls
    single, sharded = frames["single"], frames["mesh"]
    _check(single and set(single) == set(sharded),
           f"subchannels {sorted(single)} vs {sorted(sharded)}")
    n = {}
    for k in single:
        a, b = single[k].frames, sharded[k].frames
        _check(len(a) == len(b) > 0 and np.array_equal(np.stack(a),
                                                        np.stack(b)),
               f"Receiver mesh path diverged on subch {k}")
        n[k] = len(a)
    print(f"mesh: Receiver(mesh={MESH_GRID}) over 3 blocks of 64 frames "
          f"bit-identical to the single-device Receiver ({n} logical "
          f"frames by subchannel), fic_ratio 1.0 both; wall in turns "
          f"(single, mesh, mesh, single): mesh "
          f"{', '.join(f'{t:.3f}' for t in wall['mesh'])} s, single "
          f"{', '.join(f'{t:.3f}' for t in wall['single'])} s")
    print(f"mesh: each of the mesh Receiver's {n_held} launches equals its "
          f"kernel's plain version; shapes {held}")
    return dict(wall_s=wall, frames_by_subch=n, held_shapes=held)


def _mesh_pad_cost(dev, golden, mesh):
    """Device ms of the MSC chain (``EnsembleDecoder.fused``) of phase
    4's 12 subchannels on the mesh (padded to 16 rows, 2 a position)
    against the first 8 (8 rows, 1 a position, the same 8 launches): 4
    pad rows cost half the difference."""
    import torch
    from dabjax_torch.msc.deinterleave import HISTORY
    from dabjax_torch.msc.subchannel import EnsembleDecoder
    from dabjax_torch.ofdm import demod
    from dabjax_torch.msc.cif import cifs_from_soft

    p, geoms, rows = golden["p"], golden["geoms"], golden["rows"]
    with torch.no_grad():
        x = torch.view_as_complex(rows.contiguous())
        soft = demod.demodulate_frames_cfo(
            x, demod.fine_cfo_estimate(x, p), p)[0]
        cifs = cifs_from_soft(soft, p)
    hist = cifs.new_zeros((HISTORY, cifs.shape[1]))
    blob = torch.empty(0, dtype=torch.uint8, device=dev)
    ms = {}
    for n in (12, 8):
        dec = EnsembleDecoder(geoms[:n], p, mesh, device=dev)
        ms[n] = _median_runs(torch.no_grad()(
            lambda: dec.fused(hist, cifs, blob)), reps=1)["median"]
    pad = (ms[12] - ms[8]) / 2
    print(f"mesh: MSC chain of 12 subchannels (16 rows) {ms[12]:.4f} "
          f"ms, of 8 (8 rows) {ms[8]:.4f} ms of device time: the 4 pad "
          f"rows cost {pad:.4f} ms ({100 * pad / ms[12]:.1f} %)")
    return dict(msc_ms_16_rows=ms[12], msc_ms_8_rows=ms[8],
                pad_rows_ms=pad)


def phase_mesh(dev, report, golden, loop_iq):
    """Phase 11: the multi-device path on a (2, 4) mesh of the one card.
    ``report["mesh"]["path_launches"]`` counts the Viterbi kernels'
    launches of the mesh path itself (the sharded step and the mesh
    receiver), not those of the references it is held to."""
    from dabjax_torch.parallel.dryrun import dryrun_multichip
    from dabjax_torch.parallel.mesh import make_mesh

    n = MESH_GRID[0] * MESH_GRID[1]
    mesh = make_mesh(n, MESH_GRID, devices=[dev] * n)
    path = {}
    out = _mesh_step_checks(dev, report, golden, mesh, path)
    out["receiver"] = _mesh_receiver_checks(dev, mesh, loop_iq, path)
    out["pad"] = _mesh_pad_cost(dev, golden, mesh)
    out["dryrun"] = dryrun_multichip(n, devices=[dev] * n)
    out["path_launches"] = path
    report["mesh"] = out


#: phase 12's shape: the core cell's block (360 frames, mode I, u8 rows)
DEMOD_FRAMES, DEMOD_MODE = 360, 1
#: phase 12's fine CFOs: frame f of the block is shifted by one of
#: DEMOD_FRAMES evenly spaced offsets in +-DEMOD_OFFSET carrier spacings
DEMOD_OFFSET = 0.4
#: Hz the kernels' fine CFO may miss each frame's known offset by: 0.5 %
#: of mode I's carrier spacing (the plain estimator missed by 0.53 Hz at
#: most over 24 such frames in float32 on a CPU; a wrong window or sign
#: misses by hundreds of Hz)
DEMOD_OFFSET_HZ = 5.0


def _demod_bytes(p, F: int) -> dict:
    """Each demod kernel's input read once and output written once (u8
    rows, 4-byte CFOs): the guards and their copies; the useful samples
    in and the complex64 windows out; the K active carriers of each
    spectrum in and the float32 soft bits out (the carrier table too)."""
    return {"guard_corr": F * (p.L - 1) * p.T_g * 2 * 2 + F * 4 * 3,
            "mix_windows": F * p.L * p.T_u * (2 + 8) + F * 4,
            "dqpsk_soft": (F * p.L * p.K * 8 + F * (p.L - 1) * 2 * p.K * 4
                           + p.K * 4 + F * 4)}


def _demod_rows(golden, F: int):
    """(u8 rows [F, need, 2], offsets [F] float64 Hz): phase 4's golden
    IQ (mode I), frame f its frame f mod 96 shifted by a known fine CFO,
    quantised as ``testing.LoopSource`` quantises (round(90 x + 128),
    clipped), on the card."""
    import math
    import torch
    p, base = golden["p"], torch.view_as_complex(golden["rows"])
    dev = base.device
    off = (torch.linspace(-DEMOD_OFFSET, DEMOD_OFFSET, F, dtype=torch.float64,
                          device=dev) * p.carrier_diff)
    n = torch.arange(base.shape[1], dtype=torch.float64, device=dev)
    x = (base[torch.arange(F, device=dev) % base.shape[0]].to(
        torch.complex128) * torch.exp(2j * math.pi * off[:, None] * n / FS))
    u8 = torch.round(torch.view_as_real(x) * 90.0 + 128.0).clamp_(0, 255)
    return u8.to(torch.uint8), off


def _fine_f64(x, p):
    """[F] float64 Hz: the guard-interval correlation of complex rows
    summed in complex128, the fine CFO's reference."""
    import math
    import torch
    T_s, T_u, T_g, L = p.T_s, p.T_u, p.T_g, p.L
    x = x.to(torch.complex128)
    g = x[:, T_s - T_g: L * T_s - T_g].unfold(-1, T_g, T_s)
    ref = x[:, T_s - T_g + T_u: L * T_s - T_g + T_u].unfold(-1, T_g, T_s)
    corr = torch.sum(g * torch.conj(ref), dim=(-2, -1))
    return -torch.angle(corr) / math.pi * (p.carrier_diff / 2.0)


def _max_err(a, b) -> float:
    import torch
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.double() - b.double()).abs().max())


def phase_demod(dev, report, golden):
    """Phase 12: the demod kernels at the core cell's shape, on u8 rows of
    a real signal with known fine CFOs.  Soft bits, CIF block, windows
    and PRS spectrum equal the plain chain's bit for bit given the same
    CFO; the fine CFO is no further from a float64 sum than the plain
    float32 sum's but 4 ulp, and within ``DEMOD_OFFSET_HZ`` of each
    frame's offset; the total CFO is fine + coarse bit for bit.  Each
    kernel's device time beside its bytes' bound and beside its own plain
    counterpart on the same inputs; the FFT between them, the whole
    ``demodulate_rows`` and the whole plain chain; the launches a call."""
    import numpy as np
    import torch
    from dabjax_torch.msc.cif import cifs_from_soft
    from dabjax_torch.ofdm import demod, demod_cuda

    p, F = golden["p"], DEMOD_FRAMES
    _check(p.mode == DEMOD_MODE, f"phase 4 rendered mode {p.mode}")
    rows, off = _demod_rows(golden, F)
    coarse = torch.full((F,), -3.0 * p.carrier_diff, device=dev)
    demod_cuda.reset_launches()
    d = demod.demodulate_rows(rows, coarse, p, "u8")
    torch.cuda.synchronize()
    per_call = (demod_cuda.GUARD_LAUNCHES, demod_cuda.MIX_LAUNCHES,
                demod_cuda.SOFT_LAUNCHES)
    _check(per_call == (1, 1, 1), f"demod launches a call {per_call}")

    def bits(t):
        return (torch.view_as_real(t) if t.is_complex() else t).view(
            torch.int32)

    # the plain chain's steps on the same inputs, given the kernels' CFO
    x = demod.complex_rows(rows, "u8")
    mixed = demod_cuda.mix_windows(rows, d.cfo, p, "u8", demod.FS)
    mixed_plain = demod.mix_windows_torch(x, d.cfo, p)
    spec = torch.fft.fft(mixed, dim=-1)
    soft = demod.dqpsk_soft_torch(spec, d.cfo, p)
    _check(torch.equal(bits(mixed), bits(mixed_plain)),
           "mix_windows differs from the plain ramp bit for bit")
    _check(torch.equal(bits(d.cifs), bits(cifs_from_soft(soft, p)))
           and torch.equal(bits(d.fic), bits(soft[:, : p.fic_symbols]))
           and torch.equal(bits(d.spec0), bits(spec[:, 0])),
           "dqpsk_soft differs from the plain chain given the same CFO")
    _check(torch.equal(bits(d.cfo), bits(d.fine + coarse)),
           "guard_corr's total CFO is not fine + coarse bit for bit")
    want = _fine_f64(x, p)
    plain = demod.fine_cfo_estimate_torch(x, p)
    err = {"guard_corr": _max_err(d.fine, want),
           "mix_windows": _max_err(mixed, mixed_plain),
           "dqpsk_soft": max(_max_err(d.cifs, cifs_from_soft(soft, p)),
                             _max_err(d.fic, soft[:, : p.fic_symbols]))}
    plain_err = _max_err(plain, want)
    ulp4 = 4 * float(np.spacing(np.float32(float(want.abs().max()))))
    _check(err["guard_corr"] <= plain_err + ulp4,
           f"guard_corr's fine CFO is {err['guard_corr']} Hz from the "
           f"float64 sum, the plain sum's {plain_err} + 4 ulp ({ulp4})")
    off_err = _max_err(d.fine, off)
    _check(off_err <= DEMOD_OFFSET_HZ,
           f"guard_corr misses the known offsets by {off_err} Hz, above "
           f"{DEMOD_OFFSET_HZ}")
    del mixed_plain, soft, want

    calls = {
        "guard_corr": lambda: demod_cuda.guard_corr(rows, p, "u8", coarse),
        "mix_windows": lambda: demod_cuda.mix_windows(rows, d.cfo, p, "u8",
                                                      demod.FS),
        "fft": lambda: torch.fft.fft(mixed, dim=-1),
        "dqpsk_soft": lambda: demod_cuda.dqpsk_soft(
            spec, d.cfo, p, demod.FS, d.fic, d.cifs.view(F, -1, 2 * p.K)),
        "demodulate_rows": lambda: demod.demodulate_rows(rows, coarse, p,
                                                         "u8"),
    }
    # each kernel's plain counterpart takes the rows as complex64, made
    # once by ``u8_convert``, which both kernels that read rows fold in
    plain_calls = {
        "guard_corr": lambda: demod.fine_cfo_estimate_torch(x, p) + coarse,
        "mix_windows": lambda: demod.mix_windows_torch(x, d.cfo, p),
        "dqpsk_soft": lambda: cifs_from_soft(
            demod.dqpsk_soft_torch(spec, d.cfo, p), p),
        "u8_convert": lambda: demod.complex_rows(rows, "u8"),
    }
    times = {name: _median_runs(fn, reps=10) for name, fn in calls.items()}
    plain_t = {name: _median_runs(fn, reps=5)
               for name, fn in plain_calls.items()}
    chain = _median_runs(lambda: demod.demodulate_rows_torch(
        rows, coarse, p, "u8"), reps=5)
    nbytes = _demod_bytes(p, F)
    out = {"frames": F, "mode": p.mode, "launches_a_call": dict(zip(
        ("guard_corr", "mix_windows", "dqpsk_soft"), per_call)),
           "ms": {k: v["median"] for k, v in times.items()},
           "runs_ms": {k: v["runs_ms"] for k, v in times.items()},
           "plain_ms": {k: v["median"] for k, v in plain_t.items()},
           "plain_runs_ms": {k: v["runs_ms"] for k, v in plain_t.items()},
           "chain_ms": chain["median"], "chain_runs_ms": chain["runs_ms"],
           "max_abs_err": err, "plain_fine_err_hz": plain_err,
           "offset_err_hz": off_err, "bytes": nbytes,
           "bound": {k: _bound(n, 0, "lane_op") for k, n in nbytes.items()}}
    for k in nbytes:
        out["bound"][k]["x_bound"] = (out["ms"][k]
                                      / out["bound"][k]["bound_ms"])
    print(f"demod: {F} frames of mode {p.mode}, u8 rows of a real signal: "
          "kernels equal the plain chain bit for bit given the same CFO; "
          f"fine CFO {err['guard_corr']:.3e} Hz from float64 (plain "
          f"{plain_err:.3e}), {off_err:.4f} Hz from the known offsets; "
          "device ms " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["ms"].items())
          + "; plain ms " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["plain_ms"].items())
          + f"; plain chain {chain['median']:.4f}; x bound " + ", ".join(
              f"{k} {v['x_bound']:.2f}" for k, v in out["bound"].items()))
    report["demod"] = out


#: the card's data-sheet rates (NVIDIA H100 SXM, dense, at 700 W): device
#: memory; FP32 outside the tensor cores, an FMA counted as 2; one op a
#: lane and clock (half the FP32 rate: 128 lanes x 132 SMs x 1.98 GHz, the
#: rate ``vpu_probe``'s long chains reach for f32 and int32 adds alike);
#: bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32_flop": 67e12, "lane_op": 33.5e12,
                  "bf16_flop": 989e12}
#: the card's SMs and SM clock (132 and 1.98 GHz at 700 W, as phase 1
#: prints it), and the results a clock an SM of each pipe of sm_90 (the
#: CUDA C++ Programming Guide's throughput table of native arithmetic
#: instructions, compute capability 9.0): FP32 add, multiply and FMA 128;
#: compare, minimum and maximum (FMNMX, IMNMX) and 32-bit integer add 64;
#: and the issue limit of all pipes together, one warp instruction a
#: clock on each of the SM's 4 schedulers
SMS, SM_HZ = 132, 1.98e9
PIPE_RESULTS = {"fp32": 128, "alu": 64, "issue": 128}


def _bound(nbytes: float, ops: float, unit: str) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` over the peak rate of ``unit``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[unit]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _pipe_bound(nbytes: float, instructions: dict) -> dict:
    """The least time of a kernel whose thread instructions by pipe are
    ``instructions``: the larger of ``nbytes`` over the memory rate and
    the slowest pipe (its instructions over its rate, or all of them over
    the issue limit); ``pipe_ms`` gives each pipe's time."""
    clocks = {p: n / (PIPE_RESULTS[p] * SMS * SM_HZ)
              for p, n in instructions.items()}
    clocks["issue"] = (sum(instructions.values())
                       / (PIPE_RESULTS["issue"] * SMS * SM_HZ))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, max(clocks.values())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "pipe_ms": {"bytes": t_bytes * 1e3,
                        **{p: t * 1e3 for p, t in clocks.items()}}}


def _words_stage_bound(B: int, Tw: int, acs: bool = True) -> dict:
    """P1's bound: int8 pair steps in and the words out, and with ``acs``
    (its ``maxtree`` and ``full`` stages) 7 operations a state a pair step
    (radix 4: four adds and three maxima)."""
    return _bound(B * Tw * 8 + Tw // 16 * 64 * B * 4,
                  B * Tw * 64 * 7 if acs else 0, "lane_op")


def _plane_bound(B: int, Tp: int, K: int = 16) -> dict:
    """P4's bound: K float soft values a pair step in (16 with ksplit) and
    the int8 plane out; 7 operations a state a pair step (``full``; the
    bytes bound every mode)."""
    return _bound(B * Tp * K * 4 + Tp * 64 * B, B * Tp * 64 * 7, "lane_op")


def _kernel_lines(report, launches):
    """The kernels line: each kernel's launches on its path, error against
    its plain version, times (kernel, plain, one library call where one
    computes the same function, else None) and bound, at the shapes this
    run timed.  Work counts: each input byte read once and each output
    byte written once (the tracebacks read the one decision word a step
    needs); a Viterbi step's operations are its add-compare-select, two
    adds and one compare-select a state (radix 2), four adds and three
    compare-selects a state (radix-4 pair step)."""
    from dabjax_torch import tools
    from dabjax_torch.fec import viterbi_cuda as vc
    from dabjax_torch.tools import vit_variants, vpu_probe, vpu_probe2

    B, nbits = tools.CODEWORDS, tools.NBITS
    T = nbits + 6
    T2 = -(-T // 2)
    W = -(-T2 // 16)                        # radix-4 words, 16 pair steps
    Tw = W * 16                             # pair steps of the stage probe
    Tp = vit_variants.pair_steps(nbits)[1]  # pair steps of the plane probe
    acs2, acs4 = 64 * 3, 64 * 7
    words_io = B * T2 * 8 + W * 64 * B * 4 + B * 4
    src, probes = ("dabjax_torch/csrc/viterbi.cu",
                   "dabjax_torch/csrc/probes.cu")
    chains, dots = "dabjax_torch/csrc/chains.cu", "dabjax_torch/csrc/dots.cu"
    pl = report["probe_launches"]

    # times at the MSC shape (i8mxu for K3/K4); errors the largest over
    # both main-path shapes (and every word format)
    msc, words = report["msc"], report["words_msc_i8mxu"]
    checked = {"k1": [report["msc"], report["fic"]],
               "k2": [report["msc"], report["fic"]],
               "k3": [report[f"words_{s}_{f}"] for s in ("msc", "fic")
                      for f in vc.WORD_FORMATS]}
    checked["k4"] = checked["k3"]
    err = {k: max(r[k][0] for r in rs) for k, rs in checked.items()}

    def line(name, source, replaces, n, e, ms, plain_ms, library_ms, bound,
             **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": e,
                "ms": ms, "plain_ms": plain_ms, **bound,
                "library_ms": library_ms, **extra}

    stages, split2 = report["vit_variants2"], report["vit_split2"]
    plane, split = report["vit_variants"], report["vit_split"]
    copy, dplane = report["hbm_copy"], report["hbm_plane"]
    chain, pair = report["vpu_probe"], report["vpu_probe2"]
    steps, batched, chained = (report["dot_steps"], report["dot_batched"],
                               report["dots"])
    steps16 = report["dot_steps_bf16"]
    n_chain = vpu_probe.SHAPE[0] * vpu_probe.SHAPE[1]
    n_pair = vpu_probe2.SHAPE[0] * vpu_probe2.SHAPE[1]
    n_batch = 32 * 4480
    bm = chained["per_shape"]["bm [256,8]"]
    f32, bf16 = batched["float32"], batched["bfloat16"]
    dm, demod_src = report["demod"], "dabjax_torch/csrc/demod.cu"
    demod_lines = [
        # no TPU kernel: dabjax's demod is a jnp chain XLA fuses; the
        # plain time is the kernel's own step of the plain chain, on
        # complex64 rows (u8_convert_ms apart), the error guard_corr's Hz
        # from a float64 sum and the others' from the plain chain
        line(k, demod_src, "none (dabjax/ofdm/demod.py, a jnp chain)",
             launches[k], dm["max_abs_err"][k], dm["ms"][k],
             dm["plain_ms"][k], None, dm["bound"][k],
             runs_ms=dm["runs_ms"][k], plain_runs_ms=dm["plain_runs_ms"][k],
             launches_a_call=dm["launches_a_call"][k],
             frames=dm["frames"], fft_ms=dm["ms"]["fft"],
             demodulate_rows_ms=dm["ms"]["demodulate_rows"],
             chain_ms=dm["chain_ms"],
             u8_convert_ms=dm["plain_ms"]["u8_convert"])
        for k in ("guard_corr", "mix_windows", "dqpsk_soft")]
    return [
        line("viterbi_forward_acs", src, "dabjax/fec/viterbi_pallas.py:85",
             launches["k1"], err["k1"], msc["k1"][1], msc["k1"][2], None,
             _bound(B * T * 4 + B * T * 8, B * T * acs2, "lane_op"),
             runs_ms=msc["k1_runs_ms"], sass=report["k1_sass"]),
        line("viterbi_traceback", src, "dabjax/fec/viterbi_pallas.py:218",
             launches["k2"], err["k2"], msc["k2"][1], msc["k2"][2], None,
             _bound(B * T * 4 + B * nbits * 4, B * T * 3, "lane_op"),
             runs_ms=msc["k2_runs_ms"]),
        line("viterbi_forward_acs_words", src,
             "dabjax/fec/viterbi_pallas.py:149", launches["k3"], err["k3"],
             words["k3"][1], words["k3"][2], None,
             _bound(words_io, B * T2 * acs4, "lane_op"),
             runs_ms=words["k3_runs_ms"], sass=report["k3_sass"]["i8mxu"],
             ms_by_format={f: report[f"words_msc_{f}"]["k3"][1]
                           for f in vc.WORD_FORMATS}),
        line("viterbi_traceback_words", src,
             "dabjax/fec/viterbi_pallas.py:218", launches["k4"], err["k4"],
             words["k4"][1], words["k4"][2], None,
             _bound(B * T2 * 4 + B * nbits * 4, B * T2 * 3, "lane_op"),
             runs_ms=words["k4_runs_ms"]),
        # the stage probe's own kernel at its deepest stage (its full
        # stage is K3's, under "modes")
        line("forward_words_stage", probes, "tools/vit_variants2.py:47",
             pl["vit_variants2"], stages["err"],
             stages["modes"]["maxtree"]["ms"],
             stages["modes"]["maxtree"]["plain_ms"], None,
             _words_stage_bound(B, Tw), runs_ms=stages["modes"]["maxtree"][
                 "runs_ms"], modes=stages["modes"]),
        line("viterbi_forward_acs_words_i8_prepped", src,
             "tools/vit_split2.py:54", pl["vit_split2"], split2["err"],
             split2["ms"], split2["plain_ms"], None,
             _bound(words_io, B * T2 * acs4, "lane_op"),
             prep_ms=split2["prep_ms"], full_ms=split2["full_ms"]),
        line("scale_copy", probes, "tools/hbm_probe.py:43",
             pl["hbm_copy"], copy["err"], copy["ms"], copy["plain_ms"],
             copy["library_ms"],
             _bound(copy["nbytes"], copy["elements"], "lane_op"),
             gb_per_s=copy["gb_per_s"],
             plain_gb_per_s=copy["plain_gb_per_s"]),
        # the library call: one fill_ of the plane (its output where the
        # input's 8-step blocks start with one value)
        line("decision_plane", probes, "tools/hbm_probe.py:69",
             pl["hbm_plane"], dplane["err"], dplane["ms"],
             dplane["plain_ms"], dplane["library_ms"],
             _bound(dplane["nbytes"], 0, "lane_op"),
             gb_per_s=dplane["gb_per_s"],
             plain_gb_per_s=dplane["plain_gb_per_s"],
             spread_ms=dplane["device_spread_ms"],
             x_fill_int=dplane["x_fill_int"],
             events_ms=dplane["events_spread_ms"]["kernel"]["median"],
             events_fill_int_ms=dplane["events_spread_ms"]["fill_int"][
                 "median"],
             x_fill_int_events=dplane["x_fill_int_events"]),
        # the plane forward: full mode, ksplit, C = 8
        line("forward_plane", probes, "tools/vit_variants.py:38",
             pl["vit_variants"], plane["err"], plane["modes"]["full"]["ms"],
             plane["modes"]["full"]["plain_ms"], None, _plane_bound(B, Tp),
             runs_ms=plane["modes"]["full"]["runs_ms"],
             modes=plane["modes"]),
        line("forward_plane_full", probes, "tools/vit_split.py:59",
             pl["vit_split"], split["err"], split["ms"]["C8_unroll0"],
             split["plain_ms"], None, _plane_bound(B, Tp),
             unroll_ms=split["ms"], prep_ms=split["prep_ms"]),
        # the chains: one launch at the TPU probe's longest chain (float32
        # mix n 64: an FADD and an FMNMX an element a step; pair n 96: 48
        # of each), device ms beside the host's issue time, bound by pipe;
        # the per-op us of every dtype in the sub-object
        line("elementwise_chain", chains, "tools/vpu_probe.py:39",
             pl["vpu_probe"], chain["err"], chain["ms"], chain["plain_ms"],
             None, _pipe_bound(8 * n_chain, {"fp32": 64 * n_chain,
                                             "alu": 64 * n_chain}),
             runs_ms=chain["runs_ms"], host_ms=chain["host_ms"],
             per_op_us=chain["per_op"]),
        line("pair_chain", chains, "tools/vpu_probe2.py:37",
             pl["vpu_probe2"], pair["err"], pair["ms"], pair["plain_ms"],
             None, _pipe_bound(12 * n_pair, {"fp32": 48 * n_pair,
                                             "alu": 48 * n_pair}),
             runs_ms=pair["runs_ms"], host_ms=pair["host_ms"],
             per_op_us=pair["per_op"]),
        # the dot shapes: times per step (f32 dot, K 16, LB 4480) and per
        # dot ([256, 8] @ [8, 4480]), from the slope between two lengths;
        # the step loops' library call is one GEMM of the whole loop, per
        # step by the same slope (one step's call under library_step_ms),
        # the chained dots' one torch.matmul of a dot's shape
        line("dot_steps", dots, "tools/vit_dotshapes.py:49",
             pl["dot_steps"], steps["err"], steps["ms"], steps["plain_ms"],
             steps["library_ms"],
             _bound(16 * 4480 * 4, 256 * 16 * 4480 * 2, "fp32_flop"),
             unit="per step", rel_err=steps["rel_err"],
             tolerance=steps["tolerance"], runs_ms=steps["runs_ms"],
             library_step_ms=steps["library_step_ms"],
             clocks=steps["clocks"], other_cases_ms=steps["other_cases_ms"],
             sass_per_step=steps["sass_per_step"]),
        # the bf16 line of the same probe (D2, wgmma fed by a TMA ring):
        # bf16 X read once a step; beyond_l2_ms is the slope with X past
        # the L2 (512 -> 2048 steps)
        line("dot_steps_bf16", dots, "tools/vit_dotshapes.py:49",
             pl["dot_steps_bf16"], steps16["err"], steps16["ms"],
             steps16["plain_ms"], steps16["library_ms"],
             _bound(16 * 4480 * 2, 256 * 16 * 4480 * 2, "bf16_flop"),
             unit="per step", rel_err=steps16["rel_err"],
             tolerance=steps16["tolerance"], runs_ms=steps16["runs_ms"],
             beyond_l2_ms=steps16["beyond_l2_ms"],
             beyond_l2_runs_ms=steps16["beyond_l2_runs_ms"],
             library_step_ms=steps16["library_step_ms"],
             clocks=steps16["clocks"],
             sass_hgmma_per_stage=steps16["sass_per_stage"]),
        line("dot_batched", dots, "tools/vit_dotshapes.py:92",
             pl["dot_batched"], f32["err"], f32["ms"], f32["plain_ms"],
             f32["library_ms"],
             _bound(256 * 16 * 4 + f32["x_bytes"] + 256 * n_batch * 4,
                    256 * 16 * n_batch * 2, "fp32_flop"),
             rel_err=f32["rel_err"], tolerance=batched["tolerance"],
             spread_ms=f32["spread_ms"]),
        # the bf16 half of row 13 (D4, wgmma + TMA); the library call is
        # torch.mm with f32 out, the kernel's function
        line("dot_batched_bf16", dots, "tools/vit_dotshapes.py:92",
             pl["dot_batched_bf16"], bf16["err"], bf16["ms"],
             bf16["plain_ms"], bf16["library_ms"],
             _bound(256 * 16 * 2 + bf16["x_bytes"] + 256 * n_batch * 4,
                    256 * 16 * n_batch * 2, "bf16_flop"),
             rel_err=bf16["rel_err"], tolerance=batched["tolerance"],
             matmul_bf16_out_ms=bf16["matmul_ms"],
             spread_ms=bf16["spread_ms"],
             sass_hgmma_per_tile=batched["sass_hgmma"]),
        line("dots_chain", dots, "tools/vpu_probe2.py:78",
             pl["dots_chain"], chained["err"], bm["ms"], bm["plain_ms"],
             bm["library_ms"], _bound(0, 256 * 8 * 4480 * 2, "fp32_flop"),
             unit="per dot", runs_ms=bm["runs_ms"], clocks=chained["clocks"],
             per_shape=chained["per_shape"]),
        *demod_lines,
    ]


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
    from dabjax_torch.ofdm import demod_cuda
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")

    report = {}

    def timed(phase, *args):
        """Run a phase and print the seconds it took."""
        t = time.perf_counter()
        out = phase(dev, report, *args)
        print(f"seconds: {phase.__name__} {time.perf_counter() - t:.1f}")
        return out

    print(f"clocks under a device sleep (sm, max sm): {_clocks()}")
    timed(phase_kernels)
    timed(phase_words)
    vc.reset_launches()
    demod_cuda.reset_launches()
    golden = timed(phase_pipeline)
    loop_iq = timed(phase_receiver)
    torch.cuda.synchronize()
    launches = {"k1": vc.FORWARD_LAUNCHES, "k2": vc.TRACEBACK_LAUNCHES,
                "guard_corr": demod_cuda.GUARD_LAUNCHES,
                "mix_windows": demod_cuda.MIX_LAUNCHES,
                "dqpsk_soft": demod_cuda.SOFT_LAUNCHES}
    _check(all(n > 0 for n in launches.values()),
           f"main path did not launch every kernel: {launches}")
    vc.reset_launches()
    timed(phase_formats, golden)
    torch.cuda.synchronize()
    launches.update(k3=vc.WORDS_FORWARD_LAUNCHES,
                    k4=vc.WORDS_TRACEBACK_LAUNCHES)
    _check(launches["k3"] > 0 and launches["k4"] > 0,
           f"the word-format path did not launch K3/K4: {launches}")
    print(f"launches on the main path: {launches}")
    timed(phase_stages, golden)
    timed(phase_entry, loop_iq)
    timed(phase_trace, golden)
    timed(phase_probes)
    torch.cuda.synchronize()
    vc.reset_launches()
    timed(phase_mesh, golden, loop_iq)
    torch.cuda.synchronize()
    mesh_launches = report["mesh"]["path_launches"]
    _check(all(n > 0 for n in mesh_launches.values()),
           f"the mesh path did not launch every kernel: {mesh_launches}")
    print(f"launches on the mesh path: {mesh_launches}")
    timed(phase_demod, golden)

    kernels = _kernel_lines(report, launches)
    for line, k in zip(kernels, ("k1", "k2", "k3", "k4")):
        line["launches_by_path"] = {"main": launches[k],
                                    "mesh": mesh_launches[k]}
    print(json.dumps({"kernels": kernels, "card": card,
                      "pipeline": report["pipeline"],
                      "receiver": report["receiver"],
                      "fic_shape": report["fic"],
                      "word_formats": {f"{s}_{f}": report[f"words_{s}_{f}"]
                                       for s in ("msc", "fic")
                                       for f in vc.WORD_FORMATS},
                      "formats": report["formats"],
                      "stages": report["stages"],
                      "bank": report["bank"], "trace": report["trace"],
                      "mesh": report["mesh"], "demod": report["demod"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
