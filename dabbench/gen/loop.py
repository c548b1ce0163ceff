"""A configuration file and a seed -> a seamless loop of u8 IQ.

The loop is one whole payload period of ``PERIOD_CIFS`` (120) CIFs: the
MP2 payload repeats every 40 CIFs, the HE-AAC one every 60.  The mode
cuts it into frames (:func:`period`): 30 frames of Mode I (4 CIFs a
frame), 120 of Mode II (1), 60 of Mode IV (2).  It is rendered from CIF
``START_CIF`` (16) on, after the time interleaver's 15-CIF warm-up, so
the frame after the loop's last would equal its first again in every MSC
bit: played end to end the loop is one endless stream.  Mode III is
refused: the reference's coarse-CFO search runs past the edges of its
spectrum.  AWGN at the configuration's SNR is added over the loop, and
the sum is quantised to u8 (I, Q) pairs as an SDR delivers them.

The seed picks each service's tone and the noise; it never changes a
size, so every seed asks for the same work.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Dict, List, NamedTuple

import numpy as np

from dabbench.gen.constants import get_mode
from dabbench.gen.fec import conv, prbs, puncture
from dabbench.gen.fic_layout import fic_codewords_per_frame, fic_profile
from dabbench.gen.tx import fig as figmod
from dabbench.gen.tx.fig import ServiceSpec
from dabbench.gen.tx.modulator import Modulator

__all__ = ["PERIOD_CIFS", "START_CIF", "Period", "period", "PERIOD_FRAMES",
           "CONFIGS", "load_config",
           "service_specs", "mp2_payload", "dabplus_payload",
           "payload_generators", "Loop", "make_loop", "make_loops",
           "quantize_u8", "u8_to_complex", "rng_for", "fib_rotation",
           "RotatingModulator", "start_offset"]

#: CIFs in one loop period
PERIOD_CIFS = 120
#: the loop's first CIF, after the time interleaver's 15-CIF warm-up
START_CIF = 16
#: u8 scale: x * U8_SCALE + 128, clipped (unit-power IQ clips in 0.1 % of samples)
U8_SCALE = 64.0

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def load_config(name: str) -> Dict:
    """``dabbench/configs/<name>.json``."""
    with open(CONFIGS / f"{name}.json") as f:
        cfg = json.load(f)
    if cfg["name"] != name:
        raise ValueError(f"config file {name}.json names {cfg['name']}")
    return cfg


class Period(NamedTuple):
    """A loop period in frames of one mode."""
    frames: int     # frames in one loop period
    start: int      # the loop's first frame


def period(p) -> Period:
    """The loop period of mode ``p`` (a ``DabParams``): ``PERIOD_CIFS``
    CIFs from CIF ``START_CIF`` on, in the mode's frames."""
    if p.mode == 3:
        raise ValueError(
            "Mode III has no loop: the reference's coarse-CFO search "
            "slides the 192-carrier band +-35 bins in a 256-point "
            "spectrum, past its edges")
    return Period(PERIOD_CIFS // p.cifs_per_frame,
                  START_CIF // p.cifs_per_frame)


#: Mode I's frames a period, which the port's card tests import
PERIOD_FRAMES = period(get_mode(1)).frames


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator from a run's seed (any whole number) and a salt."""
    return np.random.default_rng([seed & (2 ** 63 - 1), *salt])


def service_specs(cfg: Dict) -> List[ServiceSpec]:
    return [ServiceSpec(label=s["label"], sid=s["sid"], subch_id=s["subch"],
                        start_addr=s["start_cu"], bitrate=s["bitrate"],
                        protection=s["protection"], prot_level=s["level"],
                        kind="DAB+" if s["kind"] == "DAB+" else "DAB")
            for s in cfg["services"]]


def mp2_payload(bitrate: int, tone_hz: float) -> Callable[[int], np.ndarray]:
    """Real MP2 frames of a tone, one a logical frame, cycled every 40
    CIFs (the port's ``testing.mp2_payload_gen`` with the bitrate and the
    tone as parameters)."""
    from dabbench.gen.audio.mp2 import Mp2Encoder
    enc = Mp2Encoder(bitrate=bitrate, mode=3)
    n = 40
    t = np.arange(1152 * n) / 48000
    sig = 0.4 * np.sin(2 * np.pi * tone_hz * t)
    frames = [np.unpackbits(np.frombuffer(
        enc.encode(sig[i * 1152:(i + 1) * 1152]), np.uint8))
        for i in range(n)]
    return lambda cif: frames[cif % n]


def dabplus_payload(bitrate: int, tone_hz: float
                    ) -> Callable[[int], np.ndarray]:
    """Real HE-AAC superframes of a tone, cycled every 60 CIFs (the
    port's ``testing.dabplus_payload_gen`` with the tone as a
    parameter)."""
    from dabbench.gen.audio import mp4
    from dabbench.gen.audio.sbr import SbrHeader
    from dabbench.gen.tx.sbr_enc import HeAacEncoder, SbrWriter
    w = SbrWriter(SbrHeader(), 48000)
    nb = w.ft.n_low
    bits = w.sce_payload([np.full(nb, 52, int)],
                         [np.full(w.ft.n_q, 10, int)],
                         invf=[2] * w.ft.n_q)
    n_sf = 12
    t = np.arange(n_sf * 3 * 960) / 24000
    tone = 0.3 * np.sin(2 * np.pi * tone_hz * t)
    aus = HeAacEncoder(6, 1, 960, lambda i: bits, max_q=400).encode(tone)
    frames = [mp4.build_superframe(bitrate, aus[3 * i: 3 * i + 3],
                                   dac_rate=1, sbr_flag=1,
                                   aac_channel_mode=0)
              for i in range(n_sf)]

    def payload(cif):
        sf, part = divmod(cif, 5)
        return np.unpackbits(frames[sf % n_sf][part])

    return payload


def payload_generators(cfg: Dict, seed: int, salt: int = 0
                       ) -> Dict[int, Callable]:
    """{subch: f(cif) -> payload bits}; each service's tone from the
    seed."""
    rng = rng_for(seed, 1, salt)
    gens = {}
    for s in cfg["services"]:
        k = int(rng.integers(0, 40))
        if s["kind"] == "DAB+":
            gens[s["subch"]] = dabplus_payload(s["bitrate"], 2000 + 100 * k)
        else:
            gens[s["subch"]] = mp2_payload(s["bitrate"], 880 + 20 * k)
    return gens


def start_offset(cfg: Dict, seed: int, salt: int) -> int:
    """Where a source starts playing a loop: at the start (the null
    symbol) of a loop frame drawn from the seed."""
    p = get_mode(cfg["mode"])
    return int(rng_for(seed, 4, salt).integers(period(p).frames)) * p.T_F


def quantize_u8(iq: np.ndarray) -> np.ndarray:
    """complex64 [n] -> uint8 [n, 2] (I, Q) pairs."""
    x = np.stack([iq.real, iq.imag], axis=-1)
    return np.clip(np.round(x * U8_SCALE + 128.0), 0, 255).astype(np.uint8)


def u8_to_complex(u8: np.ndarray) -> np.ndarray:
    """uint8 [..., 2] -> complex128 [...], the classic (x - 128) / 128."""
    x = (u8.astype(np.float64) - 128.0) / 128.0
    return x[..., 0] + 1j * x[..., 1]


def fib_rotation(ensemble_id: int, ensemble_label: str,
                 services: List[ServiceSpec], n_fibs: int, frame_index: int,
                 cifs_per_frame: int) -> List[bytes]:
    """The FIBs of one frame, as a multiplexer cycles a FIG set larger
    than one frame's FIC: the FIB with FIG 0/0 (the CIF count of this
    frame's first CIF) first in every frame, the others in turn, so that
    every service label is sent within a few frames.  A set that fits in
    one frame is the copied transmitter's schedule unchanged."""
    cif_count = (frame_index * cifs_per_frame) % 5000
    figs = [figmod.fig0_0(ensemble_id, cif_count),
            *figmod.fig0_1(services), *figmod.fig0_2(services),
            figmod.fig1_0(ensemble_id, ensemble_label),
            *(figmod.fig1_1(s) for s in services)]
    fibs = figmod.pack_fibs(figs)
    if len(fibs) <= n_fibs:
        return figmod.build_fib_schedule(ensemble_id, ensemble_label,
                                         services, n_fibs, cif_count)
    rest = fibs[1:]
    return [fibs[0]] + [rest[(frame_index * (n_fibs - 1) + k) % len(rest)]
                        for k in range(n_fibs - 1)]


class RotatingModulator(Modulator):
    """The copied modulator with :func:`fib_rotation`'s FIC schedule (the
    copy sends the first 12 FIBs of its FIG set in every frame, which
    leaves out the labels of the later services of a 12-service
    ensemble)."""

    def _fic_codewords(self, frame_index: int) -> np.ndarray:
        n_cw = fic_codewords_per_frame(self.p)
        blocks, _, fibs_per_cw = fic_profile(self.p)
        fibs = fib_rotation(self.ensemble_id, self.ensemble_label,
                            self.services, fibs_per_cw * n_cw, frame_index,
                            self.p.cifs_per_frame)
        mask = puncture.puncture_mask(blocks, [16, 15])
        out = np.empty((n_cw, mask.sum()), np.uint8)
        for cw in range(n_cw):
            bits = np.concatenate(
                [figmod.fib_to_bits(fibs[cw * fibs_per_cw + k])
                 for k in range(fibs_per_cw)])
            out[cw] = puncture.puncture(conv.encode(prbs.disperse(bits)),
                                        mask)
        return out


@dataclasses.dataclass
class Loop:
    """One rendered loop: ``u8`` [period(p).frames * T_F, 2], and the
    payload the transmitter put in each subchannel at each loop CIF."""
    cfg: Dict
    seed: int
    u8: np.ndarray
    payloads: Dict[int, Callable]

    @property
    def p(self):
        return get_mode(self.cfg["mode"])

    def payload_bytes(self, subch: int, loop_cif: int) -> np.ndarray:
        """The packed payload of ``subch`` at loop CIF ``loop_cif``."""
        p = self.p
        cif = period(p).start * p.cifs_per_frame + loop_cif % PERIOD_CIFS
        return np.packbits(np.asarray(self.payloads[subch](cif), np.uint8))


def make_loop(cfg: Dict, seed: int, salt: int = 0) -> Loop:
    """Render the configuration's loop for ``seed`` (``salt`` gives a
    bank's further channels loops of their own)."""
    return make_loops(cfg, seed, salt)[0]


def make_loops(cfg: Dict, seed: int, salt: int = 0,
               draws: int = 1) -> List[Loop]:
    """``draws`` loops of one rendered signal: the same payloads under
    noise draws of their own, the first of them :func:`make_loop`'s."""
    per = period(get_mode(cfg["mode"]))
    payloads = payload_generators(cfg, seed, salt)
    mod = RotatingModulator(mode=cfg["mode"],
                            ensemble_id=cfg["ensemble"]["eid"],
                            ensemble_label=cfg["ensemble"]["label"],
                            services=service_specs(cfg), payloads=payloads)
    x = mod.frames(per.frames, start_frame=per.start)
    sig_pow = float(np.mean(np.abs(x) ** 2))
    noise_pow = sig_pow / (10 ** (cfg["snr_db"] / 10))
    loops = []
    for d in range(draws):
        rng = rng_for(seed, 2, salt, *([d] if d else []))
        noise = (rng.standard_normal(x.shape[0])
                 + 1j * rng.standard_normal(x.shape[0]))
        y = x + (np.sqrt(noise_pow / 2) * noise).astype(np.complex64)
        loops.append(Loop(cfg=cfg, seed=seed, u8=quantize_u8(y),
                          payloads=payloads))
    return loops
