"""The port's entry points against dabjax's on the same recorded .raw
ensemble: ``python -m dabjax_torch info|scan`` output, band_scan over a
tuner model, and device_trace writing a trace file."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dabjax import cli as cli_jax
from dabjax.io.sources import NullSource, RawFileSource, TunedSourceBank
from dabjax.runtime.config import ReceiverConfig
from dabjax.runtime.scan import band_scan as band_scan_jax
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator
from dabjax_torch import cli
from dabjax_torch.runtime.profiling import device_trace
from dabjax_torch.runtime.scan import ScanResult, band_scan
from test_receiver_e2e import BITRATE_MP2, _mp2_payloads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory):
    services = [ServiceSpec(label="PORTCLI", sid=0x3101, subch_id=3,
                            start_addr=0, bitrate=BITRATE_MP2,
                            protection="EEP-A", prot_level=3, kind="DAB"),
                ServiceSpec(label="PORTPLUS", sid=0x3102, subch_id=4,
                            start_addr=200, bitrate=48, protection="EEP-A",
                            prot_level=2, kind="DAB+")]
    mod = Modulator(mode=1, services=services, amplitude=0.3,
                    ensemble_label="PORT ENSEMBLE",
                    payloads={3: _mp2_payloads(40)})
    iq = mod.iq(8, snr_db=40.0, seed=3)
    u8 = np.empty(2 * iq.shape[0], np.uint8)
    u8[0::2] = np.clip(np.real(iq) * 128 + 128, 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.imag(iq) * 128 + 128, 0, 255).astype(np.uint8)
    path = tmp_path_factory.mktemp("iq") / "ensemble.raw"
    path.write_bytes(u8.tobytes())
    return str(path)


def _normalise(text):
    """The float taps (SNR, CFO) agree to about 1e-3 between the two
    demods, which a printed last digit can still show; mask them."""
    text = re.sub(r"snr=\s*-?[\d.]+dB cfo=[+-]\d+[+-][\d.]+Hz",
                  "snr=*dB cfo=*Hz", text)
    return re.sub(r"SNR -?[\d.]+ dB", "SNR * dB", text)


def _both(argv, capsys):
    rc_j = cli_jax.main(argv)
    out_j = capsys.readouterr().out
    rc_t = cli.main(argv)
    out_t = capsys.readouterr().out
    return (rc_j, _normalise(out_j)), (rc_t, _normalise(out_t))


def test_info_matches_dabjax(raw_file, capsys):
    jax_side, port_side = _both(["info", raw_file, "--blocks", "2"], capsys)
    assert port_side == jax_side
    rc, out = port_side
    assert rc == 0
    assert "PORT ENSEMBLE" in out and "PORTCLI" in out and "PORTPLUS" in out
    assert "fic=100.0%" in out


def test_scan_matches_dabjax(raw_file, capsys):
    argv = ["scan", f"12C={raw_file}", "5A=null", "--blocks", "2"]
    jax_side, port_side = _both(argv, capsys)
    assert port_side == jax_side
    rc, out = port_side
    assert rc == 0
    assert "12C: 'PORT ENSEMBLE' (2 services" in out
    assert "5A: no signal" in out


def test_band_scan_matches_dabjax(raw_file):
    def bank():
        return TunedSourceBank({"12C": RawFileSource(raw_file, loop=False),
                                "7D": NullSource()})

    cfg = ReceiverConfig(mode=1, scan_attempts=2)
    chans = ["5A", "12C", "7D"]
    got = band_scan(bank(), chans, config=cfg, blocks=2, device="cpu")
    want = band_scan_jax(bank(), chans, config=cfg, blocks=2)
    assert [type(r) for r in got] == [ScanResult] * 3
    assert [r.synced for r in got] == [False, True, False]
    for g, w in zip(got, want):
        assert abs(g.snr_db - w.snr_db) < 1e-3
        g.snr_db = w.snr_db
        assert g.__dict__ == w.__dict__


def test_module_entry_point_parses_like_dabjax(tmp_path):
    """``python -m dabjax_torch`` reaches the port's argparse surface."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "dabjax_torch", "--help"],
                         cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage: dabjax_torch")
    for cmd in ("info", "decode", "scan"):
        assert cmd in res.stdout


def test_device_trace_writes_a_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.float32)
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.fft.fft(x).abs().sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)


def test_decode_writes_the_same_wav_as_dabjax(raw_file, tmp_path,
                                              monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    wavs = []
    for main, name in ((cli_jax.main, "jax.wav"), (cli.main, "port.wav")):
        rc = main(["decode", raw_file, "--service", "PORTCLI",
                   "--out", name, "--blocks", "2"])
        assert rc == 0
        with open(tmp_path / name, "rb") as f:
            wavs.append(f.read())
    out = capsys.readouterr().out
    assert "wrote" in out and "-> port.wav" in out
    assert len(wavs[1]) > 1000 and wavs[1] == wavs[0]
