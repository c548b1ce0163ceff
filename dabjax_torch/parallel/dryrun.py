"""Dry run of the multi-device path (the port's counterpart of the
repository's ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n_devices)`` decodes golden Mode II IQ with the
sharded full-ensemble step on an ``n_devices`` (time, subch) mesh, every
FIB CRC passing and every subchannel's bits equal to the transmitted
payload, then runs ``Receiver(mesh=...)`` on a noisy stream and holds its
logical frames bit-identical to the single-device ``Receiver``'s.  The
mesh is the cards ``cuda:0 .. n-1`` unless ``devices`` lists one device a
position (``[torch.device("cpu")] * n`` on the CPU, ``[cuda:0] * n`` to
fill n positions with one card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dabjax_torch.constants import get_mode
from dabjax_torch.io.sources import SyntheticSource
from dabjax_torch.msc.subchannel import SubchGeometry
from dabjax_torch.ofdm.demod import min_frame_samples
from dabjax_torch.parallel.mesh import make_mesh, pick_grid
from dabjax_torch.parallel.sharding import (make_sharded_inputs,
                                            sharded_ensemble_step)
from dabjax_torch.runtime.config import ReceiverConfig
from dabjax_torch.runtime.receiver import Receiver
from dabjax_torch.tx.fig import ServiceSpec
from dabjax_torch.tx.modulator import Modulator

__all__ = ["FrameCapture", "dryrun_multichip"]


class FrameCapture:
    """Records every routed logical frame (a stand-in service handler)."""

    def __init__(self):
        self.frames = []

    def add_logical_frame(self, bits):
        self.frames.append(np.asarray(bits).copy())


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def dryrun_multichip(n_devices: int, *,
                     devices: Optional[Sequence] = None) -> str:
    """Run the sharded step and the mesh ``Receiver`` on an ``n_devices``
    mesh; raise on any mismatch.  Prints and returns the
    ``dryrun_multichip OK: ...`` line."""
    p = get_mode(2)      # T_F = 49152, 1 CIF a frame
    grid = pick_grid(n_devices)
    mesh = make_mesh(n_devices, grid, devices=devices)
    n_time, n_subch_axis = grid
    F = n_time * 16      # 16 CIFs a time shard: a well-formed halo

    n_subch = n_subch_axis * 2
    width = ServiceSpec(label="W", sid=0, subch_id=0, start_addr=0,
                        bitrate=32, protection="EEP-B", prot_level=3,
                        kind="DAB+").length_cus
    svcs = [ServiceSpec(label=f"DRY{i}", sid=0x7200 + i, subch_id=i,
                        start_addr=i * width, bitrate=32,
                        protection="EEP-B", prot_level=3, kind="DAB+")
            for i in range(n_subch)]
    mod = Modulator(mode=2, services=svcs)
    iq = mod.iq(F, snr_db=None)
    u0 = p.T_null + p.T_g
    need = min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(F)])
    geoms = [SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                           s.bitrate, s.protection, s.prot_level)
             for s in svcs]

    step = sharded_ensemble_step(mesh, p, geoms[0])
    starts = np.array([g.start_addr for g in geoms], np.int64)
    fic_ratio, bits = step(*make_sharded_inputs(mesh, rows, starts))
    fic_ratio = float(fic_ratio)
    if fic_ratio != 1.0:
        _fail(f"sharded FIC decode failed: fic_ratio={fic_ratio}")
    bits = bits.cpu().numpy()
    if bits.shape != (n_subch, F * p.cifs_per_frame, 24 * geoms[0].bitrate):
        _fail(f"bits shape {bits.shape}")
    # output index 15+t is transmitted logical frame t (15-CIF warm-up on
    # row 0; every other row is primed by the halo)
    n_lf = F * p.cifs_per_frame - 16   # last decodable logical frame index
    for i, s in enumerate(svcs):
        for t in sorted({0, min(1, n_lf), n_lf}):
            if not np.array_equal(bits[i, 15 + t],
                                  mod.payload_bits(s.subch_id, t)):
                _fail(f"subch {s.subch_id} logical frame {t}")

    # product path: Receiver(mesh=...) decodes a noisy stream end-to-end
    # bit-identically to the single-device Receiver
    def build_src():
        return SyntheticSource(Modulator(mode=2, services=svcs[:4]),
                               snr_db=30.0, lead_in=500)

    def factory_for(store):
        return lambda db, subch_id: store.setdefault(subch_id, FrameCapture())

    cfg = ReceiverConfig(mode=2, frames_per_block=2 * n_devices,
                         decode_audio=False, decode_data=True)
    single, sharded = {}, {}
    # enough blocks to clear the 15-CIF de-interleaver warm-up and route
    # real logical frames (mode II: 1 CIF per frame)
    n_blocks = -(-32 // cfg.frames_per_block)
    r1 = Receiver(build_src(), cfg, data_handler_factory=factory_for(single),
                  device=mesh.home)
    r2 = Receiver(build_src(), cfg, data_handler_factory=factory_for(sharded),
                  mesh=mesh, device=mesh.home)
    try:
        r1.run(n_blocks)
        r2.run(n_blocks)
    finally:
        r1.close()
        r2.close()
    for name, rx in (("single", r1), ("mesh", r2)):
        if rx.metrics.fic_ratio != 1.0:
            _fail(f"{name} receiver: {rx.metrics.dashboard()}")
    if not single or set(single) != set(sharded):
        _fail(f"subchannels {sorted(single)} vs {sorted(sharded)}")
    for k in single:
        a, b = single[k].frames, sharded[k].frames
        if not a or len(a) != len(b) or not np.array_equal(np.stack(a),
                                                           np.stack(b)):
            _fail(f"Receiver mesh path diverged on subch {k}")

    line = (f"dryrun_multichip OK: mesh={grid} fic_ratio={fic_ratio:.3f} "
            f"bits={bits.shape} payload=EXACT receiver_mesh=bit-identical "
            f"({len(single)} subchannels)")
    print(line)
    return line
