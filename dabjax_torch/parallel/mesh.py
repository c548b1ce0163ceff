"""A (time, subch) mesh of torch devices in one process (torch port of
:mod:`dabjax.parallel.mesh`).

The axes are dabjax's:

* ``time``  — contiguous frame blocks, one a mesh row, with the 15-CIF
  de-interleaver history handed from each row to the next as a halo
* ``subch`` — the ensemble's subchannels, split over a row's positions

dabjax's mesh is single-controller: one process drives every local
device, and only whole channels cross processes
(:mod:`dabjax_torch.parallel.multihost`).  The port keeps that: a
:class:`Mesh` is a grid of explicit ``torch.device``\\ s, a collective is a
copy to another device or a sum on the home device, and each position's
work is issued on its own device's current stream, so distinct cards
overlap because launches are asynchronous.  A card fills several
positions only when the caller lists it once a position.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dabjax_torch.devices import resolve

__all__ = ["Mesh", "make_mesh", "pick_grid"]


def pick_grid(n_devices: int, max_subch: int = 4) -> Tuple[int, int]:
    """Factor n_devices into (time, subch) with subch <= max_subch."""
    subch = 1
    for s in range(min(max_subch, n_devices), 0, -1):
        if n_devices % s == 0:
            subch = s
            break
    return n_devices // subch, subch


class Mesh:
    """``devices``: an object array of ``torch.device``, shape (time,
    subch).  Like jax's ``Mesh`` it has ``axis_names``, ``shape`` (a dict
    by axis name) and ``size``; ``home`` is position (0, 0), where inputs
    start and results are gathered."""

    axis_names = ("time", "subch")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"mesh devices of shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self) -> torch.device:
        return self.devices[0, 0]

    def positions(self) -> List[torch.device]:
        """The devices in mesh order (row-major: time, then subch)."""
        return list(self.devices.flat)


def make_mesh(n_devices: Optional[int] = None,
              grid: Optional[Tuple[int, int]] = None, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (time, subch) mesh of ``n_devices`` positions, ``grid`` by
    default :func:`pick_grid`'s.

    Without ``devices`` the positions are the cards ``cuda:0 .. n-1``
    (``n_devices`` defaults to the card count); it raises if fewer cards
    are present, and never repeats a card or takes the CPU.  With
    ``devices`` the list is taken as given, repeats included: one device
    a position, in mesh order."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_devices is None:
            n_devices = n_cards
        if n_devices < 1 or n_cards < n_devices:
            raise RuntimeError(
                f"a mesh of {n_devices} cards needs {n_devices} CUDA "
                f"devices, {n_cards} present; pass devices=[...] to place "
                "several positions on one device")
        devs = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devs = [resolve(d) for d in devices]
        if n_devices is None:
            n_devices = len(devs)
        if len(devs) < n_devices:
            raise ValueError(f"{n_devices} positions, {len(devs)} devices")
        devs = devs[:n_devices]
    if grid is None:
        grid = pick_grid(n_devices)
    t, s = grid
    if t * s != n_devices:
        raise ValueError(f"grid {grid} does not hold {n_devices} positions")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(t, s))

