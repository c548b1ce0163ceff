"""Golden-IQ helper for tests and the card smoke run.

:class:`dabjax.tx.modulator.Modulator` is numpy, but it reads the FIC
geometry from ``dabjax.fic.fic_decoder``, a module that imports jax.  In
a process without jax, :func:`golden_modulator` first registers a
stand-in module holding the two geometry functions (this package's own,
with the same values); where jax can be imported, dabjax's module is left
untouched.  The receive path never uses this module.
"""

from __future__ import annotations

import importlib.util
import sys
import types

__all__ = ["golden_modulator", "jax_available"]

_FIC_MODULE = "dabjax.fic.fic_decoder"


def jax_available() -> bool:
    """True when ``import jax`` would succeed; never imports it."""
    if "jax" in sys.modules:
        return sys.modules["jax"] is not None
    try:
        return importlib.util.find_spec("jax") is not None
    except (ImportError, ValueError):
        return False


def _install_fic_geometry() -> None:
    if _FIC_MODULE in sys.modules or jax_available():
        return
    from dabjax_torch.fic import fic_decoder
    standin = types.ModuleType(_FIC_MODULE)
    standin.__doc__ = "FIC geometry only (jax is not installed)."
    standin.fic_codewords_per_frame = fic_decoder.fic_codewords_per_frame
    standin.fic_profile = fic_decoder.fic_profile
    sys.modules[_FIC_MODULE] = standin


def golden_modulator(*args, **kwargs):
    """``dabjax.tx.modulator.Modulator(*args, **kwargs)``, usable with or
    without jax."""
    _install_fic_geometry()
    from dabjax.tx.modulator import Modulator
    return Modulator(*args, **kwargs)
