"""Builds the package's CUDA sources into one shared library, and is the
one way to launch and count a kernel in it.

The sources in ``dabjax_torch/csrc`` (``*.cu``, with the ``*.cuh``
headers they include) are compiled with ``nvcc`` for
``sm_90a`` into ``dabjax_torch/build/`` at first use (one ``nvcc`` per
source, all started together, then one link), cached by a hash of the
sources and flags, and loaded with ``ctypes`` (plain C interface, no
PyTorch headers).  Nothing here runs at import time.

Every C entry returns a CUDA error code and takes the stream last.  A
wrapper module declares the entries it calls in one table, ``ENTRIES``
(entry name -> the ctypes types of its arguments before the stream),
and launches them only through :func:`launch`, which declares an entry
on its first call, counts the launch in :data:`LAUNCHES` and raises on
an error code.  This module knows no kernel by name.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Mapping, Sequence

import torch

__all__ = ["LAUNCHES", "launch", "load_library", "sass", "build_seconds"]

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

#: wall seconds the last build took (0.0 when the cached library was used)
build_seconds = 0.0

#: launches of each kernel since the last ``LAUNCHES.clear()``, by the
#: name its wrapper counts it under ("k1" .. "k4", "guard_corr",
#: "mix_windows", "dqpsk_soft", "coarse_cfo", "msc_front", the probes');
#: a CUDA graph's replay adds what its capture counted
#: (``graphs.BlockGraph``)
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "-shared")).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def sass() -> str:
    """The SASS of the loaded library, by the toolkit's ``cuobjdump``
    (beside ``nvcc``)."""
    lib = load_library()
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", lib._name], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({res.returncode}):\n"
                           f"{res.stderr}")
    return res.stdout


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels."""
    global build_seconds
    sources = _sources()
    out = BUILD / f"libdabjax_torch_{_digest(sources)}.so"
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(dir=BUILD)
        try:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
            jobs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, obj in zip(sources, objs)]
            errors = []
            for src, job in zip(sources, jobs):
                _, err = job.communicate()
                if job.returncode:
                    errors.append(f"{src.name}: nvcc failed "
                                  f"({job.returncode}):\n{err}")
            if errors:
                raise RuntimeError("\n".join(errors))
            so = os.path.join(tmp, out.name)
            res = subprocess.run([nvcc, *ARCH, "-shared", "-o", so, *objs],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n{res.stderr}")
            os.replace(so, out)      # atomic: concurrent builds agree
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        build_seconds = time.perf_counter() - t0
    return ctypes.CDLL(str(out))


def _entry(name: str, argtypes: Sequence):
    """The library's C entry ``name``, declared on its first use:
    ``argtypes``, then the stream, returning a CUDA error code."""
    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(key: str, entries: Mapping[str, Sequence], name: str,
           device: torch.device, *args) -> None:
    """Call the C entry ``name`` on ``args`` and the current stream of
    ``device``, with ``device`` entered; ``entries`` is the calling
    module's ``ENTRIES``.  Counts one launch under ``key`` in
    :data:`LAUNCHES`, whatever the return code, and raises
    ``RuntimeError`` on a non-zero one."""
    fn = _entry(name, entries[name])
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[key] += 1
    if rc:
        raise RuntimeError(f"{key} launch ({name}) failed: CUDA error {rc}")
