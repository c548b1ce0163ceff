"""Builds the package's CUDA sources into one shared library.

The sources in ``dabjax_torch/csrc`` (``*.cu``, with the ``*.cuh``
headers they include) are compiled with ``nvcc`` for
``sm_90a`` into ``dabjax_torch/build/`` at first use (one ``nvcc`` per
source, all started together, then one link), cached by a hash of the
sources and flags, and loaded with ``ctypes`` (plain C interface, no
PyTorch headers).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["load_library", "sass", "build_seconds"]

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

#: wall seconds the last build took (0.0 when the cached library was used)
build_seconds = 0.0


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
    """Compile (if needed) and load the kernels; declares every entry
    point's argument and return types."""
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
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dabjax_viterbi_forward.argtypes = [vp, vp, vp, i, i, vp]
    lib.dabjax_viterbi_forward.restype = i
    lib.dabjax_viterbi_traceback.argtypes = [vp, vp, i, i, i, vp]
    lib.dabjax_viterbi_traceback.restype = i
    lib.dabjax_viterbi_forward_words.argtypes = [vp, vp, vp, vp, i, i, i, vp]
    lib.dabjax_viterbi_forward_words.restype = i
    lib.dabjax_viterbi_traceback_words.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.dabjax_viterbi_traceback_words.restype = i
    lib.dabjax_probe_forward_words_stage.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.dabjax_probe_forward_words_stage.restype = i
    lib.dabjax_probe_scale_copy.argtypes = [vp, vp, ctypes.c_longlong, vp]
    lib.dabjax_probe_scale_copy.restype = i
    lib.dabjax_probe_decision_plane.argtypes = [vp, vp, i, i, i, i, vp]
    lib.dabjax_probe_decision_plane.restype = i
    lib.dabjax_probe_forward_plane.argtypes = [vp, vp, vp, i, i, i, i, i, i,
                                               i, vp]
    lib.dabjax_probe_forward_plane.restype = i
    ll, u = ctypes.c_longlong, ctypes.c_uint
    lib.dabjax_probe_chain.argtypes = [vp, vp, ll, i, i, i, u, u, vp]
    lib.dabjax_probe_chain.restype = i
    lib.dabjax_probe_pair_chain.argtypes = [vp, vp, vp, ll, i, i, u, vp]
    lib.dabjax_probe_pair_chain.restype = i
    return lib
