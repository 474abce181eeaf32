"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded through
``ctypes``.  The build happens on first use, from the sources in the
checkout and nothing else, into ``build/`` beside this file (listed in
``.gitignore``).  A library's file name carries a hash of its sources and
flags, so an edited kernel is never served from a stale build.

``build()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``library(name)`` returns the loaded library, building it first if
needed.  Nothing here runs at import time: this module is imported on
hosts with no CUDA toolkit.

A kernel that cannot be built, loaded, queried or launched raises
``KernelError``.  The serving engine never contains it: a kernel that
failed once fails the same way on every retry and after every rebuild.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "KernelError", "sources", "build",
           "library", "build_logs"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills on stderr; the log is kept in build_logs() for chip_smoke.py
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")



class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded, queried or
    launched (the CUDA error string rides in the message)."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on "
                      "PATH): the port's kernels are built from source")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))) + [
            os.path.join(_CSRC, name + ".cu")]:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the
    seconds each build took (0.0 when it was already built)."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    t0 = time.perf_counter()
    for n in names:
        out = _target(n)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        _logs[n] = log
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return secs


def build_logs() -> Dict[str, str]:
    """nvcc/ptxas output of the builds this process ran."""
    return dict(_logs)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(_target(name))
            except OSError as e:
                raise KernelError(f"kernel library {name}: {e}") from e
            _libs[name] = lib
        return lib
