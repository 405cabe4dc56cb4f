"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), named
by a hash of its source, the shared headers and the flags, so an edited
source is rebuilt.  The
output goes to ``hbbft_tpu_torch/_build/`` (listed in ``.gitignore``).
Nothing here runs at import: the CPU tests import every module freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

#: Hopper only: keep the ``a`` (wgmma/setmaxnreg live only on sm_90a).
#: No --use_fast_math: the field arithmetic needs IEEE float32.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every shared
    header of csrc/ and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, temporary output,
    final output, log file), or None if the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = open(BUILD_DIR / f"{name}.log", "w")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named source, one nvcc each, all started together.
    Returns the seconds per source (0.0 for one already built)."""
    secs: Dict[str, float] = {}
    with _LOCK:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names}
        for name, job in jobs.items():
            if job is None:
                secs[name] = 0.0
                continue
            proc, tmp, out, log = job
            rc = proc.wait()
            log.close()
            if rc != 0:
                text = (BUILD_DIR / f"{name}.log").read_text()
                raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{text}")
            os.replace(tmp, out)
            secs[name] = time.perf_counter() - t0
    return secs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name`` in this checkout."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib
