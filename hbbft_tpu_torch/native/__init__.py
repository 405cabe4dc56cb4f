"""Native (C) host kernels, built on first use.

The port's copy of the JAX package's ``native/`` loaders for three
kernels: ``gf256_kernel.c`` (GF(2⁸) Reed–Solomon matmul) and
``sha256_kernel.c`` (batched SHA-256, Merkle proof validation and root
building), which the array engine's RS/Merkle plane calls, and
``hashg2_kernel.c`` (hash-to-G2, behind ``crypto/bls381.hash_to_g2``),
which the coin's signing and share checks call.  Each source is compiled
by the host C compiler (``cc -O3 -march=native``) into
``hbbft_tpu_torch/_build/`` (listed in ``.gitignore``), named by the host
ISA and a hash of the source, and bound with ctypes.  Nothing is built at
import.  Where no compiler is available the callers fall back to their
numpy/hashlib/pure-Python paths; ``available()``, ``sha256_available()``
and ``hashg2_available()`` say which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _host_tag() -> str:
    """ISA fingerprint: a -march=native object built on one machine must
    not be loaded on another."""
    feat = ""
    try:
        with open("/proc/cpuinfo") as f:
            feat = next((ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:
        pass
    return hashlib.sha256((platform.machine() + feat).encode()).hexdigest()[:12]


def _so_path(name: str) -> Path:
    src = (_DIR / f"{name}.c").read_bytes()
    tag = hashlib.sha256(src + _host_tag().encode()).hexdigest()[:12]
    return BUILD_DIR / f"_{name}.{platform.machine()}-{tag}.so"


def _build(name: str) -> Optional[Path]:
    """Compile ``<name>.c`` if its library is missing; the path, or None
    when no compiler run succeeded."""
    so = _so_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    for flags in (["-march=native"], []):  # fall back if -march trips
        cmd = ["cc", "-O3", "-shared", "-fPIC", *flags, "-o", str(tmp), str(_DIR / f"{name}.c")]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return so
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
            continue
        finally:
            if tmp.exists():
                tmp.unlink()
    return None


def _load(name: str, bind) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        lib = None
        so = _build(name)
        if so is not None:
            try:
                lib = bind(ctypes.CDLL(str(so)))
            except OSError:
                lib = None
        _LIBS[name] = lib
        return lib


_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_L = ctypes.c_long


def _bind_gf256(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gf256_init()
    lib.gf256_matmul.argtypes = [_U8P, _U8P, _U8P, _L, _L, _L]
    lib.gf256_matmul.restype = None
    return lib


def _bind_sha256(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    lib.sha256_batch.argtypes = [_U8P, _L, _L, _U8P]
    lib.sha256_batch.restype = None
    lib.merkle_validate_batch.argtypes = [_U8P, _L, _U8P, _I32P, _U8P, _L, _L, _L, _U8P]
    lib.merkle_validate_batch.restype = None
    lib.merkle_root_batch.argtypes = [_U8P, _L, _L, _L, _L, _L, _U8P]
    lib.merkle_root_batch.restype = None
    # Self-test against hashlib — guards the SHA-NI block schedules (and
    # falls back to the scalar path, then to hashlib, on any mismatch).
    # Two items with distinct contents and a >64-byte length cover the
    # dual-stream path, the single path and both padding branches.
    probe = np.frombuffer(b"abc" + bytes(62) + b"defg" + bytes(61), dtype=np.uint8).reshape(2, 65)
    want = b"".join(hashlib.sha256(probe[i].tobytes()).digest() for i in range(2))
    out = np.empty((2, 32), dtype=np.uint8)
    lib.sha256_batch(np.ascontiguousarray(probe), 2, 65, out)
    if out.tobytes() != want:
        lib.sha256_disable_ni()
        lib.sha256_batch(np.ascontiguousarray(probe), 2, 65, out)
        if out.tobytes() != want:
            return None
    return lib


def available() -> bool:
    """Whether the GF(2⁸) kernel is built and loaded."""
    return _load("gf256_kernel", _bind_gf256) is not None


def gf256_matmul(m: np.ndarray, x: np.ndarray) -> Optional[np.ndarray]:
    """(r×k)·(k×L) GF(2⁸) product via the C kernel, or None if unavailable."""
    lib = _load("gf256_kernel", _bind_gf256)
    if lib is None:
        return None
    m = np.ascontiguousarray(m, dtype=np.uint8)
    x = np.ascontiguousarray(x, dtype=np.uint8)
    r, k = m.shape
    k2, L = x.shape
    if k != k2:
        raise ValueError("shape mismatch")
    out = np.empty((r, L), dtype=np.uint8)
    lib.gf256_matmul(m, x, out, r, k, L)
    return out


def sha256_available() -> bool:
    """Whether the SHA-256/Merkle kernel is built, loaded and self-tested."""
    return _load("sha256_kernel", _bind_sha256) is not None


def sha256_batch(data: np.ndarray) -> Optional[np.ndarray]:
    """Hash each row of a (n, item_len) uint8 array; None if no C kernel."""
    lib = _load("sha256_kernel", _bind_sha256)
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n, item_len = data.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib.sha256_batch(data, n, item_len, out)
    return out


def merkle_validate_batch(leaf_vals: np.ndarray, paths: np.ndarray, indices: np.ndarray,
                          roots: np.ndarray, reps: int) -> Optional[np.ndarray]:
    """Validate n proofs (each reps times).  Shapes: leaf_vals (n, L),
    paths (n, depth, 32), indices (n,), roots (n, 32).  Returns (n,) bool
    or None if the C kernel is unavailable or L is out of contract."""
    lib = _load("sha256_kernel", _bind_sha256)
    if lib is None:
        return None
    leaf_vals = np.ascontiguousarray(leaf_vals, dtype=np.uint8)
    n, leaf_len = leaf_vals.shape
    if leaf_len + 1 > 4096:
        return None  # h_leaf buffer contract in sha256_kernel.c
    paths = np.ascontiguousarray(paths, dtype=np.uint8)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    roots = np.ascontiguousarray(roots, dtype=np.uint8)
    depth = paths.shape[1] if paths.ndim == 3 else 0
    ok = np.empty(n, dtype=np.uint8)
    lib.merkle_validate_batch(leaf_vals, leaf_len, paths, indices, roots, n, depth,
                              int(reps), ok)
    return ok.astype(bool)


def merkle_root_batch(leaves: np.ndarray, size: int, reps: int) -> Optional[np.ndarray]:
    """Roots of t trees: leaves (t, n_leaves, leaf_len), padded to `size`
    (pow2 ≤ 256) with empty leaves; each built reps times.  (t, 32) out."""
    lib = _load("sha256_kernel", _bind_sha256)
    if lib is None:
        return None
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    t, n_leaves, leaf_len = leaves.shape
    if size > 256 or leaf_len + 1 > 4096:
        return None
    out = np.empty((t, 32), dtype=np.uint8)
    lib.merkle_root_batch(leaves, t, n_leaves, leaf_len, size, int(reps), out)
    return out


# ---------------------------------------------------------------------------
# hash-to-G2 (hashg2_kernel.c)
# ---------------------------------------------------------------------------

#: golden probes: the native hash must give the pure path's points on these
HASHG2_PROBES = (b"", b"g2-golden-0", b"g2-golden-1", bytes(range(97)))


def _hashg2_call(lib: ctypes.CDLL, data: bytes):
    out = np.empty(24, dtype=np.uint64)
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, np.uint8)
    if lib.hashg2_one(np.ascontiguousarray(buf), len(data), out) != 0:
        return None
    v = [sum(int(x) << (64 * i) for i, x in enumerate(out[o : o + 6])) for o in range(0, 24, 6)]
    return ((v[0], v[1]), (v[2], v[3]))


def _bind_hashg2(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    lib.hashg2_one.argtypes = [_U8P, _L, np.ctypeslib.ndpointer(dtype=np.uint64,
                                                                flags="C_CONTIGUOUS")]
    lib.hashg2_one.restype = ctypes.c_int
    # Golden check against the pure path: the two must be interchangeable
    # point for point, or the native kernel is not used.
    from hbbft_tpu_torch.crypto.bls381 import _hash_to_g2_pure

    for probe in HASHG2_PROBES:
        if _hashg2_call(lib, probe) != _hash_to_g2_pure(probe):
            return None
    return lib


def hashg2_available() -> bool:
    """Whether the hash-to-G2 kernel is built, loaded and golden-checked."""
    return _load("hashg2_kernel", _bind_hashg2) is not None


def hashg2(data: bytes):
    """Hash-to-G2 via the C kernel: ((x0, x1), (y0, y1)) ints, or None if
    the kernel is unavailable or switched off (``HBBFT_TPU_NO_NATIVE_HASHG2=1``,
    read per call, forces the pure path)."""
    if os.environ.get("HBBFT_TPU_NO_NATIVE_HASHG2"):
        return None
    lib = _load("hashg2_kernel", _bind_hashg2)
    if lib is None:
        return None
    return _hashg2_call(lib, data)
