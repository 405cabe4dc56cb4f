"""Reed–Solomon erasure coding over GF(2⁸), matmul-shaped.

Replaces the reference's `reed-solomon-erasure` crate (SURVEY.md §2.2).  The
design is deliberately *matrix-multiplication shaped* so the same math runs
as a numpy host path here and as a GF(2⁸) matmul kernel on a device, per
BASELINE.json ("Reed–Solomon encode/decode in `broadcast::` moves to the
same backend as GF(2^8) matmul").  The port's copy of the JAX package's
``crypto/erasure.py``; the device codec is ``ops/gf256.py``.

Scheme: systematic Lagrange RS.  A block of k data shards (byte columns) is
interpreted, per byte position, as evaluations of a degree-<k polynomial at
points 0..k-1; parity shard j is the evaluation at k+j.  Any k of the n
shards reconstruct by interpolation.  Both encode and decode are
(n−k)×k / k×k GF(2⁸) matrix products against the shard matrix.

Field: GF(2⁸) with the 0x11D reduction polynomial and primitive element 2 —
the common RS field (the `reed-solomon-erasure` crate uses the same
polynomial).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np


class GF256:
    """GF(2⁸) arithmetic via log/antilog tables, vectorized with numpy."""

    POLY = 0x11D

    def __init__(self) -> None:
        exp = np.zeros(512, dtype=np.int32)
        log = np.zeros(256, dtype=np.int32)
        # 2 is primitive for the 0x11D polynomial: x·2 = (x<<1) mod poly.
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= self.POLY
        exp[255:510] = exp[0:255]
        self.EXP = exp
        self.LOG = log
        # Plain-int copies: scalar field math (Lagrange matrix setup) on 0-d
        # numpy arrays is ~50× slower than int list indexing — and matrix
        # construction dominated N=100 profiles before caching.
        self._exp = [int(v) for v in exp]
        self._log = [int(v) for v in log]

    def mul_int(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return self._exp[self._log[a] + self._log[b]]

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Elementwise GF(2⁸) product (uint8 arrays, broadcastable)."""
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = self.EXP[self.LOG[a] + self.LOG[b]]
        return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("GF(2^8) inverse of 0")
        return int(self.EXP[255 - int(self.LOG[a])])

    def matmul(self, m: np.ndarray, x: np.ndarray) -> np.ndarray:
        """GF(2⁸) matrix product: (r×k)·(k×L) with XOR accumulation.

        Uses the native AVX2 kernel (hbbft_tpu_torch/native) when the C toolchain
        is available — the host analogue of the reference's SIMD
        `reed-solomon-erasure` crate — else the numpy table path."""
        from hbbft_tpu_torch import native

        got = native.gf256_matmul(m, x)
        if got is not None:
            return got
        return self.matmul_numpy(m, x)

    def matmul_numpy(self, m: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Pure-numpy reference path (golden check for the C kernel)."""
        m = np.asarray(m, dtype=np.uint8)
        x = np.asarray(x, dtype=np.uint8)
        out = np.zeros((m.shape[0], x.shape[1]), dtype=np.uint8)
        for i in range(m.shape[1]):
            out ^= self.mul(m[:, i : i + 1], x[i : i + 1, :])
        return out

    # -- Lagrange matrices ---------------------------------------------------

    def lagrange_row(self, xs: Sequence[int], y: int) -> np.ndarray:
        """Row vector L with L[j] = ℓ_j(y) for basis over points ``xs``.

        In GF(2⁸), subtraction is XOR.
        """
        mul = self.mul_int
        row = np.zeros(len(xs), dtype=np.uint8)
        for j, xj in enumerate(xs):
            num, den = 1, 1
            for k, xk in enumerate(xs):
                if k == j:
                    continue
                num = mul(num, xk ^ y)
                den = mul(den, xk ^ xj)
            row[j] = mul(num, self._exp[255 - self._log[den]])
        return row

    def lagrange_matrix(self, xs: Sequence[int], ys: Sequence[int]) -> np.ndarray:
        """Matrix mapping values at points ``xs`` to values at points ``ys``."""
        return self._lagrange_matrix_cached(tuple(xs), tuple(ys)).copy()

    @functools.lru_cache(maxsize=4096)
    def _lagrange_matrix_cached(self, xs: tuple, ys: tuple) -> np.ndarray:
        """The same (xs, ys) pairs recur across nodes and epochs — every
        node of a VirtualNet builds identical broadcast/reconstruct
        matrices (SURVEY.md §2.3 inter-instance parallelism)."""
        if not ys:
            return np.zeros((0, len(xs)), dtype=np.uint8)
        return np.stack([self.lagrange_row(xs, y) for y in ys], axis=0)


_GF = GF256()


def gf256() -> GF256:
    return _GF


@functools.lru_cache(maxsize=256)
def rs_codec(data_shards: int, parity_shards: int) -> "RSCodec":
    """Shared codec instances: construction builds Lagrange matrices, and a
    Subset spawns N Broadcasts per node per epoch with identical (k, m)."""
    return RSCodec(data_shards, parity_shards)


class RSCodec:
    """Systematic (k data, m parity) Reed–Solomon codec; n = k+m ≤ 256."""

    def __init__(self, data_shards: int, parity_shards: int) -> None:
        if data_shards < 1 or parity_shards < 0:
            raise ValueError("bad shard counts")
        if data_shards + parity_shards > 256:
            # GF(2⁸) has exactly 256 distinct evaluation points (0..255),
            # so 256 total shards is the hard polynomial-interpolation cap
            # (the N=256 soak config uses all of them).
            raise ValueError("n must be ≤ 256 for GF(2^8)")
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        data_pts = list(range(self.k))
        parity_pts = list(range(self.k, self.n))
        self.encode_matrix = _GF.lagrange_matrix(data_pts, parity_pts)

    def _parity(self, mat: np.ndarray) -> np.ndarray:
        """Hook: (k, L) data matrix → (m, L) parity matrix.  Device codecs
        override this with a device bit-matmul."""
        return _GF.matmul(self.encode_matrix, mat)

    def _interpolate(
        self, xs: Sequence[int], missing: Sequence[int], stack: np.ndarray
    ) -> np.ndarray:
        """Hook: values at points ``xs`` (k×L) → values at ``missing``."""
        return _GF.matmul(_GF.lagrange_matrix(list(xs), list(missing)), stack)

    def shard_length(self, data_len: int) -> int:
        """Shard byte-length for a ``data_len``-byte block (1 for empty —
        encode always emits non-empty shards).  Shared framing contract
        with the batched device plane (ops/backend.py groups encodes by
        this value so equal-length blocks collapse into one matmul)."""
        return -(-data_len // self.k) if data_len else 1

    def encode(self, data: bytes) -> List[bytes]:
        """Split ``data`` into k shards (zero-padded after a length prefix is
        the caller's concern) and append m parity shards."""
        shard_len = self.shard_length(len(data))
        padded = data.ljust(shard_len * self.k, b"\0")
        mat = np.frombuffer(padded, dtype=np.uint8).reshape(self.k, shard_len)
        parity = self._parity(mat)
        return [mat[i].tobytes() for i in range(self.k)] + [
            parity[j].tobytes() for j in range(self.m)
        ]

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> List[bytes]:
        """Fill in missing (None) shards from any k present ones."""
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots")
        present = [(i, s) for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise ValueError(f"need {self.k} shards, have {len(present)}")
        use = present[: self.k]
        xs = [i for i, _ in use]
        missing = [i for i, s in enumerate(shards) if s is None]
        out = list(shards)
        if missing:
            # stack construction only when there is interpolation to do —
            # the all-present case (every lockstep RBC at quiescence) has
            # no RS math at all
            stack = np.stack(
                [np.frombuffer(s, dtype=np.uint8) for _, s in use], axis=0
            )
            rec = self._interpolate(xs, missing, stack)
            for row, idx in enumerate(missing):
                out[idx] = rec[row].tobytes()
        return [s if s is not None else b"" for s in out]

    def decode_data(self, shards: Sequence[Optional[bytes]], data_len: int) -> bytes:
        """Reconstruct and concatenate the k data shards, trimmed to
        ``data_len``."""
        full = self.reconstruct(shards)
        return b"".join(full[: self.k])[:data_len]
