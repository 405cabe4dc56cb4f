"""Abstract bilinear group — the seam between protocol math and curve backends.

The reference delegates all cryptography to the `threshold_crypto` crate
(BLS12-381 via `pairing` — SURVEY.md §2.2).  Here the equivalent seam is a
small abstract *pairing group* interface; everything above it (keys, shares,
polynomials, protocols) is generic, and three backends plug in underneath:

* :class:`MockGroup` — Z_r with the bilinear map e(a, b) = a·b.  Insecure
  (discrete log is trivial) but a genuine bilinear group, so every pairing
  verification equation holds structurally.  This is the first-class
  replacement for the reference's `use-insecure-test-only-mock-crypto`
  feature (SURVEY.md §2.2) and keeps protocol tests off the pairing cost.
* ``bls381.BLS381Group`` — pure-Python BLS12-381, the golden reference.
* the JAX/TPU backend — batched limb-arithmetic kernels, golden-tested
  against the pure-Python group (hbbft_tpu/ops/).

Group elements are opaque hashable values owned by the group.  Scalars are
Python ints mod ``self.r`` (always the BLS12-381 subgroup order, see
crypto/field.py).
"""

from __future__ import annotations

import abc
import hashlib
from typing import Any, List, Sequence, Tuple

from hbbft_tpu_torch.crypto.field import R, lagrange_coeffs_at_zero


class Group(abc.ABC):
    """A pairing-friendly group triple (G1, G2, GT) with scalar field Z_r."""

    name: str = "abstract"
    r: int = R
    g1_size: int = 0  # serialized element size in bytes
    g2_size: int = 0

    # -- generators & identities -------------------------------------------

    @abc.abstractmethod
    def g1(self) -> Any: ...

    @abc.abstractmethod
    def g2(self) -> Any: ...

    @abc.abstractmethod
    def g1_identity(self) -> Any: ...

    @abc.abstractmethod
    def g2_identity(self) -> Any: ...

    # -- group ops ----------------------------------------------------------

    @abc.abstractmethod
    def g1_add(self, a: Any, b: Any) -> Any: ...

    @abc.abstractmethod
    def g1_neg(self, a: Any) -> Any: ...

    @abc.abstractmethod
    def g1_mul(self, scalar: int, a: Any) -> Any: ...

    @abc.abstractmethod
    def g2_add(self, a: Any, b: Any) -> Any: ...

    @abc.abstractmethod
    def g2_neg(self, a: Any) -> Any: ...

    @abc.abstractmethod
    def g2_mul(self, scalar: int, a: Any) -> Any: ...

    # -- hashing to the curve ----------------------------------------------

    @abc.abstractmethod
    def hash_to_g1(self, data: bytes) -> Any: ...

    @abc.abstractmethod
    def hash_to_g2(self, data: bytes) -> Any: ...

    # -- pairing -------------------------------------------------------------

    @abc.abstractmethod
    def pairing_eq(self, a1: Any, b1: Any, a2: Any, b2: Any) -> bool:
        """Check e(a1, b1) == e(a2, b2)."""

    # -- serialization -------------------------------------------------------

    @abc.abstractmethod
    def g1_to_bytes(self, a: Any) -> bytes: ...

    @abc.abstractmethod
    def g1_from_bytes(self, data: bytes) -> Any: ...

    @abc.abstractmethod
    def g2_to_bytes(self, a: Any) -> bytes: ...

    @abc.abstractmethod
    def g2_from_bytes(self, data: bytes) -> Any: ...

    # -- derived helpers (backend-independent) ------------------------------

    def g1_lagrange_combine(self, points: Sequence[Tuple[int, Any]]) -> Any:
        """Interpolate-at-zero "in the exponent" over G1.

        ``points`` are (x_coord, element) pairs; returns Σ λ_j(0) · el_j —
        the share-combination primitive (threshold_crypto
        `combine_signatures`/`decrypt` analogue).
        """
        lam = lagrange_coeffs_at_zero([x for x, _ in points], self.r)
        acc = self.g1_identity()
        for l, (_, el) in zip(lam, points):
            acc = self.g1_add(acc, self.g1_mul(l, el))
        return acc

    def g2_lagrange_combine(self, points: Sequence[Tuple[int, Any]]) -> Any:
        lam = lagrange_coeffs_at_zero([x for x, _ in points], self.r)
        acc = self.g2_identity()
        for l, (_, el) in zip(lam, points):
            acc = self.g2_add(acc, self.g2_mul(l, el))
        return acc

    def hash_bytes(self, data: bytes, out_len: int) -> bytes:
        """Counter-mode SHA-256 XOF used as the symmetric KDF for threshold
        encryption (threshold_crypto `xor_with_hash` analogue)."""
        out = b""
        ctr = 0
        while len(out) < out_len:
            out += hashlib.sha256(ctr.to_bytes(8, "big") + data).digest()
            ctr += 1
        return out[:out_len]


class MockGroup(Group):
    """Z_r as a (degenerate) bilinear group: G1 = G2 = (Z_r, +), e(a,b) = ab.

    Bilinearity: e(x·P, y·Q) = (xP)(yQ) = xy·PQ = e(P, Q)^{xy} — exactly the
    algebra every BLS verification equation relies on, so all protocol-level
    checks behave identically to the real curve.  NOT secure; test/sim only.
    """

    name = "mock"
    g1_size = 32
    g2_size = 32

    def g1(self) -> int:
        return 1

    def g2(self) -> int:
        return 1

    def g1_identity(self) -> int:
        return 0

    def g2_identity(self) -> int:
        return 0

    def g1_add(self, a: int, b: int) -> int:
        return (a + b) % self.r

    def g1_neg(self, a: int) -> int:
        return (-a) % self.r

    def g1_mul(self, scalar: int, a: int) -> int:
        return (scalar * a) % self.r

    g2_add = g1_add
    g2_neg = g1_neg
    g2_mul = g1_mul

    def _hash_to_scalar(self, tag: bytes, data: bytes) -> int:
        h = hashlib.sha256(tag + data).digest() + hashlib.sha256(b"x" + tag + data).digest()
        return int.from_bytes(h, "big") % self.r

    def hash_to_g1(self, data: bytes) -> int:
        return self._hash_to_scalar(b"mock-g1", data)

    def hash_to_g2(self, data: bytes) -> int:
        return self._hash_to_scalar(b"mock-g2", data)

    def pairing_eq(self, a1: int, b1: int, a2: int, b2: int) -> bool:
        return (a1 * b1) % self.r == (a2 * b2) % self.r

    def g1_to_bytes(self, a: int) -> bytes:
        return int(a % self.r).to_bytes(32, "big")

    def g1_from_bytes(self, data: bytes) -> int:
        v = int.from_bytes(data, "big")
        if v >= self.r:
            raise ValueError("not a canonical mock group element")
        return v

    g2_to_bytes = g1_to_bytes
    g2_from_bytes = g1_from_bytes
