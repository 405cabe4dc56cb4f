"""Threshold-crypto key material, signatures, and encryption.

Generic over an abstract bilinear :class:`~hbbft_tpu.crypto.group.Group` —
the API mirrors the `threshold_crypto` crate the reference depends on
(SURVEY.md §2.2): `SecretKey`/`PublicKey` (per-node signing + encryption),
`SecretKeySet`/`PublicKeySet` (Shamir master keys), `SecretKeyShare`/
`PublicKeyShare`, `SignatureShare`, `Ciphertext`/`DecryptionShare`.

Conventions (matching the reference's crate):

* Public keys and decryption shares live in **G1**; signatures and message
  hashes live in **G2**.
* BLS signature:  sig = x·H2(msg);  verify  e(G1, sig) == e(PK, H2(msg)).
* Threshold encryption is Baek–Zheng style:
  U = s·G1,  V = m ⊕ KDF(s·PK),  W = s·H2(U‖V);
  ciphertext validity:     e(G1, W)  == e(U, H2(U‖V));
  decryption share i:      D_i = x_i·U;
  share validity:          e(D_i, H2(U‖V)) == e(PK_i, W);
  combine: Lagrange(D_i) = x·U = s·PK → m = V ⊕ KDF(s·PK).
* Shamir share *i* evaluates polynomials at x = i+1.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hbbft_tpu_torch.crypto.group import Group
from hbbft_tpu_torch.crypto.poly import Commitment, Poly


class CryptoError(Exception):
    pass


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------


class Signature:
    """A (combined) BLS signature — a G2 element."""

    def __init__(self, group: Group, el: Any) -> None:
        self.G = group
        self.el = el

    def to_bytes(self) -> bytes:
        return self.G.g2_to_bytes(self.el)

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "Signature":
        return Signature(group, group.g2_from_bytes(data))

    def parity(self) -> bool:
        """Unbiasable coin bit: low bit of the signature's hash digest.

        This is what the common coin extracts from the combined threshold
        signature (reference `threshold_sign` §)."""
        return bool(hashlib.sha256(self.to_bytes()).digest()[0] & 1)

    def derive_randomness(self, n_bytes: int = 32) -> bytes:
        return self.G.hash_bytes(self.to_bytes(), n_bytes)

    def __eq__(self, other) -> bool:
        return isinstance(other, Signature) and self.el == other.el

    def __hash__(self) -> int:
        return hash((id(self.G), self.to_bytes()))


class SignatureShare(Signature):
    """One node's share of a threshold signature (also a G2 element)."""


# ---------------------------------------------------------------------------
# Plain (non-threshold) per-node keys — used for vote / key-gen signing
# ---------------------------------------------------------------------------


class PublicKey:
    def __init__(self, group: Group, el: Any) -> None:
        self.G = group
        self.el = el

    def verify(self, sig: Signature, msg: bytes) -> bool:
        g = self.G
        return g.pairing_eq(g.g1(), sig.el, self.el, g.hash_to_g2(msg))

    def encrypt(self, msg: bytes, rng) -> "Ciphertext":
        return Ciphertext.encrypt(self.G, self.el, msg, rng)

    def to_bytes(self) -> bytes:
        return self.G.g1_to_bytes(self.el)

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "PublicKey":
        return PublicKey(group, group.g1_from_bytes(data))

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKey) and self.el == other.el

    def __hash__(self) -> int:
        return hash((id(self.G), self.to_bytes()))

    def __lt__(self, other: "PublicKey") -> bool:
        return self.to_bytes() < other.to_bytes()


class SecretKey:
    def __init__(self, group: Group, x: int) -> None:
        self.G = group
        self.x = x % group.r

    @staticmethod
    def random(group: Group, rng) -> "SecretKey":
        return SecretKey(group, rng.randrange(group.r))

    def public_key(self) -> PublicKey:
        return PublicKey(self.G, self.G.g1_mul(self.x, self.G.g1()))

    def sign(self, msg: bytes) -> Signature:
        return Signature(self.G, self.G.g2_mul(self.x, self.G.hash_to_g2(msg)))

    def decrypt(self, ct: "Ciphertext") -> Optional[bytes]:
        """Returns plaintext, or None if the ciphertext is invalid."""
        if not ct.verify():
            return None
        g = self.G
        shared = g.g1_mul(self.x, ct.u)
        pad = g.hash_bytes(g.g1_to_bytes(shared), len(ct.v))
        return bytes(a ^ b for a, b in zip(ct.v, pad))


# ---------------------------------------------------------------------------
# Threshold encryption ciphertext
# ---------------------------------------------------------------------------


class Ciphertext:
    def __init__(self, group: Group, u: Any, v: bytes, w: Any) -> None:
        self.G = group
        self.u = u  # G1
        self.v = v  # bytes
        self.w = w  # G2

    @staticmethod
    def encrypt(group: Group, pk_el: Any, msg: bytes, rng) -> "Ciphertext":
        g = group
        s = rng.randrange(1, g.r)
        u = g.g1_mul(s, g.g1())
        shared = g.g1_mul(s, pk_el)
        pad = g.hash_bytes(g.g1_to_bytes(shared), len(msg))
        v = bytes(a ^ b for a, b in zip(msg, pad))
        h = g.hash_to_g2(g.g1_to_bytes(u) + v)
        w = g.g2_mul(s, h)
        return Ciphertext(g, u, v, w)

    def hash_point(self) -> Any:
        """H2(U‖V) — the G2 point both validity checks pair against.

        Memoized per instance: verification of every share of this
        ciphertext pairs against the same point, and the batch paths
        (backend verify, array engine) hit it O(N²) times."""
        cached = getattr(self, "_hash_point", None)
        if cached is None:
            cached = self.G.hash_to_g2(self.G.g1_to_bytes(self.u) + self.v)
            self._hash_point = cached
        return cached

    def verify(self) -> bool:
        g = self.G
        return g.pairing_eq(g.g1(), self.w, self.u, self.hash_point())

    def to_bytes(self) -> bytes:
        g = self.G
        return (
            g.g1_to_bytes(self.u)
            + g.g2_to_bytes(self.w)
            + len(self.v).to_bytes(4, "big")
            + self.v
        )

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "Ciphertext":
        g1s, g2s = group.g1_size, group.g2_size
        u = group.g1_from_bytes(data[:g1s])
        w = group.g2_from_bytes(data[g1s : g1s + g2s])
        vlen = int.from_bytes(data[g1s + g2s : g1s + g2s + 4], "big")
        v = data[g1s + g2s + 4 : g1s + g2s + 4 + vlen]
        if len(v) != vlen:
            raise CryptoError("truncated ciphertext")
        return Ciphertext(group, u, v, w)

    def digest(self) -> bytes:
        """Memoized like :meth:`hash_point`: the batch verify paths use
        the digest as their grouping key O(N³) times per epoch."""
        cached = getattr(self, "_digest", None)
        if cached is None:
            cached = hashlib.sha256(self.to_bytes()).digest()
            self._digest = cached
        return cached

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Ciphertext)
            and self.u == other.u
            and self.v == other.v
            and self.w == other.w
        )

    def __hash__(self) -> int:
        return hash(self.digest())


class DecryptionShare:
    """One node's decryption share D_i = x_i·U — a G1 element."""

    def __init__(self, group: Group, el: Any) -> None:
        self.G = group
        self.el = el

    def to_bytes(self) -> bytes:
        return self.G.g1_to_bytes(self.el)

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "DecryptionShare":
        return DecryptionShare(group, group.g1_from_bytes(data))

    def __eq__(self, other) -> bool:
        return isinstance(other, DecryptionShare) and self.el == other.el

    def __hash__(self) -> int:
        return hash((id(self.G), self.to_bytes()))


# ---------------------------------------------------------------------------
# Threshold key set (Shamir over Z_r)
# ---------------------------------------------------------------------------


class SecretKeyShare(SecretKey):
    """Share i of the master secret: x_i = f(i+1).  Signing/decrypting with
    it produces shares rather than full signatures/plaintexts."""

    def sign_share(self, msg: bytes) -> SignatureShare:
        return SignatureShare(self.G, self.G.g2_mul(self.x, self.G.hash_to_g2(msg)))

    def decrypt_share(self, ct: "Ciphertext") -> Optional[DecryptionShare]:
        if not ct.verify():
            return None
        return DecryptionShare(self.G, self.G.g1_mul(self.x, ct.u))

    def decrypt_share_unchecked(self, ct: "Ciphertext") -> DecryptionShare:
        return DecryptionShare(self.G, self.G.g1_mul(self.x, ct.u))


class PublicKeyShare(PublicKey):
    """Share i of the master public key: PK_i = f(i+1)·G1."""

    def verify_sig_share(self, share: SignatureShare, msg: bytes) -> bool:
        g = self.G
        return g.pairing_eq(g.g1(), share.el, self.el, g.hash_to_g2(msg))

    def verify_sig_share_on_point(self, share: SignatureShare, h2: Any) -> bool:
        g = self.G
        return g.pairing_eq(g.g1(), share.el, self.el, h2)

    def verify_decryption_share(self, share: DecryptionShare, ct: Ciphertext) -> bool:
        g = self.G
        return g.pairing_eq(share.el, ct.hash_point(), self.el, ct.w)


#: id(PublicKeySet) -> {i: the point of share i}; an entry leaves with its
#: key set.  A key set is immutable: its commitment is never changed in place.
_SHARE_POINTS: Dict[int, Dict[int, Any]] = {}


class PublicKeySet:
    """Master public key: a G1 commitment to the secret polynomial."""

    def __init__(self, commitment: Commitment) -> None:
        self.commitment = commitment
        self.G = commitment.G

    def threshold(self) -> int:
        """t: any t+1 shares reconstruct; ≤ t shares reveal nothing."""
        return self.commitment.degree()

    def public_key(self) -> PublicKey:
        return PublicKey(self.G, self.commitment.evaluate(0))

    def public_key_share(self, i: int) -> PublicKeyShare:
        """Share i, its point evaluated once per key set: the protocols ask
        for the sender's share at every share they verify (26,315 times an
        N=32 epoch, each a host polynomial evaluation in G1).  The points
        are kept beside the key set, not on it, so its snapshot encoding
        does not change, and each call returns a fresh share object."""
        points = _SHARE_POINTS.get(id(self))
        if points is None:
            points = _SHARE_POINTS[id(self)] = {}
            weakref.finalize(self, _SHARE_POINTS.pop, id(self), None)
        if i not in points:
            points[i] = self.commitment.evaluate(i + 1)
        return PublicKeyShare(self.G, points[i])

    def encrypt(self, msg: bytes, rng) -> Ciphertext:
        return Ciphertext.encrypt(self.G, self.commitment.evaluate(0), msg, rng)

    def combine_signatures(self, shares: Dict[int, SignatureShare]) -> Signature:
        """Lagrange-combine ≥ t+1 verified signature shares (indices are
        share numbers i, interpolated at x = i+1)."""
        if len(shares) <= self.threshold():
            raise CryptoError(
                f"need {self.threshold() + 1} shares, got {len(shares)}"
            )
        pts = [(i + 1, s.el) for i, s in sorted(shares.items())]
        return Signature(self.G, self.G.g2_lagrange_combine(pts))

    def combine_decryption_shares(
        self, shares: Dict[int, DecryptionShare], ct: Ciphertext
    ) -> bytes:
        if len(shares) <= self.threshold():
            raise CryptoError(
                f"need {self.threshold() + 1} shares, got {len(shares)}"
            )
        g = self.G
        pts = [(i + 1, s.el) for i, s in sorted(shares.items())]
        combined = g.g1_lagrange_combine(pts)  # = s·PK
        pad = g.hash_bytes(g.g1_to_bytes(combined), len(ct.v))
        return bytes(a ^ b for a, b in zip(ct.v, pad))

    def to_bytes(self) -> bytes:
        return self.commitment.to_bytes()

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "PublicKeySet":
        return PublicKeySet(Commitment.from_bytes(group, data))

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKeySet) and self.commitment == other.commitment

    def __hash__(self) -> int:
        return hash(self.to_bytes())


class SecretKeySet:
    """Dealer-side master secret: a random degree-t polynomial over Z_r."""

    def __init__(self, poly: Poly) -> None:
        self.poly = poly
        self.G = poly.G

    @staticmethod
    def random(group: Group, threshold: int, rng) -> "SecretKeySet":
        return SecretKeySet(Poly.random(group, threshold, rng))

    def threshold(self) -> int:
        return self.poly.degree()

    def secret_key_share(self, i: int) -> SecretKeyShare:
        return SecretKeyShare(self.G, self.poly.evaluate(i + 1))

    def public_keys(self) -> PublicKeySet:
        return PublicKeySet(self.poly.commitment())
