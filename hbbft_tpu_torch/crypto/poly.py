"""Secret-sharing polynomials and commitments (threshold_crypto analogue).

`Poly`, `Commitment`, `BivarPoly`, `BivarCommitment` — the Shamir/Pedersen
machinery behind key generation and the in-band DKG (reference: the
`threshold_crypto` crate's `poly` module, external dep — SURVEY.md §2.2).

Scalars live in Z_r (Python ints); commitments live in G1 of an abstract
:class:`~hbbft_tpu.crypto.group.Group`.  Shamir convention follows the
reference: share *i* is the evaluation at x = i+1 (x = 0 holds the secret).
"""

from __future__ import annotations

from typing import Any, List, Sequence

from hbbft_tpu_torch.crypto.group import Group


def _rand_scalar(rng, r: int) -> int:
    return rng.randrange(r)


class Poly:
    """Univariate polynomial over Z_r, coefficients low-to-high degree."""

    def __init__(self, group: Group, coeffs: Sequence[int]) -> None:
        self.G = group
        self.coeffs: List[int] = [c % group.r for c in coeffs] or [0]

    @staticmethod
    def random(group: Group, degree: int, rng) -> "Poly":
        return Poly(group, [_rand_scalar(rng, group.r) for _ in range(degree + 1)])

    @staticmethod
    def constant(group: Group, c: int) -> "Poly":
        return Poly(group, [c])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % self.G.r
        return acc

    def add(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return Poly(self.G, [(x + y) % self.G.r for x, y in zip(a, b)])

    def commitment(self) -> "Commitment":
        g = self.G
        return Commitment(g, [g.g1_mul(c, g.g1()) for c in self.coeffs])

    def __eq__(self, other) -> bool:
        return isinstance(other, Poly) and self.coeffs == other.coeffs


class Commitment:
    """G1 Feldman commitment to a :class:`Poly`'s coefficients."""

    def __init__(self, group: Group, coeffs: Sequence[Any]) -> None:
        self.G = group
        self.coeffs: List[Any] = list(coeffs)

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int) -> Any:
        g = self.G
        acc = g.g1_identity()
        for c in reversed(self.coeffs):
            acc = g.g1_add(g.g1_mul(x, acc), c)
        return acc

    def add(self, other: "Commitment") -> "Commitment":
        g = self.G
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [g.g1_identity()] * (n - len(self.coeffs))
        b = other.coeffs + [g.g1_identity()] * (n - len(other.coeffs))
        return Commitment(g, [g.g1_add(x, y) for x, y in zip(a, b)])

    def to_bytes(self) -> bytes:
        g = self.G
        out = [len(self.coeffs).to_bytes(2, "big")]
        out += [g.g1_to_bytes(c) for c in self.coeffs]
        return b"".join(out)

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "Commitment":
        n = int.from_bytes(data[:2], "big")
        sz = group.g1_size
        coeffs = [group.g1_from_bytes(data[2 + i * sz : 2 + (i + 1) * sz]) for i in range(n)]
        return Commitment(group, coeffs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Commitment) and self.coeffs == other.coeffs

    def __hash__(self) -> int:
        return hash(self.to_bytes())


class BivarPoly:
    """Symmetric bivariate polynomial over Z_r, degree ``t`` in each variable.

    ``coeffs[i][j]`` multiplies x^i·y^j with coeffs[i][j] == coeffs[j][i],
    so f(x, y) == f(y, x) — the symmetry the DKG's Ack cross-checks rely on.
    """

    def __init__(self, group: Group, coeffs: Sequence[Sequence[int]]) -> None:
        self.G = group
        self.coeffs = [[c % group.r for c in row] for row in coeffs]

    @staticmethod
    def random(group: Group, degree: int, rng) -> "BivarPoly":
        n = degree + 1
        coeffs = [[0] * n for _ in range(n)]
        for i in range(n):
            for j in range(i, n):
                v = _rand_scalar(rng, group.r)
                coeffs[i][j] = v
                coeffs[j][i] = v
        return BivarPoly(group, coeffs)

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int, y: int) -> int:
        r = self.G.r
        acc = 0
        for row in reversed(self.coeffs):
            inner = 0
            for c in reversed(row):
                inner = (inner * y + c) % r
            acc = (acc * x + inner) % r
        return acc

    def row(self, x: int) -> Poly:
        """f(x, ·) as a univariate polynomial in y."""
        r = self.G.r
        out = []
        for j in range(len(self.coeffs)):
            acc = 0
            for i in reversed(range(len(self.coeffs))):
                acc = (acc * x + self.coeffs[i][j]) % r
            out.append(acc)
        return Poly(self.G, out)

    def commitment(self) -> "BivarCommitment":
        g = self.G
        return BivarCommitment(
            g, [[g.g1_mul(c, g.g1()) for c in row] for row in self.coeffs]
        )


class BivarCommitment:
    """G1 commitment to a :class:`BivarPoly`."""

    def __init__(self, group: Group, coeffs: Sequence[Sequence[Any]]) -> None:
        self.G = group
        self.coeffs = [list(row) for row in coeffs]

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int, y: int) -> Any:
        g = self.G
        acc = g.g1_identity()
        for row in reversed(self.coeffs):
            inner = g.g1_identity()
            for c in reversed(row):
                inner = g.g1_add(g.g1_mul(y, inner), c)
            acc = g.g1_add(g.g1_mul(x, acc), inner)
        return acc

    def col(self, y: int) -> Commitment:
        """Commitment to f(·, y) — the ACKER-variable polynomial with the
        receiver coordinate fixed.  Pre-computing this once per (part,
        receiver) turns every ack cross-check from a full (t+1)² bivariate
        evaluation into a (t+1)-term univariate one (the N=100 era change
        was >600 s before; SURVEY.md §3.4)."""
        g = self.G
        out = []
        for i in range(len(self.coeffs)):
            acc = g.g1_identity()
            for j in reversed(range(len(self.coeffs))):
                acc = g.g1_add(g.g1_mul(y, acc), self.coeffs[i][j])
            out.append(acc)
        return Commitment(g, out)

    def row(self, x: int) -> Commitment:
        """Commitment to f(x, ·)."""
        g = self.G
        out = []
        for j in range(len(self.coeffs)):
            acc = g.g1_identity()
            for i in reversed(range(len(self.coeffs))):
                acc = g.g1_add(g.g1_mul(x, acc), self.coeffs[i][j])
            out.append(acc)
        return Commitment(g, out)

    def to_bytes(self) -> bytes:
        g = self.G
        n = len(self.coeffs)
        out = [n.to_bytes(2, "big")]
        for row in self.coeffs:
            out += [g.g1_to_bytes(c) for c in row]
        return b"".join(out)

    @staticmethod
    def from_bytes(group: Group, data: bytes) -> "BivarCommitment":
        n = int.from_bytes(data[:2], "big")
        sz = group.g1_size
        coeffs = []
        off = 2
        for _ in range(n):
            row = []
            for _ in range(n):
                row.append(group.g1_from_bytes(data[off : off + sz]))
                off += sz
            coeffs.append(row)
        return BivarCommitment(group, coeffs)

    def __eq__(self, other) -> bool:
        return isinstance(other, BivarCommitment) and self.coeffs == other.coeffs
