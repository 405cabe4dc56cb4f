"""Pure-Python BLS12-381 — the golden-reference pairing group.

Replaces the reference's `threshold_crypto`/`pairing` Rust crates (SURVEY.md
§2.2) with a from-scratch implementation of the BLS12-381 curve: the Fq →
Fq2 → Fq6 → Fq12 tower, G1/G2 affine arithmetic, a generic Miller loop over
E(Fq12) via the untwist map, and the final exponentiation done directly with
a big-integer exponent (clarity over speed — this backend exists to be
*obviously correct*, golden-testing both the protocol layer and the JAX/TPU
limb kernels in hbbft_tpu/ops/).

Conventions:
* Tower: Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³−ξ) with ξ = 1+u,
  Fq12 = Fq6[w]/(w²−v); so w⁶ = ξ, and the D-twist untwist map
  ψ(x′,y′) = (x′/w², y′/w³) carries E′: y²=x³+4ξ (G2) onto E: y²=x³+4.
* Hash-to-curve: deterministic try-and-increment + cofactor clearing.
  Internal consistency is what the framework needs (all backends share this
  construction); it is NOT the IETF hash-to-curve suite.
* Serialization: ZCash-style compressed points (48B G1 / 96B G2) with the
  standard 3-bit flag prefix.

Sanity is enforced by tests: subgroup orders, bilinearity
e(aP,bQ) = e(P,Q)^{ab}, non-degeneracy, and signature/encryption round
trips shared with the mock group's suite.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Any, List, Optional, Tuple

from hbbft_tpu_torch.crypto.field import Q, R
from hbbft_tpu_torch.crypto.group import Group

# BLS parameter x (negative): the curve is parameterized by x = -0xd201000000010000.
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

G1_B = 4
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# G2 effective cofactor (h2): clearing it maps any twist point into the
# r-order subgroup.
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5


# ---------------------------------------------------------------------------
# Tower fields.  Elements are tuples of ints/tuples; modules-level functions
# keep the golden ref allocation-light and trivially portable to limb form.
# ---------------------------------------------------------------------------

# -- Fq2: a = (a0, a1) = a0 + a1·u, u² = −1 ---------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0+a1u)(b0+b1u) = a0b0 - a1b1 + (a0b1 + a1b0)u
    return (
        (a[0] * b[0] - a[1] * b[1]) % Q,
        (a[0] * b[1] + a[1] * b[0]) % Q,
    )


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_scalar(a, k: int):
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_inv(a):
    # 1/(a0+a1u) = (a0 - a1u)/(a0² + a1²)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    inv = pow(norm, -1, Q)
    return ((a[0] * inv) % Q, (-a[1] * inv) % Q)


def fq2_mul_xi(a):
    """Multiply by ξ = 1 + u."""
    return ((a[0] - a[1]) % Q, (a[0] + a[1]) % Q)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_is_zero(a) -> bool:
    return a[0] == 0 and a[1] == 0


def fq2_sqrt(a) -> Optional[Tuple[int, int]]:
    """Square root in Fq2 via the complex method (q ≡ 3 mod 4)."""
    if fq2_is_zero(a):
        return FQ2_ZERO
    a0, a1 = a
    if a1 == 0:
        # sqrt of an Fq element: either sqrt(a0) or sqrt(-a0)·u.
        s = _fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = _fq_sqrt((-a0) % Q)
        if s is None:
            return None
        return (0, s)
    norm = (a0 * a0 + a1 * a1) % Q
    alpha = _fq_sqrt(norm)
    if alpha is None:
        return None
    inv2 = pow(2, -1, Q)
    delta = ((a0 + alpha) * inv2) % Q
    x0 = _fq_sqrt(delta)
    if x0 is None:
        delta = ((a0 - alpha) * inv2) % Q
        x0 = _fq_sqrt(delta)
        if x0 is None:
            return None
    x1 = (a1 * pow(2 * x0 % Q, -1, Q)) % Q
    cand = (x0, x1)
    return cand if fq2_sqr(cand) == a else None


def _fq_sqrt(a: int) -> Optional[int]:
    """Square root in Fq (q ≡ 3 mod 4): a^((q+1)/4), verified."""
    a %= Q
    s = pow(a, (Q + 1) // 4, Q)
    return s if (s * s) % Q == a else None


# -- Fq6: a = (c0, c1, c2) over Fq2, v³ = ξ ---------------------------------


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # Karatsuba-style (school form is fine for golden ref)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
        fq2_mul_xi(t2),
    )
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_mul_by_v(a):
    """Multiply by v: (c0,c1,c2) → (ξ·c2, c0, c1)."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0)
    )
    t_inv = fq2_inv(t)
    return (fq2_mul(c0, t_inv), fq2_mul(c1, t_inv), fq2_mul(c2, t_inv))


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


# -- Fq12: a = (c0, c1) over Fq6, w² = v ------------------------------------


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_mul(a0, a0), fq6_mul_by_v(fq6_mul(a1, a1)))
    t_inv = fq6_inv(t)
    return (fq6_mul(a0, t_inv), fq6_neg(fq6_mul(a1, t_inv)))


def fq12_conj(a):
    """Conjugation = Frobenius^6: (c0, c1) → (c0, −c1)."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_from_fq(x: int):
    return (((x % Q, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# w ∈ Fq12 (the tower generator), w² = v:
FQ12_W = (FQ6_ZERO, FQ6_ONE)
FQ12_W2 = (
    (FQ2_ZERO, FQ2_ONE, FQ2_ZERO),
    FQ6_ZERO,
)  # w² = v
FQ12_W3 = (FQ6_ZERO, (FQ2_ZERO, FQ2_ONE, FQ2_ZERO))  # w³ = v·w


def fq12_from_fq2(x) -> Any:
    """Embed Fq2 into Fq12 (constant coefficient)."""
    return ((x, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# ---------------------------------------------------------------------------
# Elliptic curve arithmetic — affine, generic over a field implementation.
# Points are (x, y) tuples or None (infinity).
# ---------------------------------------------------------------------------


class _Fld:
    """Tiny vtable so the same curve code serves Fq, Fq2 and Fq12."""

    def __init__(self, add, sub, mul, inv, neg, zero, one, eq=None):
        self.add, self.sub, self.mul, self.inv, self.neg = add, sub, mul, inv, neg
        self.zero, self.one = zero, one


FQ = _Fld(
    add=lambda a, b: (a + b) % Q,
    sub=lambda a, b: (a - b) % Q,
    mul=lambda a, b: (a * b) % Q,
    inv=lambda a: pow(a, -1, Q),
    neg=lambda a: (-a) % Q,
    zero=0,
    one=1,
)
FQ2 = _Fld(fq2_add, fq2_sub, fq2_mul, fq2_inv, fq2_neg, FQ2_ZERO, FQ2_ONE)
FQ12 = _Fld(fq12_add, fq12_sub, fq12_mul, fq12_inv, fq12_neg, FQ12_ZERO, FQ12_ONE)


def ec_double(F: _Fld, p):
    if p is None:
        return None
    x, y = p
    if y == F.zero:
        return None
    # λ = 3x²/2y
    three_x2 = F.mul(F.mul(x, x), 3 if F is FQ else _small(F, 3))
    lam = F.mul(three_x2, F.inv(F.mul(y, 2 if F is FQ else _small(F, 2))))
    xr = F.sub(F.sub(F.mul(lam, lam), x), x)
    yr = F.sub(F.mul(lam, F.sub(x, xr)), y)
    return (xr, yr)


def _small(F: _Fld, k: int):
    """k·1 in the field (for the scalar constants in the formulas)."""
    acc = F.zero
    for _ in range(k):
        acc = F.add(acc, F.one)
    return acc


def ec_add(F: _Fld, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return ec_double(F, p)
        return None
    lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    xr = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    yr = F.sub(F.mul(lam, F.sub(x1, xr)), y1)
    return (xr, yr)


def ec_neg(F: _Fld, p):
    if p is None:
        return None
    return (p[0], F.neg(p[1]))


def ec_mul(F: _Fld, k: int, p):
    if k < 0:
        return ec_mul(F, -k, ec_neg(F, p))
    result = None
    acc = p
    while k:
        if k & 1:
            result = ec_add(F, result, acc)
        acc = ec_double(F, acc)
        k >>= 1
    return result


def g1_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + G1_B)) % Q == 0


def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    b = fq2_scalar(fq2_mul_xi(FQ2_ONE), G1_B)  # 4(1+u)
    return fq2_sub(fq2_sqr(y), fq2_add(fq2_mul(fq2_sqr(x), x), b)) == FQ2_ZERO


# ---------------------------------------------------------------------------
# Subgroup membership (fast endomorphism checks).
#
# The device scalar ladders (ops/curve.py) carry unequal-add safety proofs
# that hold only for points of order r, and pairing checks cannot see
# cofactor-torsion components — so every point deserialized from untrusted
# bytes must be confirmed to lie in the r-order subgroup before it reaches
# a ladder (the reference's pairing crate enforces the same invariant in
# its checked deserialization; SURVEY.md §2.2 threshold_crypto row).
#
# Full-order checks (r·P == ∞, 255-bit ladder) are the fallback; the fast
# path uses the standard eigenvalue identities (Scott, "A note on group
# membership tests for G1, G2 and GT on BLS pairing-friendly curves"):
#   G1: φ(x, y) = (β·x, y) with β a primitive cube root of unity acts on
#       the r-subgroup as multiplication by λ = x²−1 (λ³ ≡ 1 mod r since
#       r = x⁴−x²+1)  →  check φ(P) == λ·P           (126-bit ladder)
#   G2: ψ = twist∘Frobenius∘untwist acts on G2 as multiplication by the
#       curve parameter x (q ≡ t−1 = x mod r)        (64-bit ladder)
# Both identities are self-validated against the generators at import; if
# the constant resolution ever failed we would fall back to the full-order
# check rather than accept a wrong identity.
# ---------------------------------------------------------------------------


def _fq2_pow(a, e: int):
    acc = FQ2_ONE
    while e:
        if e & 1:
            acc = fq2_mul(acc, a)
        a = fq2_sqr(a)
        e >>= 1
    return acc


def _find_beta() -> int:
    for base in (2, 3, 5, 7, 11, 13):
        b = pow(base, (Q - 1) // 3, Q)
        if b != 1:
            return b
    raise AssertionError("no cube non-residue found")


_G1_LAMBDA = BLS_X * BLS_X - 1  # eigenvalue of φ on G1 (x² − 1 ≡ (−x²)² mod r)


def _resolve_beta() -> Optional[int]:
    """Pick the cube root of unity whose φ matches multiplication by λ on
    the generator; None if neither candidate validates (then the
    full-order fallback is used — correctness never depends on φ)."""
    beta = _find_beta()
    for b in (beta, beta * beta % Q):
        if (b * G1_GEN[0] % Q, G1_GEN[1]) == ec_mul(FQ, _G1_LAMBDA, G1_GEN):
            return b
    return None


_BETA = _resolve_beta()


def g1_in_subgroup(p) -> bool:
    """Order-r membership for an on-curve G1 point: φ(P) == λ·P."""
    if p is None:
        return True
    if _BETA is None:  # pragma: no cover - β resolves for BLS12-381
        return ec_mul(FQ, R, p) is None
    return ((_BETA * p[0]) % Q, p[1]) == ec_mul(FQ, _G1_LAMBDA, p)


def _resolve_psi():
    """Pick the (c_x, c_y) pair for ψ(x, y) = (c_x·x̄, c_y·ȳ) by validating
    ψ(G2_GEN) == x·G2_GEN; returns None if no candidate matches (then the
    full-order fallback is used — correctness never depends on ψ)."""
    t3 = _fq2_pow(fq2_mul_xi(FQ2_ONE), (Q - 1) // 3)  # (1+u)^((q-1)/3)
    t2 = _fq2_pow(fq2_mul_xi(FQ2_ONE), (Q - 1) // 2)  # (1+u)^((q-1)/2)
    want = ec_mul(FQ2, -BLS_X if BLS_X_IS_NEG else BLS_X, G2_GEN)
    for cx, cy in (
        (fq2_inv(t3), fq2_inv(t2)),
        (t3, t2),
        (fq2_conj(fq2_inv(t3)), fq2_conj(fq2_inv(t2))),
        (fq2_conj(t3), fq2_conj(t2)),
    ):
        x, y = G2_GEN
        if (fq2_mul(cx, fq2_conj(x)), fq2_mul(cy, fq2_conj(y))) == want:
            return cx, cy
    return None


_PSI_CONSTS = _resolve_psi()
#: the signed BLS parameter u — the single source for every site that
#: needs it (ψ eigenvalue, both cofactor clearings)
_U = -BLS_X if BLS_X_IS_NEG else BLS_X
_G2_EIGEN = _U


def g2_in_subgroup(p) -> bool:
    """Order-r membership for an on-curve G2 point: ψ(P) == x·P."""
    if p is None:
        return True
    if _PSI_CONSTS is None:  # pragma: no cover - ψ resolves for BLS12-381
        return ec_mul(FQ2, R, p) is None
    return _psi(p) == ec_mul(FQ2, _G2_EIGEN, p)


def _psi(p):
    """The twist endomorphism (requires _PSI_CONSTS; p not None)."""
    cx, cy = _PSI_CONSTS
    x, y = p
    return (fq2_mul(cx, fq2_conj(x)), fq2_mul(cy, fq2_conj(y)))


def clear_cofactor_g1(p):
    """Map an on-curve G1 point into the r-order subgroup.

    Fast path: [1−u]·P (the standard BLS12 effective cofactor — a 64-bit
    ladder instead of the 126-bit h1 multiplication).  Falls back to the
    full-cofactor multiply if the φ self-validation ever failed."""
    if _BETA is None:  # pragma: no cover - β resolves for BLS12-381
        return ec_mul(FQ, G1_COFACTOR, p)
    return ec_mul(FQ, 1 - _U, p)


def clear_cofactor_g2(p):
    """Map an on-curve twist point into the r-order G2 subgroup.

    Budroni–Pintore fast clearing: [u²−u−1]·P + [u−1]·ψ(P) + ψ²(2P) —
    three 64-bit ladders plus endomorphism applications, ~3× cheaper than
    the 508-bit effective-cofactor ladder.  This DEFINES the hash-to-G2
    output (it differs from the naive h2 multiple by a fixed scalar),
    which is fine: the framework is its own hash-to-curve universe and
    nothing persists hash outputs across versions."""
    if p is None:
        return None
    if _PSI_CONSTS is None:  # pragma: no cover - ψ resolves for BLS12-381
        return ec_mul(FQ2, G2_COFACTOR, p)
    uP = ec_mul(FQ2, _U, p)
    u1P = ec_add(FQ2, uP, ec_neg(FQ2, p))  # [u−1]P
    t = ec_add(FQ2, ec_mul(FQ2, _U, u1P), ec_neg(FQ2, p))  # [u²−u−1]P
    psiP = _psi(p)
    t = ec_add(FQ2, t, ec_add(FQ2, ec_mul(FQ2, _U, psiP), ec_neg(FQ2, psiP)))
    return ec_add(FQ2, t, _psi(_psi(ec_double(FQ2, p))))


# ---------------------------------------------------------------------------
# Pairing: untwist → generic Miller loop over E(Fq12) → final exponentiation.
# ---------------------------------------------------------------------------


def _untwist(q2):
    """ψ: E′(Fq2) → E(Fq12), (x,y) ↦ (x/w², y/w³)."""
    if q2 is None:
        return None
    x, y = q2
    xw = fq12_mul(fq12_from_fq2(x), fq12_inv(FQ12_W2))
    yw = fq12_mul(fq12_from_fq2(y), fq12_inv(FQ12_W3))
    return (xw, yw)


def _line(F: _Fld, p1, p2, t):
    """Evaluate the line through p1, p2 at point t (all in E(Fq12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        return F.sub(F.sub(yt, y1), F.mul(lam, F.sub(xt, x1)))
    if y1 == y2:
        three = _small(F, 3)
        two = _small(F, 2)
        lam = F.mul(F.mul(three, F.mul(x1, x1)), F.inv(F.mul(two, y1)))
        return F.sub(F.sub(yt, y1), F.mul(lam, F.sub(xt, x1)))
    return F.sub(xt, x1)  # vertical line


def miller_loop(q12, p12):
    """f_{|x|, Q}(P) with the standard double-and-add Miller loop."""
    if q12 is None or p12 is None:
        return FQ12_ONE
    F = FQ12
    r = q12
    f = FQ12_ONE
    for bit in bin(BLS_X)[3:]:  # skip the leading 1
        f = fq12_mul(fq12_sqr(f), _line(F, r, r, p12))
        r = ec_double(F, r)
        if bit == "1":
            f = fq12_mul(f, _line(F, r, q12, p12))
            r = ec_add(F, r, q12)
    if BLS_X_IS_NEG:
        # x < 0: f_{x,Q} = conj(f_{|x|,Q}) up to final exponentiation.
        f = fq12_conj(f)
    return f


_FINAL_EXP = (Q**12 - 1) // R


def pairing(p1, q2):
    """e(P, Q) for P ∈ G1(Fq), Q ∈ G2(Fq2) — full optimal-ate value."""
    if p1 is None or q2 is None:
        return FQ12_ONE
    p12 = (fq12_from_fq(p1[0]), fq12_from_fq(p1[1]))
    q12 = _untwist(q2)
    f = miller_loop(q12, p12)
    return fq12_pow(f, _FINAL_EXP)


def pairing_eq(a1, b1, a2, b2) -> bool:
    """e(a1, b1) == e(a2, b2), via e(a1,b1)·e(−a2,b2) == 1."""
    if a1 is None or b1 is None:
        return a2 is None or b2 is None or pairing(a2, b2) == FQ12_ONE
    if a2 is None or b2 is None:
        return pairing(a1, b1) == FQ12_ONE
    p12_a = (fq12_from_fq(a1[0]), fq12_from_fq(a1[1]))
    p12_b = (fq12_from_fq(a2[0]), fq12_from_fq((-a2[1]) % Q))
    f = fq12_mul(miller_loop(_untwist(b1), p12_a), miller_loop(_untwist(b2), p12_b))
    return fq12_pow(f, _FINAL_EXP) == FQ12_ONE


# ---------------------------------------------------------------------------
# Hashing to the curve (try-and-increment; internally consistent, not IETF).
# ---------------------------------------------------------------------------


def _hash_fq(tag: bytes, data: bytes, ctr: int) -> int:
    h = b""
    for i in range(2):  # 64 bytes → uniform enough mod Q
        h += hashlib.sha256(tag + ctr.to_bytes(4, "big") + bytes([i]) + data).digest()
    return int.from_bytes(h, "big") % Q


def hash_to_g1(data: bytes):
    ctr = 0
    while True:
        x = _hash_fq(b"bls381-g1", data, ctr)
        y2 = (x * x * x + G1_B) % Q
        y = _fq_sqrt(y2)
        if y is not None:
            # Deterministic sign choice: take the "smaller" root.
            y = min(y, Q - y)
            p = clear_cofactor_g1((x, y))
            if p is not None:
                return p
        ctr += 1


def _hash_to_g2_pure(data: bytes):
    ctr = 0
    while True:
        x = (
            _hash_fq(b"bls381-g2c0", data, ctr),
            _hash_fq(b"bls381-g2c1", data, ctr),
        )
        b = fq2_scalar(fq2_mul_xi(FQ2_ONE), G1_B)
        y2 = fq2_add(fq2_mul(fq2_sqr(x), x), b)
        y = fq2_sqrt(y2)
        if y is not None:
            neg = fq2_neg(y)
            y = min(y, neg)  # lexicographic tuple order: deterministic sign
            p = clear_cofactor_g2((x, y))
            if p is not None:
                return p
        ctr += 1


def hash_to_g2(data: bytes):
    """The native C kernel when available (``native/hashg2_kernel.c``,
    golden-checked against the pure path at first use), else the pure
    try-and-increment path; ``HBBFT_TPU_NO_NATIVE_HASHG2=1`` forces the
    pure path.  Both give the same points.  The pure path spends most of
    its time in the affine cofactor clearing."""
    from hbbft_tpu_torch import native

    p = native.hashg2(data)
    if p is not None:
        return p
    return _hash_to_g2_pure(data)


# ---------------------------------------------------------------------------
# Serialization (ZCash-style compressed).
# ---------------------------------------------------------------------------


def g1_to_bytes(p) -> bytes:
    if p is None:
        out = bytearray(48)
        out[0] = 0b1100_0000
        return bytes(out)
    x, y = p
    flag_sign = 1 if y > (Q - 1) // 2 else 0
    data = bytearray(x.to_bytes(48, "big"))
    data[0] |= 0b1000_0000 | (flag_sign << 5)
    return bytes(data)


@functools.lru_cache(maxsize=16384)
def g1_from_bytes(data: bytes):
    """Checked deserialization: on-curve AND order-r (g1_in_subgroup) — the
    device ladders' precondition. LRU'd because the protocol re-parses the
    same ciphertext bytes N times per epoch (honey_badger.py decrypt setup)
    and the subgroup ladder is ~17 ms of host Python."""
    if len(data) != 48:
        raise ValueError("G1 point must be 48 bytes")
    flags = data[0]
    if not flags & 0b1000_0000:
        raise ValueError("uncompressed encoding unsupported")
    if flags & 0b0100_0000:
        # canonical infinity: sign bit clear, all remaining bits zero
        if flags != 0b1100_0000 or any(data[1:]):
            raise ValueError("non-canonical infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0b0001_1111]) + data[1:], "big")
    if x >= Q:
        raise ValueError("x out of range")
    y = _fq_sqrt((x * x * x + G1_B) % Q)
    if y is None:
        raise ValueError("not on curve")
    sign = (flags >> 5) & 1
    if (1 if y > (Q - 1) // 2 else 0) != sign:
        y = Q - y
    if not g1_in_subgroup((x, y)):
        raise ValueError("not in the r-order subgroup")
    return (x, y)


def g2_to_bytes(p) -> bytes:
    if p is None:
        out = bytearray(96)
        out[0] = 0b1100_0000
        return bytes(out)
    (x0, x1), (y0, y1) = p
    sign = 1 if (y1, y0) > ((Q - y1) % Q, (Q - y0) % Q) else 0
    data = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    data[0] |= 0b1000_0000 | (sign << 5)
    return bytes(data)


@functools.lru_cache(maxsize=16384)
def g2_from_bytes(data: bytes):
    """Checked deserialization: on-curve AND order-r (g2_in_subgroup)."""
    if len(data) != 96:
        raise ValueError("G2 point must be 96 bytes")
    flags = data[0]
    if not flags & 0b1000_0000:
        raise ValueError("uncompressed encoding unsupported")
    if flags & 0b0100_0000:
        # canonical infinity: sign bit clear, all remaining bits zero
        if flags != 0b1100_0000 or any(data[1:]):
            raise ValueError("non-canonical infinity encoding")
        return None
    x1 = int.from_bytes(bytes([flags & 0b0001_1111]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= Q or x1 >= Q:
        raise ValueError("x out of range")
    x = (x0, x1)
    b = fq2_scalar(fq2_mul_xi(FQ2_ONE), G1_B)
    y = fq2_sqrt(fq2_add(fq2_mul(fq2_sqr(x), x), b))
    if y is None:
        raise ValueError("not on curve")
    y0, y1 = y
    sign = (flags >> 5) & 1
    have = 1 if (y1, y0) > ((Q - y1) % Q, (Q - y0) % Q) else 0
    if have != sign:
        y = fq2_neg(y)
    if not g2_in_subgroup((x, y)):
        raise ValueError("not in the r-order subgroup")
    return (x, y)


# ---------------------------------------------------------------------------
# Group implementation
# ---------------------------------------------------------------------------


class BLS381Group(Group):
    """Real BLS12-381 backend for the abstract Group seam."""

    name = "bls381"
    g1_size = 48
    g2_size = 96

    def g1(self):
        return G1_GEN

    def g2(self):
        return G2_GEN

    def g1_identity(self):
        return None

    def g2_identity(self):
        return None

    def g1_add(self, a, b):
        return ec_add(FQ, a, b)

    def g1_neg(self, a):
        return ec_neg(FQ, a)

    def g1_mul(self, scalar: int, a):
        return ec_mul(FQ, scalar % R, a)

    def g2_add(self, a, b):
        return ec_add(FQ2, a, b)

    def g2_neg(self, a):
        return ec_neg(FQ2, a)

    def g2_mul(self, scalar: int, a):
        return ec_mul(FQ2, scalar % R, a)

    def hash_to_g1(self, data: bytes):
        return hash_to_g1(data)

    def hash_to_g2(self, data: bytes):
        return hash_to_g2(data)

    def pairing_eq(self, a1, b1, a2, b2) -> bool:
        return pairing_eq(a1, b1, a2, b2)

    def g1_to_bytes(self, a) -> bytes:
        return g1_to_bytes(a)

    def g1_from_bytes(self, data: bytes):
        return g1_from_bytes(data)

    def g2_to_bytes(self, a) -> bytes:
        return g2_to_bytes(a)

    def g2_from_bytes(self, data: bytes):
        return g2_from_bytes(data)
