"""Batched G1/G2 elliptic-curve arithmetic in Jacobian coordinates (the
JAX package's ``ops/curve.py``).

One generic implementation serves both groups: G1 over Fq and G2 over Fq2,
parameterized by a small field-ops namespace.

* Infinity is an explicit boolean lane carried next to (X, Y, Z); all
  formulas are total and results are selected, never branched on.
* Scalar multiplication is a fixed MSB-first ladder (2-bit windows) over
  the bit axis — one Python loop step per window, every lane in step.
* The plain Jacobian add assumes P ≠ ±Q; the w2 ladder carries a
  structural proof that the degenerate case cannot occur for scalars
  below 2^254, which its one caller, the 64-bit RLC combine, meets.
  The GLV/GLS joint-table ladders cannot carry such a proof and use the
  select-routed complete add (exact zero tests, ``fq.is_zero``).
* GLV/GLS endomorphism decomposition: G1 k = k1 + λ·k2 with |k1|,|k2| ≤ 2^127; G2 4-way GLS with
  |k_j| < 2^63; a 16-entry per-lane joint table built in a fixed order and
  a 64-step Shamir ladder whose table rows are picked by index gather.
  Outputs are identical to the w2 ladder's.

Where JAX used ``vmap``, batch axes here are simply leading tensor axes:
every point operation is elementwise over them, and the linear
combinations reduce over the LAST batch axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto import bls381 as _gold
from hbbft_tpu_torch.crypto.field import Q, R
from hbbft_tpu_torch.ops import fq, tower
from hbbft_tpu_torch.utils.device import resolve
from hbbft_tpu_torch.utils.tree import tree_map, tree_stack

SCALAR_BITS = 254  # the w2 ladder's safe scalar width (2m < r − 1 for every prefix m)
GLV_HALF_BITS = 128  # |k1|,|k2| ≤ 2^127 (Babai bound)
GLS_QUARTER_BITS = 64  # |k_j| < 2^63 for the 4-way G2 split


# ---------------------------------------------------------------------------
# Field-ops namespaces
# ---------------------------------------------------------------------------


class _F1:
    """Fq ops (G1 coordinate field)."""

    add = staticmethod(fq.add)
    sub = staticmethod(fq.sub)
    neg = staticmethod(fq.neg)
    mul = staticmethod(fq.mul)
    sqr = staticmethod(fq.sqr)
    mul_many = staticmethod(fq.mul_n)
    select = staticmethod(fq.select)
    is_zero = staticmethod(fq.is_zero)

    @staticmethod
    def is_zero_pair(a, b):
        """Both zero tests as ONE stacked probe."""
        z = fq.is_zero(torch.stack([a, b]))
        return z[0], z[1]

    @staticmethod
    def endo(P):
        """φ(x, y) = (β·x, y) — multiplication by λ on the r-subgroup."""
        return _phi_g1(P)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def one_like(x):
        return fq.const(fq.ONE, x.device).expand(x.shape)


class _F2:
    """Fq2 ops (G2 coordinate field)."""

    add = staticmethod(tower.fq2_add)
    sub = staticmethod(tower.fq2_sub)
    neg = staticmethod(tower.fq2_neg)
    mul = staticmethod(tower.fq2_mul)
    sqr = staticmethod(tower.fq2_sqr)
    mul_many = staticmethod(tower.fq2_mul_many)
    select = staticmethod(tower.fq2_select)
    is_zero = staticmethod(tower.fq2_is_zero)

    @staticmethod
    def is_zero_pair(a, b):
        """All four component zero-probes as ONE stacked fq.is_zero."""
        z = fq.is_zero(torch.stack([a[0], a[1], b[0], b[1]]))
        return z[0] & z[1], z[2] & z[3]

    @staticmethod
    def endo(P):
        """ψ = twist∘Frobenius∘untwist — multiplication by u on G2."""
        return _psi_g2(P)

    @staticmethod
    def zeros_like(x):
        return tuple(torch.zeros_like(c) for c in x)

    @staticmethod
    def one_like(x):
        return tuple(fq.const(c, x[0].device).expand(x[0].shape) for c in tower.FQ2_ONE)


# ---------------------------------------------------------------------------
# Jacobian point ops.  A point is (X, Y, Z, inf) with inf a bool tensor over
# the batch shape.  (X : Y : Z) is valid only where ~inf.
# ---------------------------------------------------------------------------


def jac_double(F, P):
    # Staged so every stage's independent products share one stacked multiply.
    X, Y, Z, inf = P
    A, B, YZ = F.mul_many([(X, X), (Y, Y), (Y, Z)])
    E = F.add(F.add(A, A), A)  # 3A
    C, t, Fv = F.mul_many([(B, B), (F.add(X, B), F.add(X, B)), (E, E)])
    D = F.add(F.sub(F.sub(t, A), C), F.sub(F.sub(t, A), C))  # 2((X+B)²−A−C)
    X3 = F.sub(Fv, F.add(D, D))
    C4 = F.add(F.add(C, C), F.add(C, C))
    C8 = F.add(C4, C4)
    (EDX3,) = F.mul_many([(E, F.sub(D, X3))])
    Y3 = F.sub(EDX3, C8)
    Z3 = F.add(YZ, YZ)
    return (X3, Y3, Z3, inf)


def jac_add(F, P, Qp, complete=False):
    """Jacobian add; infinity handled by select.

    ``complete=False``: unequal add — requires P ≠ ±Q where both are
    finite (the classic ladders prove it structurally).
    ``complete=True``: select-routed complete addition (the JAX package's
    exhaustive case split): H = U2−U1 ≡ 0 and Rr = S2−S1 ≡ 0 route P = Q
    to the doubling and P = −Q to the canonical infinity lanes."""
    if complete:
        return _jac_add_complete(F, P, Qp)
    X1, Y1, Z1, inf1 = P
    X2, Y2, Z2, inf2 = Qp
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2 = F.mul_many(
        [(Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (Z1, Z2)]
    )
    U1, U2, S1, S2 = F.mul_many([(X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1)])
    H = F.sub(U2, U1)
    Rr = F.sub(S2, S1)
    H2, Z3 = F.mul_many([(H, H), (Z1Z2, H)])
    H3, U1H2, R2 = F.mul_many([(H, H2), (U1, H2), (Rr, Rr)])
    X3 = F.sub(F.sub(R2, H3), F.add(U1H2, U1H2))
    RY, S1H3 = F.mul_many([(Rr, F.sub(U1H2, X3)), (S1, H3)])
    Y3 = F.sub(RY, S1H3)

    # inf1 → Q ; inf2 → P ; both → inf
    X3 = F.select(inf1, X2, F.select(inf2, X1, X3))
    Y3 = F.select(inf1, Y2, F.select(inf2, Y1, Y3))
    Z3 = F.select(inf1, Z2, F.select(inf2, Z1, Z3))
    return (X3, Y3, Z3, inf1 & inf2)


def _jac_add_complete(F, P, Qp):
    """jac_add's ``complete=True`` body: the doubling route's products are
    interleaved into the unequal add's stacked multiply levels (23 field
    products per lane, 5 stacked multiplies)."""
    X1, Y1, Z1, inf1 = P
    X2, Y2, Z2, inf2 = Qp
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2, dA, dB, dYZ = F.mul_many(
        [
            (Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (Z1, Z2),
            (X1, X1), (Y1, Y1), (Y1, Z1),
        ]
    )
    dE = F.add(F.add(dA, dA), dA)  # 3A
    U1, U2, S1, S2, dC, dt, dFv = F.mul_many(
        [
            (X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1),
            (dB, dB), (F.add(X1, dB), F.add(X1, dB)), (dE, dE),
        ]
    )
    H = F.sub(U2, U1)
    Rr = F.sub(S2, S1)
    dD = F.add(F.sub(F.sub(dt, dA), dC), F.sub(F.sub(dt, dA), dC))
    dX3 = F.sub(dFv, F.add(dD, dD))
    H2, Z3, dEDX = F.mul_many([(H, H), (Z1Z2, H), (dE, F.sub(dD, dX3))])
    dC4 = F.add(F.add(dC, dC), F.add(dC, dC))
    dY3 = F.sub(dEDX, F.add(dC4, dC4))
    dZ3 = F.add(dYZ, dYZ)
    H3, U1H2, R2 = F.mul_many([(H, H2), (U1, H2), (Rr, Rr)])
    X3 = F.sub(F.sub(R2, H3), F.add(U1H2, U1H2))
    RY, S1H3 = F.mul_many([(Rr, F.sub(U1H2, X3)), (S1, H3)])
    Y3 = F.sub(RY, S1H3)

    eq_x, eq_y = F.is_zero_pair(H, Rr)
    fin = ~inf1 & ~inf2
    use_dbl = fin & eq_x & eq_y
    to_inf = fin & eq_x & ~eq_y
    X3 = F.select(use_dbl, dX3, X3)
    Y3 = F.select(use_dbl, dY3, Y3)
    Z3 = F.select(use_dbl, dZ3, Z3)

    X3 = F.select(inf1, X2, F.select(inf2, X1, X3))
    Y3 = F.select(inf1, Y2, F.select(inf2, Y1, Y3))
    Z3 = F.select(inf1, Z2, F.select(inf2, Z1, Z3))
    # canonical infinity lanes keep later zero-test operands in-domain
    X3 = F.select(to_inf, F.zeros_like(X3), X3)
    Y3 = F.select(to_inf, F.one_like(Y3), Y3)
    Z3 = F.select(to_inf, F.zeros_like(Z3), Z3)
    return (X3, Y3, Z3, (inf1 & inf2) | to_inf)


def jac_neg(F, P):
    X, Y, Z, inf = P
    return (X, F.neg(Y), Z, inf)


def infinity_like(F, P):
    X, Y, Z, inf = P
    return (F.zeros_like(X), F.one_like(Y), F.zeros_like(Z), torch.ones_like(inf))


def jac_select(F, cond, P, Qp):
    return (
        F.select(cond, P[0], Qp[0]),
        F.select(cond, P[1], Qp[1]),
        F.select(cond, P[2], Qp[2]),
        torch.where(cond, P[3], Qp[3]),
    )


def _pt_map(P, fc, finf):
    """Apply ``fc`` to every coordinate leaf and ``finf`` to the flag."""
    return tuple(tree_map(fc, P[k]) for k in range(3)) + (finf(P[3]),)


def scalar_mul(F, bits: torch.Tensor, P):
    """2-bit windowed MSB-first ladder over bits (..., W), W even (the
    JAX package's w2 ladder; its binary ladder is not carried over):
    acc ← 4·acc + w·P per window, w = 2·b_hi + b_lo selected from
    precomputed {P, 2P, 3P}.  Scalars must be below 2^SCALAR_BITS;
    unequal-add safety is the JAX package's argument (prefix < 2^252
    before the last window)."""
    if bits.shape[-1] % 2:
        raise ValueError("the w2 ladder needs an even bit width")
    bits = bits.to(torch.bool)
    P2 = jac_double(F, P)
    P3 = jac_add(F, P2, P)
    acc = infinity_like(F, P)
    hi_bits = bits[..., 0::2]
    lo_bits = bits[..., 1::2]
    for s in range(hi_bits.shape[-1]):
        hi, lo = hi_bits[..., s], lo_bits[..., s]
        acc = jac_double(F, jac_double(F, acc))
        T = jac_select(F, hi, jac_select(F, lo, P3, P2), P)
        cand = jac_add(F, acc, T)
        acc = jac_select(F, hi | lo, cand, acc)
    return acc


# ---------------------------------------------------------------------------
# GLV/GLS endomorphism ladders: device side.
# ---------------------------------------------------------------------------

# crypto/bls381.py resolves and self-validates β and the ψ constants at
# import; for BLS12-381 they always resolve, so the ladders always use them.
_BETA_ROW = fq.from_int(_gold._BETA)
_PSI_CX = tower.fq2_from_ints(_gold._PSI_CONSTS[0])
_PSI_CY = tower.fq2_from_ints(_gold._PSI_CONSTS[1])


def _phi_g1(P):
    """G1 endomorphism φ in Jacobian coordinates: (β·X, Y, Z)."""
    X, Y, Z, inf = P
    (bX,) = fq.mul_n([(_BETA_ROW, X)])
    return (bX, Y, Z, inf)


def _psi_g2(P):
    """G2 endomorphism ψ in Jacobian coordinates: (c_x·X̄, c_y·Ȳ, Z̄)."""
    X, Y, Z, inf = P
    Xp, Yp = tower.fq2_mul_many(
        [(_PSI_CX, tower.fq2_conj(X)), (_PSI_CY, tower.fq2_conj(Y))]
    )
    return (Xp, Yp, tower.fq2_conj(Z), inf)


def _index_point(P, i: int):
    return tree_map(lambda c: c[i], P)


def _joint_table(F, parts, digit_base: int):
    """The 16-entry per-lane joint table T[idx] = Σ_j digit_j(idx)·parts[j]
    with idx = Σ_j digit_j·digit_base^j, built in a FIXED order over
    ``range(...)`` only (the JAX package's ``glv-table-order`` contract):
    per-part multiple chains first (one stacked doubling + one stacked
    complete add), then each further part folds in with ONE stacked
    complete add over every (d, prev) combination."""
    m = len(parts)
    if digit_base == 4:
        S = tree_stack(parts)
        D2 = jac_double(F, S)  # 2·parts[j], total — no degenerate case
        D3 = jac_add(F, D2, S, complete=True)  # 3·parts[j]
        chains = [
            [None, parts[j], _index_point(D2, j), _index_point(D3, j)]
            for j in range(m)
        ]
    else:
        chains = [[None, parts[j]] for j in range(m)]
    entries = [infinity_like(F, parts[0])] + chains[0][1:]
    for j in range(1, m):
        base = digit_base**j
        prev = list(entries)  # covers idx ∈ [0, base)
        for d in range(1, digit_base):
            entries.append(chains[j][d])  # idx = d·base (∞ + d·P_j)
            entries.extend([None] * (base - 1))  # filled from C below
        A = tree_stack([prev[i] for d in range(1, digit_base) for i in range(1, base)])
        B = tree_stack(
            [chains[j][d] for d in range(1, digit_base) for i in range(1, base)]
        )
        C = jac_add(F, A, B, complete=True)
        lane = 0
        for d in range(1, digit_base):
            for i in range(1, base):
                entries[d * base + i] = _index_point(C, lane)
                lane += 1
    return entries


def _table_planes(entries) -> torch.Tensor:
    """The table's coordinate planes stacked once: (..., planes, 16, 79)."""
    planes = []
    for k in range(3):
        if isinstance(entries[0][k], tuple):  # Fq2 component pair
            for i in range(len(entries[0][k])):
                planes.append(torch.stack([e[k][i] for e in entries], dim=-2))
        else:
            planes.append(torch.stack([e[k] for e in entries], dim=-2))
    return torch.stack(planes, dim=-3)


def _gather_entry(table, fq2: bool, ix, base_inf):
    """Per-lane table rows by index gather (the JAX package contracts a
    one-hot with the planes — the TPU form of a lane-varying gather).

    The infinity flag needs no gather: for an order-r base point every
    nonzero-window entry is finite, so the selected entry is ∞ exactly
    when the window is zero or the base point itself is ∞."""
    shape = table.shape
    index = ix.to(torch.int64)[..., None, None, None].expand(
        shape[:-2] + (1, shape[-1])
    )
    sel = torch.gather(table, -2, index).squeeze(-2)  # (..., planes, 79)
    comps = list(sel.unbind(-2))
    if fq2:
        coords = [tuple(comps[2 * k : 2 * k + 2]) for k in range(3)]
    else:
        coords = comps
    return (coords[0], coords[1], coords[2], (ix == 0) | base_inf)


def _scalar_mul_joint(F, bits, negs, P):
    """GLV/GLS joint-table Shamir ladder.

    ``bits``: (..., m, W) MSB-first windows of the m decomposed parts
    (m=2, W=128 for G1 with 2-bit windows; m=4, W=64 for G2 with 1-bit
    windows); ``negs``: (..., m) per-part sign flags; ``P``: base points
    of order r.  Per step: window-many doublings, then ONE complete add of
    the gathered table entry (the w=0 entry is the infinity lane)."""
    m = int(bits.shape[-2])
    digit_base, wbits = (4, 2) if m == 2 else (2, 1)
    negs = negs.to(torch.bool)
    parts = []
    Pj = P
    for j in range(m):
        if j:
            Pj = F.endo(Pj)
        parts.append(jac_select(F, negs[..., j], jac_neg(F, Pj), Pj))
    entries = _joint_table(F, parts, digit_base)
    table = _table_planes(entries)
    fq2 = isinstance(entries[0][0], tuple)

    bits = bits.to(torch.int64)
    w = 2 * bits[..., 0::2] + bits[..., 1::2] if wbits == 2 else bits
    idx = torch.zeros(w.shape[:-2] + w.shape[-1:], dtype=torch.int64, device=w.device)
    for j in range(m):
        idx = idx + w[..., j, :] * (digit_base**j)

    acc = infinity_like(F, P)
    base_inf = P[3]
    for s in range(idx.shape[-1]):
        for _ in range(wbits):
            acc = jac_double(F, acc)
        T = _gather_entry(table, fq2, idx[..., s], base_inf)
        acc = jac_add(F, acc, T, complete=True)
    return acc


# ---------------------------------------------------------------------------
# Host-side scalar preparation
# ---------------------------------------------------------------------------


def scalars_to_bits(scalars: Sequence[int], width: int = SCALAR_BITS) -> np.ndarray:
    """(B, width) MSB-first bit matrix (host; vectorized via unpackbits)."""
    if not scalars:
        return np.zeros((0, width), dtype=np.int32)
    nbytes = (width + 7) // 8
    rows = []
    for s in scalars:
        if s >> width:
            raise ValueError("scalar too large for bit width")
        rows.append(int(s).to_bytes(nbytes, "big"))
    buf = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(len(scalars), nbytes)
    bits = np.unpackbits(buf, axis=1)[:, 8 * nbytes - width :]
    return bits.astype(np.int32)


# ---------------------------------------------------------------------------
# GLV/GLS endomorphism ladders: host-side decomposition (exact-fraction
# Babai rounding on Python ints).
# ---------------------------------------------------------------------------

_G1_LAM = _gold._G1_LAMBDA  # λ = x²−1; λ² + λ + 1 == r EXACTLY for BLS12
assert _G1_LAM * _G1_LAM + _G1_LAM + 1 == R, "GLV basis determinant is not -r"
_G2_U = _gold._U  # the signed BLS parameter u (ψ eigenvalue on G2)
assert _G2_U**4 - _G2_U**2 + 1 == R, "GLS basis relation r(u) broken"

#: GLS lattice basis (rows): integer vectors v with Σ v_j·u^j ≡ 0 (mod r).
_G2_BASIS = (
    (_G2_U, -1, 0, 0),
    (0, _G2_U, -1, 0),
    (0, 0, _G2_U, -1),
    (1, 0, -1, _G2_U),
)


def _minor3(m, i, j) -> int:
    mm = [[m[r][c] for c in range(4) if c != j] for r in range(4) if r != i]
    a, b, c = mm[0]
    d, e, f = mm[1]
    g, h, k = mm[2]
    return a * (e * k - f * h) - b * (d * k - f * g) + c * (d * h - e * g)


def _det4(m) -> int:
    return sum((-1) ** j * m[0][j] * _minor3(m, 0, j) for j in range(4))


_G2_DET = _det4(_G2_BASIS)
_G2_ADJ0 = tuple((-1) ** j * _minor3(_G2_BASIS, j, 0) for j in range(4))
if _G2_DET < 0:
    _G2_DET = -_G2_DET
    _G2_ADJ0 = tuple(-a for a in _G2_ADJ0)
assert _G2_DET == R, "GLS basis determinant is not ±r"


def _divround(n: int, d: int) -> int:
    """round(n/d) to nearest for d > 0 (exact-fraction Babai rounding)."""
    return (2 * n + d) // (2 * d)


def glv_decompose_g1(k: int) -> List[Tuple[int, bool]]:
    """k ≡ ±k1 ± λ·k2 (mod r) with |k1|,|k2| ≤ 2^127."""
    k %= R
    b1 = _divround(-(_G1_LAM + 1) * k, R)
    b2 = _divround(k, R)
    k1 = k + b1 * _G1_LAM - b2
    k2 = -b1 - b2 * (_G1_LAM + 1)
    return [(abs(k1), k1 < 0), (abs(k2), k2 < 0)]


def gls_decompose_g2(k: int) -> List[Tuple[int, bool]]:
    """k ≡ Σ_j ±k_j·u^j (mod r) with |k_j| < 2^63 (4-way GLS split)."""
    k %= R
    bs = [_divround(k * a, _G2_DET) for a in _G2_ADJ0]
    ks = [
        (k if j == 0 else 0) - sum(bs[i] * _G2_BASIS[i][j] for i in range(4))
        for j in range(4)
    ]
    return [(abs(x), x < 0) for x in ks]


def prep_g1_scalars(scalars: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Full-width G1 ladder prep → (bits, negs) in GLV form (B, 2, 128) /
    (B, 2); the device routes on the decomposition axis."""
    parts = [glv_decompose_g1(s) for s in scalars]
    flat = [p for pair in parts for p, _ in pair]
    bits = scalars_to_bits(flat, GLV_HALF_BITS).reshape(len(scalars), 2, GLV_HALF_BITS)
    negs = np.array([n for pair in parts for _, n in pair], dtype=bool).reshape(
        len(scalars), 2
    )
    return bits, negs


def prep_g2_scalars(scalars: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Full-width G2 ladder prep: 4-way GLS form (B, 4, 64) / (B, 4)."""
    parts = [gls_decompose_g2(s) for s in scalars]
    flat = [p for quad in parts for p, _ in quad]
    bits = scalars_to_bits(flat, GLS_QUARTER_BITS).reshape(
        len(scalars), 4, GLS_QUARTER_BITS
    )
    negs = np.array([n for quad in parts for _, n in quad], dtype=bool).reshape(
        len(scalars), 4
    )
    return bits, negs


# Analytic field-mul accounting for the `ladder_field_muls` counter.
_DBL_MULS = 7  # jac_double: 3 + 3 + 1 stacked products
_ADD_MULS = 16  # jac_add unequal core: 5 + 4 + 2 + 3 + 2
_CADD_MULS = _ADD_MULS + _DBL_MULS  # complete add evaluates both routes


def ladder_scan_field_muls(bits: np.ndarray, glv: bool) -> int:
    """Per-lane field-mul count of the main ladder a prepared bit matrix
    drives (table build excluded).  Fq muls for G1, Fq2 muls for G2."""
    width = int(bits.shape[-1])
    if glv:
        m = int(bits.shape[-2])
        wbits = 2 if m == 2 else 1
        return (width // wbits) * (wbits * _DBL_MULS + _CADD_MULS)
    return (width // 2) * (2 * _DBL_MULS + _ADD_MULS)


def glv_table_field_muls(bits: np.ndarray) -> int:
    """Per-lane field-mul count of the joint-table build."""
    m = int(bits.shape[-2])
    if m == 2:
        return 1 + 2 * _DBL_MULS + 11 * _CADD_MULS  # φ is one constant mul
    return 3 * 2 + 11 * _CADD_MULS  # ψ chained three times


# ---------------------------------------------------------------------------
# Host <-> device point conversion
# ---------------------------------------------------------------------------


def _rows_to(device, *arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays)


def g1_to_device(points: Sequence[Optional[Tuple[int, int]]], cache=None, gather=None,
                 device=None):
    """Affine G1 points (golden-ref (x, y) ints or None) → batched Jacobian
    tensors on ``device``.  ``cache`` (an ops/staging.StagingCache) serves
    repeated coordinate values; ``gather`` (numpy int indices) expands
    converted DISTINCT rows to full lane width host-side."""
    dev = resolve(device)
    conv = cache.rows if cache is not None else fq.from_ints
    g = (lambda a: a[gather]) if gather is not None else (lambda a: a)
    xs = g(conv([(p[0] if p else 0) for p in points]))
    ys = g(conv([(p[1] if p else 1) for p in points]))
    inf = g(np.array([p is None for p in points]))
    zs = np.where(inf[:, None], np.asarray(fq.ZERO), np.asarray(fq.ONE)).astype(fq.NP_DTYPE)
    X, Y, Z, I = _rows_to(dev, xs, ys, zs, inf)
    return (X, Y, Z, I)


def g2_to_device(points, cache=None, gather=None, device=None):
    """Affine G2 points (((x0,x1),(y0,y1)) or None) → batched Jacobian."""
    dev = resolve(device)
    conv = cache.rows if cache is not None else fq.from_ints
    g = (lambda a: a[gather]) if gather is not None else (lambda a: a)
    X = (
        g(conv([(p[0][0] if p else 0) for p in points])),
        g(conv([(p[0][1] if p else 0) for p in points])),
    )
    Y = (
        g(conv([(p[1][0] if p else 1) for p in points])),
        g(conv([(p[1][1] if p else 0) for p in points])),
    )
    Z = (
        g(conv([(1 if p is not None else 0) for p in points])),
        g(conv([0 for _ in points])),
    )
    inf = g(np.array([p is None for p in points]))
    return (_rows_to(dev, *X), _rows_to(dev, *Y), _rows_to(dev, *Z), _rows_to(dev, inf)[0])


def _batch_modinv(vals: List[int], q: int) -> List[int]:
    """Montgomery batch inversion on host ints; zeros pass through."""
    prefix: List[int] = []
    acc = 1
    for v in vals:
        prefix.append(acc)
        if v:
            acc = acc * v % q
    inv = pow(acc, -1, q)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i]:
            out[i] = prefix[i] * inv % q
            inv = inv * vals[i] % q
    return out


def g1_from_device(P) -> List[Optional[Tuple[int, int]]]:
    """Batched Jacobian G1 → affine int tuples (host; exact)."""
    X, Y, Z, inf = (fq.to_numpy(c) for c in P)
    xs = fq.to_ints(X)
    ys = fq.to_ints(Y)
    zs = fq.to_ints(Z)
    zis = _batch_modinv(zs, Q)
    out: List[Optional[Tuple[int, int]]] = []
    for i in range(X.shape[0]):
        if inf[i] or zs[i] == 0:
            out.append(None)
            continue
        zi = zis[i]
        zi2 = zi * zi % Q
        out.append((xs[i] * zi2 % Q, ys[i] * zi2 * zi % Q))
    return out


def g2_from_device(P):
    """Batched Jacobian G2 → affine ((x0,x1),(y0,y1)) tuples (host; exact)."""
    X, Y, Z, inf = P
    inf = fq.to_numpy(inf)
    n = fq.to_numpy(X[0]).shape[0]
    coords = {}
    for name, pair in (("x", X), ("y", Y), ("z", Z)):
        coords[name + "0"] = fq.to_ints(pair[0])
        coords[name + "1"] = fq.to_ints(pair[1])
    norms = [
        (coords["z0"][i] * coords["z0"][i] + coords["z1"][i] * coords["z1"][i]) % Q
        for i in range(n)
    ]
    ninvs = _batch_modinv(norms, Q)
    out = []
    for i in range(n):
        z0, z1 = coords["z0"][i], coords["z1"][i]
        if inf[i] or (z0 == 0 and z1 == 0):
            out.append(None)
            continue
        ni = ninvs[i]
        zi = (z0 * ni % Q, (-z1 * ni) % Q)
        zi2 = ((zi[0] * zi[0] - zi[1] * zi[1]) % Q, 2 * zi[0] * zi[1] % Q)
        zi3 = (
            (zi2[0] * zi[0] - zi2[1] * zi[1]) % Q,
            (zi2[0] * zi[1] + zi2[1] * zi[0]) % Q,
        )
        x0, x1 = coords["x0"][i], coords["x1"][i]
        y0, y1 = coords["y0"][i], coords["y1"][i]
        out.append(
            (
                ((x0 * zi2[0] - x1 * zi2[1]) % Q, (x0 * zi2[1] + x1 * zi2[0]) % Q),
                ((y0 * zi3[0] - y1 * zi3[1]) % Q, (y0 * zi3[1] + y1 * zi3[0]) % Q),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Batched scalar-mul + linear combination (the share-combine kernel)
# ---------------------------------------------------------------------------


def _tree_sum(F, P, axis_len: int):
    """Reduce a batch of points to their sum by halving over the LAST
    batch axis, which keeps size 1."""
    n = axis_len
    while n > 1:
        half = n // 2
        a = _pt_map(P, lambda c: c[..., :half, :], lambda f: f[..., :half])
        b = _pt_map(P, lambda c: c[..., half : 2 * half, :], lambda f: f[..., half : 2 * half])
        summed = jac_add(F, a, b)
        if n % 2:
            tail = _pt_map(P, lambda c: c[..., -1:, :], lambda f: f[..., -1:])
            summed = tuple(
                tree_map(lambda s, t: torch.cat([s, t], dim=-2), summed[k], tail[k])
                for k in range(3)
            ) + (torch.cat([summed[3], tail[3]], dim=-1),)
            n = half + 1
        else:
            n = half
        P = summed
    return P


def jac_to_affine_g1(P):
    """Batched Jacobian → affine (x, y, inf) — one Fermat inverse total.
    Infinity lanes get coordinates (0, 1) with inf=True."""
    X, Y, Z, inf = P
    Zsafe = fq.select(inf, _F1.one_like(Z), Z)
    zinv = fq.batch_inv(Zsafe)
    zinv2, zinv3 = fq.mul_n([(zinv, zinv), (fq.mul(zinv, zinv), zinv)])
    x, y = fq.mul_n([(X, zinv2), (Y, zinv3)])
    x = fq.select(inf, _F1.zeros_like(x), x)
    y = fq.select(inf, _F1.one_like(y), y)
    return (x, y, inf)


def jac_to_affine_g2(P):
    X, Y, Z, inf = P
    Zsafe = tower.fq2_select(inf, _F2.one_like(Z), Z)
    zinv = tower.batch_inv_fq2(Zsafe)
    (zinv2,) = tower.fq2_mul_many([(zinv, zinv)])
    (zinv3,) = tower.fq2_mul_many([(zinv2, zinv)])
    x, y = tower.fq2_mul_many([(X, zinv2), (Y, zinv3)])
    x = tower.fq2_select(inf, _F2.zeros_like(x), x)
    y = tower.fq2_select(inf, _F2.one_like(y), y)
    return (x, y, inf)


def _scalar_mul_signed(F, points, bits, negs):
    """A bit matrix with a decomposition axis (ndim == point-batch ndim + 2,
    the prep_g*_scalars GLV/GLS form) routes to the joint-table ladder;
    the classic form applies the per-lane negation after the w2 ladder."""
    dev = points[3].device
    bits = torch.as_tensor(bits, device=dev)
    negs = torch.as_tensor(negs, device=dev).to(torch.bool)
    if bits.ndim == points[3].ndim + 2:
        return _scalar_mul_joint(F, bits, negs, points)
    prods = scalar_mul(F, bits, points)
    return jac_select(F, negs, jac_neg(F, prods), prods)


def g1_scalar_mul_signed(points, bits, negs):
    """Batched ±(bits_i · P_i) ladders."""
    return _scalar_mul_signed(_F1, points, bits, negs)


def g2_scalar_mul_signed(points, bits, negs):
    return _scalar_mul_signed(_F2, points, bits, negs)


def linear_combine_g1(points, bits, negs):
    """Σ ±(bits_i · P_i) over the last batch axis → a point with that axis
    of size 1.  Leading batch axes (the JAX package's vmap over items or
    groups) ride along elementwise."""
    prods = g1_scalar_mul_signed(points, bits, negs)
    return _tree_sum(_F1, prods, points[3].shape[-1])


def linear_combine_g2(points, bits, negs):
    prods = g2_scalar_mul_signed(points, bits, negs)
    return _tree_sum(_F2, prods, points[3].shape[-1])
