"""Batched BLS12-381 tower fields Fq2 / Fq6 / Fq12 (the JAX package's
``ops/tower.py``).

Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³−ξ) with ξ = 1+u, Fq12 = Fq6[w]/(w²−v).
Every coefficient is a (…, 79) residue tensor, so the same formulas run
over any batch shape.  Elements are nested tuples:

* fq2:  (c0, c1)
* fq6:  (a0, a1, a2)      — fq2 coefficients
* fq12: (b0, b1)          — fq6 coefficients

Lazy-add discipline: adds/subs don't renormalize; ``fq.mul`` does, so any
formula with a few chained adds per mul operand is exact.  Independent
products are stacked into one ``fq.mul_n`` (one kernel launch on the
card).  Frobenius constants come from the golden reference's Fq2
arithmetic at import time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto import bls381 as gold
from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq
from hbbft_tpu_torch.utils.tree import associative_scan, tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

FQ2_ZERO = (np.asarray(fq.ZERO), np.asarray(fq.ZERO))
FQ2_ONE = (np.asarray(fq.ONE), np.asarray(fq.ZERO))


def fq2_add(a, b):
    return (fq.add(a[0], b[0]), fq.add(a[1], b[1]))


def fq2_sub(a, b):
    return (fq.sub(a[0], b[0]), fq.sub(a[1], b[1]))


def fq2_neg(a):
    return (fq.neg(a[0]), fq.neg(a[1]))


def fq2_conj(a):
    return (a[0], fq.neg(a[1]))


def fq2_is_zero(a):
    """Exact zero test (bool over the batch shape); fq.is_zero's value
    contract on both components."""
    return fq.is_zero(a[0]) & fq.is_zero(a[1])


def fq2_mul_pairs(a, b) -> list:
    """The 3 Karatsuba Fq operand pairs of an fq2 product (for stacking)."""
    return [
        (a[0], b[0]),
        (a[1], b[1]),
        (fq.add(a[0], a[1]), fq.add(b[0], b[1])),
    ]


def fq2_from_products(t) -> tuple:
    """Recombine the 3 Karatsuba products into (c0, c1)."""
    return (fq.sub(t[0], t[1]), fq.sub(t[2], fq.add(t[0], t[1])))


def fq2_mul(a, b):
    return fq2_from_products(fq.mul_n(fq2_mul_pairs(a, b)))


def fq2_mul_many(pairs) -> list:
    """n independent fq2 products via ONE stacked Fq multiply (3n lanes)."""
    flat = []
    for a, b in pairs:
        flat.extend(fq2_mul_pairs(a, b))
    res = fq.mul_n(flat)
    return [fq2_from_products(res[3 * i : 3 * i + 3]) for i in range(len(pairs))]


def fq2_sqr(a):
    # (a0+a1u)² = (a0+a1)(a0−a1) + 2a0a1·u — 2 Fq muls.
    t0, t1 = fq.mul_n([(fq.add(a[0], a[1]), fq.sub(a[0], a[1])), (a[0], a[1])])
    return (t0, fq.add(t1, t1))


def fq2_mul_xi(a):
    """Multiply by ξ = 1 + u:  (a0 − a1) + (a0 + a1)·u."""
    return (fq.sub(a[0], a[1]), fq.add(a[0], a[1]))


def fq2_inv(a):
    n0, n1 = fq.mul_n([(a[0], a[0]), (a[1], a[1])])
    ninv = fq.inv(fq.add(n0, n1))
    m0, m1 = fq.mul_n([(a[0], ninv), (a[1], ninv)])
    return (m0, fq.neg(m1))


def fq2_select(cond, a, b):
    return (fq.select(cond, a[0], b[0]), fq.select(cond, a[1], b[1]))


def fq2_from_ints(pair) -> Tuple[np.ndarray, np.ndarray]:
    return (fq.from_int(pair[0]), fq.from_int(pair[1]))


def fq2_stack(pairs):
    """Stack Python (c0, c1) int pairs into a batched fq2 element (host)."""
    return (
        fq.from_ints([p[0] for p in pairs]),
        fq.from_ints([p[1] for p in pairs]),
    )


def fq2_to_ints(a, idx=None) -> Tuple[int, int]:
    c0, c1 = fq.to_numpy(a[0]), fq.to_numpy(a[1])
    if idx is not None:
        c0, c1 = c0[idx], c1[idx]
    return (fq.to_int(c0), fq.to_int(c1))


def fq2_broadcast(a, batch_shape, device):
    """A host fq2 constant broadcast to ``batch_shape`` on ``device``."""
    shape = tuple(batch_shape) + (fq.NLIMBS,)
    return tuple(fq.const(c, device).expand(shape) for c in a)


# ---------------------------------------------------------------------------
# Fq6
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul_fq2_pairs(a, b) -> list:
    """The 6 fq2 operand pairs of a Toom/Karatsuba fq6 product."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return [
        (a0, b0),  # t0
        (a1, b1),  # t1
        (a2, b2),  # t2
        (fq2_add(a1, a2), fq2_add(b1, b2)),  # m12
        (fq2_add(a0, a1), fq2_add(b0, b1)),  # m01
        (fq2_add(a0, a2), fq2_add(b0, b2)),  # m02
    ]


def fq6_from_products(res) -> tuple:
    """Recombine [t0, t1, t2, m12, m01, m02] into (c0, c1, c2)."""
    t0, t1, t2, m12, m01, m02 = res
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(m12, fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(m01, fq2_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(m02, fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_mul(a, b):
    return fq6_from_products(fq2_mul_many(fq6_mul_fq2_pairs(a, b)))


def fq6_mul_by_v(a):
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    s = fq2_mul_many([(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)])
    c0 = fq2_sub(s[0], fq2_mul_xi(s[1]))
    c1 = fq2_sub(fq2_mul_xi(s[2]), s[3])
    c2 = fq2_sub(s[4], s[5])
    u = fq2_mul_many([(a2, c1), (a1, c2), (a0, c0)])
    t = fq2_add(fq2_mul_xi(fq2_add(u[0], u[1])), u[2])
    t_inv = fq2_inv(t)
    out = fq2_mul_many([(c0, t_inv), (c1, t_inv), (c2, t_inv)])
    return (out[0], out[1], out[2])


def fq6_select(cond, a, b):
    return tuple(fq2_select(cond, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    # Karatsuba over Fq6; all 3 fq6 products (18 fq2, 54 Fq lanes) ride
    # ONE stacked multiply.
    a0, a1 = a
    b0, b1 = b
    flat = (
        fq6_mul_fq2_pairs(a0, b0)
        + fq6_mul_fq2_pairs(a1, b1)
        + fq6_mul_fq2_pairs(fq6_add(a0, a1), fq6_add(b0, b1))
    )
    res = fq2_mul_many(flat)
    t0 = fq6_from_products(res[0:6])
    t1 = fq6_from_products(res[6:12])
    mid = fq6_from_products(res[12:18])
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(mid, fq6_add(t0, t1))
    return (c0, c1)


def fq12_mul_line_pairs(f, line) -> list:
    """Fq2 operand pairs for f × sparse line (15 products).  The line is
    (l0, l4, l5) ≡ ((l0, 0, 0), (0, l4, l5)) in fq6 coordinates."""
    l0, l4, l5 = line
    f0, f1 = f
    a0, a1, a2 = f0
    b0, b1, b2 = f1
    pairs = []
    # t0 = f0·(l0,0,0): fq2-scalar product, 3 muls
    pairs.extend([(a0, l0), (a1, l0), (a2, l0)])
    # t1 = f1·(0,l4,l5): sparse fq6 product, 6 muls
    pairs.extend([(b1, l5), (b2, l4), (b0, l4), (b2, l5), (b0, l5), (b1, l4)])
    # mid = (f0+f1)·(l0,l4,l5): full Karatsuba fq6 product, 6 muls
    pairs.extend(fq6_mul_fq2_pairs(fq6_add(f0, f1), (l0, l4, l5)))
    return pairs


def fq12_mul_line_from_products(res) -> tuple:
    """Recombine the 15 products of fq12_mul_line_pairs."""
    t0 = (res[0], res[1], res[2])
    t1 = (
        fq2_mul_xi(fq2_add(res[3], res[4])),
        fq2_add(res[5], fq2_mul_xi(res[6])),
        fq2_add(res[7], res[8]),
    )
    mid = fq6_from_products(res[9:15])
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(mid, fq6_add(t0, t1))
    return (c0, c1)


def fq12_mul_line(f, line):
    """f × sparse line element in ONE stacked multiply (45 Fq lanes)."""
    return fq12_mul_line_from_products(fq2_mul_many(fq12_mul_line_pairs(f, line)))


def fq12_sqr_pairs(a) -> list:
    """The 12 fq2 operand pairs of a complex fq12 squaring."""
    a0, a1 = a
    return fq6_mul_fq2_pairs(a0, a1) + fq6_mul_fq2_pairs(
        fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1))
    )


def fq12_sqr_from_products(res) -> tuple:
    t = fq6_from_products(res[0:6])
    u = fq6_from_products(res[6:12])
    c0 = fq6_sub(u, fq6_add(t, fq6_mul_by_v(t)))
    c1 = fq6_add(t, t)
    return (c0, c1)


def fq12_sqr(a):
    # Complex squaring over Fq6: both fq6 products in ONE stacked multiply.
    return fq12_sqr_from_products(fq2_mul_many(fq12_sqr_pairs(a)))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq2_sqr_pairs(a) -> list:
    """The 2 Fq operand pairs of an fq2 square (for stacking)."""
    return [(fq.add(a[0], a[1]), fq.sub(a[0], a[1])), (a[0], a[1])]


def fq2_sqr_from_products(t) -> tuple:
    return (t[0], fq.add(t[1], t[1]))


def fq12_cyclo_sqr(a):
    """Granger–Scott squaring for CYCLOTOMIC elements (anything after the
    easy final-exponentiation part): three Fq4 squarings, 18 Fq lanes in
    one stacked multiply (see the JAX package's tower.py for the
    derivation), then one stacked value renormalization."""
    (a0, a1, a2), (b0, b1, b2) = a
    flat = []
    for x, y in ((a0, b1), (a1, b2), (a2, b0)):
        flat.extend(fq2_sqr_pairs(x))
        flat.extend(fq2_sqr_pairs(y))
        flat.extend(fq2_sqr_pairs(fq2_add(x, y)))
    res = fq.mul_n(flat)
    sq = [fq2_sqr_from_products(res[2 * i : 2 * i + 2]) for i in range(9)]
    (x0s, y0s, s0s), (x1s, y1s, s1s), (x2s, y2s, s2s) = (sq[0:3], sq[3:6], sq[6:9])

    def three(t):
        return fq2_add(fq2_add(t, t), t)

    def two(t):
        return fq2_add(t, t)

    # 2·x·y = (x+y)² − x² − y²  (per Fq4 pair)
    xy0 = fq2_sub(fq2_sub(s0s, x0s), y0s)
    xy1 = fq2_sub(fq2_sub(s1s, x1s), y1s)
    xy2 = fq2_sub(fq2_sub(s2s, x2s), y2s)

    s_a0 = fq2_sub(three(fq2_add(x0s, fq2_mul_xi(y0s))), two(a0))
    s_b1 = fq2_add(three(xy0), two(b1))
    s_a2 = fq2_sub(three(fq2_add(x1s, fq2_mul_xi(y1s))), two(a2))
    s_b0 = fq2_add(fq2_mul_xi(three(xy1)), two(b0))
    s_a1 = fq2_sub(three(fq2_add(fq2_mul_xi(x2s), y2s)), two(a1))
    s_b2 = fq2_add(three(xy2), two(b2))

    # Renormalize the values: the ±2·input terms would otherwise double
    # them every chained squaring (the x-power chain does 63 in a row).
    coeffs = [s_a0, s_a1, s_a2, s_b0, s_b1, s_b2]
    arrs = [c for pair in coeffs for c in pair]
    red = fq.reduce_small(torch.stack(arrs))
    out = [(red[2 * i], red[2 * i + 1]) for i in range(6)]
    return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))


def fq12_cyclo_pow_segmented(a, exponent: int):
    """a^exponent for cyclotomic a, fixed Python-int exponent > 0: one
    Granger–Scott squaring per bit and a multiply only at the set bits
    (the exponent is a host constant, so the branch is host control)."""
    bits = [int(b) for b in bin(exponent)[3:]]  # MSB implicit: acc starts at a
    acc = a
    for bit in bits:
        acc = fq12_cyclo_sqr(acc)
        if bit:
            acc = fq12_mul(acc, a)
    return acc


def fq12_inv(a):
    a0, a1 = a
    res = fq2_mul_many(fq6_mul_fq2_pairs(a0, a0) + fq6_mul_fq2_pairs(a1, a1))
    t = fq6_sub(
        fq6_from_products(res[0:6]), fq6_mul_by_v(fq6_from_products(res[6:12]))
    )
    t_inv = fq6_inv(t)
    res = fq2_mul_many(fq6_mul_fq2_pairs(a0, t_inv) + fq6_mul_fq2_pairs(a1, t_inv))
    return (fq6_from_products(res[0:6]), fq6_neg(fq6_from_products(res[6:12])))


def fq12_select(cond, a, b):
    return (fq6_select(cond, a[0], b[0]), fq6_select(cond, a[1], b[1]))


def fq12_broadcast_one(batch_shape, device):
    """Batched multiplicative identity on ``device``."""
    shape = tuple(batch_shape) + (fq.NLIMBS,)
    return tree_map(lambda c: fq.const(c, device).expand(shape), FQ12_ONE)


def fq12_pow_fixed(a, exponent: int):
    """a^exponent for a fixed Python-int exponent (square-and-multiply)."""
    ref = a[0][0][0]
    batch_shape = ref.shape[:-1]
    if exponent == 0:
        return fq12_broadcast_one(batch_shape, ref.device)
    acc = fq12_broadcast_one(batch_shape, ref.device)
    for bit in (int(b) for b in bin(exponent)[2:]):
        acc = fq12_sqr(acc)
        if bit:
            acc = fq12_mul(acc, a)
    return acc


# ---------------------------------------------------------------------------
# Frobenius x ↦ x^Q on Fq12:  frob(a) = Σ conj(a_ij) · C3^i · C6^j · v^i w^j
# with C3 = ξ^((Q−1)/3), C6 = ξ^((Q−1)/6) ∈ Fq2 (host-precomputed).
# ---------------------------------------------------------------------------


def _gold_fq2_pow(base, e: int):
    acc = gold.FQ2_ONE
    while e:
        if e & 1:
            acc = gold.fq2_mul(acc, base)
        base = gold.fq2_sqr(base)
        e >>= 1
    return acc


_XI = (1, 1)
_C3_INT = _gold_fq2_pow(_XI, (Q - 1) // 3)
_C6_INT = _gold_fq2_pow(_XI, (Q - 1) // 6)

# FROB_COEFF[j][i] = C3^i · C6^j as residue fq2 constants.
_FROB_COEFF = [
    [
        fq2_from_ints(
            gold.fq2_mul(_gold_fq2_pow(_C3_INT, i), _gold_fq2_pow(_C6_INT, j))
        )
        for i in range(3)
    ]
    for j in range(2)
]


def fq12_frobenius(a):
    """x ↦ x^Q (one application) — 6 constant muls in one stack."""
    pairs = [(fq2_conj(a[j][i]), _FROB_COEFF[j][i]) for j in range(2) for i in range(3)]
    res = fq2_mul_many(pairs)
    return ((res[0], res[1], res[2]), (res[3], res[4], res[5]))


def fq12_frobenius_n(a, n: int):
    for _ in range(n % 12):
        a = fq12_frobenius(a)
    return a


# ---------------------------------------------------------------------------
# Batch inversion (Montgomery trick) along a leading batch axis.
# ---------------------------------------------------------------------------


def _scan_products(x, mul_fn):
    """Inclusive prefix and suffix products along axis 0."""
    return associative_scan(mul_fn, x), associative_scan(mul_fn, x, reverse=True)


def batch_inv_fq2(x):
    """Invert a batch of fq2 elements (leading axis) with ONE Fq inversion.
    All elements must be nonzero."""
    prefix, suffix = _scan_products(x, fq2_mul)
    total = tree_map(lambda c: c[-1], prefix)
    tinv = fq2_inv(total)

    p0, p1 = prefix
    s0, s1 = suffix
    one0 = fq.const(FQ2_ONE[0], p0.device).expand(p0[:1].shape)
    one1 = fq.const(FQ2_ONE[1], p1.device).expand(p1[:1].shape)
    pre = (torch.cat([one0, p0[:-1]], dim=0), torch.cat([one1, p1[:-1]], dim=0))
    suf = (torch.cat([s0[1:], one0], dim=0), torch.cat([s1[1:], one1], dim=0))
    wing = fq2_mul(pre, suf)
    return fq2_mul(wing, fq2_broadcast_like(tinv, x))


def fq2_broadcast_like(a, ref):
    shape = ref[0].shape
    return tuple(c.expand(shape) for c in a)


# ---------------------------------------------------------------------------
# Host conversion fq6 / fq12 <-> golden tuples
# ---------------------------------------------------------------------------


def fq6_from_ints(t):
    return tuple(fq2_from_ints(x) for x in t)


def fq12_from_ints(t):
    return tuple(fq6_from_ints(x) for x in t)


def fq6_stack(ts):
    return tuple(fq2_stack([t[i] for t in ts]) for i in range(3))


def fq12_stack(ts):
    return tuple(fq6_stack([t[i] for t in ts]) for i in range(2))


def fq6_to_ints(a, idx=None):
    return tuple(fq2_to_ints(x, idx) for x in a)


def fq12_to_ints(a, idx=None):
    return tuple(fq6_to_ints(x, idx) for x in a)


def fq12_to_ints_batch(a, n=None):
    """Canonical Fq12 values of the first ``n`` lanes at once: twelve
    batched coefficient readbacks (``fq.to_ints``).  Returns a list of
    ``n`` nested tuples identical to the per-lane form."""
    leaves = [fq.to_numpy(c) for c in tree_leaves(a)]
    if n is None:
        n = leaves[0].shape[0]
    ints = [fq.to_ints(lv[:n]) for lv in leaves]
    return [
        tuple(
            tuple((ints[s * 6 + t * 2][i], ints[s * 6 + t * 2 + 1][i]) for t in range(3))
            for s in range(2)
        )
        for i in range(n)
    ]
