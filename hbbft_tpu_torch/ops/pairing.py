"""Batched BLS12-381 optimal-ate pairing (the JAX package's
``ops/pairing.py``, stacked composition).

Everything is batched over a leading axis and built from the tower and
curve layers — no inversions and no data-dependent branches in the
Miller loop:

* The G2 ladder point R runs in Jacobian coordinates; line functions are
  derived from R's Jacobian coordinates directly, each scaled by an Fq2
  factor that the final exponentiation kills.
* The loop over the bits of |x| is a host loop: the doubling step runs
  every bit, the addition step only at the set bits.
* ``final_exponentiation_fast`` computes the THIRD power of the final
  exponentiation through the x-power chain (f^{3H} == 1 iff f^H == 1,
  gcd(3, r) = 1), so it serves every verification check.

``product2_fast`` — FE_fast(ML(P1,Q1)·ML(P2,Q2)) — is the verification
kernel every batch-verify entry point of the backend runs; the host
compares each lane against 1 (``is_one_host_batch``).  The fused-tower
composition of the JAX package is still to be ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls381 import BLS_X, BLS_X_IS_NEG, FQ12_ONE
from hbbft_tpu_torch.ops import curve, fq, tower
from hbbft_tpu_torch.utils.device import resolve
from hbbft_tpu_torch.utils.tree import tree_map

# Miller bit schedule: MSB of |x| is implicit; iterate remaining bits.
_X_BITS = [int(b) for b in bin(BLS_X)[3:]]


# ---------------------------------------------------------------------------
# Host <-> device affine points
# ---------------------------------------------------------------------------


def g1_affine_to_device(points: Sequence[Optional[Tuple[int, int]]], cache=None,
                        gather=None, device=None):
    """Affine G1 ints (or None) → (x, y, inf) tensors on ``device``.
    ``cache``/``gather`` as in curve.g1_to_device."""
    dev = resolve(device)
    conv = cache.rows if cache is not None else fq.from_ints
    g = (lambda a: a[gather]) if gather is not None else (lambda a: a)
    xs = g(conv([(p[0] if p else 0) for p in points]))
    ys = g(conv([(p[1] if p else 1) for p in points]))
    inf = g(np.array([p is None for p in points]))
    return curve._rows_to(dev, xs, ys, inf)


def g2_affine_to_device(points, cache=None, gather=None, device=None):
    """Affine G2 tuples (or None) → (x fq2, y fq2, inf) tensors."""
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
    inf = g(np.array([p is None for p in points]))
    return (curve._rows_to(dev, *X), curve._rows_to(dev, *Y), curve._rows_to(dev, inf)[0])


# ---------------------------------------------------------------------------
# Line evaluations from Jacobian R
# ---------------------------------------------------------------------------


def _line_add(Rj, Qa, xP, yP):
    """Line for the mixed-addition step R + Q, scaled by D = (x_Q·Z² − X)·Z.
    With N = y_Q·Z³ − Y:  l = ξ·y_P·D + (N·x_Q − y_Q·D)·w³ − N·x_P·w⁵."""
    X, Y, Z, _ = Rj
    xQ, yQ, _ = Qa
    (ZZ,) = tower.fq2_mul_many([(Z, Z)])
    Z3, xQZZ = tower.fq2_mul_many([(ZZ, Z), (xQ, ZZ)])
    yQZ3, D = tower.fq2_mul_many([(yQ, Z3), (tower.fq2_sub(xQZZ, X), Z)])
    N = tower.fq2_sub(yQZ3, Y)
    NxQ, yQD = tower.fq2_mul_many([(N, xQ), (yQ, D)])
    c1a1 = tower.fq2_sub(NxQ, yQD)
    u = tower.fq2_mul_xi(D)
    p = fq.mul_n([(u[0], yP), (u[1], yP), (N[0], xP), (N[1], xP)])
    c0a0 = (p[0], p[1])
    c1a2 = (fq.neg(p[2]), fq.neg(p[3]))
    return (c0a0, c1a1, c1a2)


# ---------------------------------------------------------------------------
# Miller loop (batched over leading axis)
# ---------------------------------------------------------------------------


def _miller_double_step(f, Rj, xP, yP):
    """One Miller doubling — f ← f²·l(R), R ← 2R — in FOUR stacked
    multiplies, sharing every intermediate between the line evaluation
    and the Jacobian doubling:

      round 1: the 12 fq2 products of f² + X², Y², Z², Y·Z
      round 2: X³, X²Z², YZ³, Y⁴, (X+Y²)², E² (E = 3X²)
      round 3: E·(D−X₃) + the four Fq line-coefficient scalings
      round 4: the 15 fq2 products of the sparse line multiply
    """
    X, Y, Z, inf = Rj
    res = tower.fq2_mul_many(tower.fq12_sqr_pairs(f) + [(X, X), (Y, Y), (Z, Z), (Y, Z)])
    f2 = tower.fq12_sqr_from_products(res[:12])
    XX, YY, ZZ, YZ = res[12:]
    E = tower.fq2_add(tower.fq2_add(XX, XX), XX)  # 3X²
    XpYY = tower.fq2_add(X, YY)
    XXX, XXZZ, YZ3, C, T, Fv = tower.fq2_mul_many(
        [(XX, X), (XX, ZZ), (YZ, ZZ), (YY, YY), (XpYY, XpYY), (E, E)]
    )
    D = tower.fq2_sub(tower.fq2_sub(T, XX), C)
    D = tower.fq2_add(D, D)  # 2((X+Y²)² − X² − Y⁴)
    X3 = tower.fq2_sub(Fv, tower.fq2_add(D, D))
    C4 = tower.fq2_add(tower.fq2_add(C, C), tower.fq2_add(C, C))
    C8 = tower.fq2_add(C4, C4)

    # Line l = 2YZ³·ξ·y_P + (3X³ − 2Y²)·w³ − 3X²Z²·x_P·w⁵
    c1a1 = tower.fq2_sub(tower.fq2_add(tower.fq2_add(XXX, XXX), XXX), tower.fq2_add(YY, YY))
    u = tower.fq2_mul_xi(tower.fq2_add(YZ3, YZ3))
    v = tower.fq2_add(tower.fq2_add(XXZZ, XXZZ), XXZZ)

    DmX3 = tower.fq2_sub(D, X3)
    prods = fq.mul_n(
        tower.fq2_mul_pairs(E, DmX3) + [(u[0], yP), (u[1], yP), (v[0], xP), (v[1], xP)]
    )
    EDX3 = tower.fq2_from_products(prods[:3])
    c0a0 = (prods[3], prods[4])
    c1a2 = (fq.neg(prods[5]), fq.neg(prods[6]))

    Y3 = tower.fq2_sub(EDX3, C8)
    Z3p = tower.fq2_add(YZ, YZ)
    f_new = tower.fq12_mul_line(f2, (c0a0, c1a1, c1a2))
    return f_new, (X3, Y3, Z3p, inf)


def _miller_add_step(f, Rj, Qa, Qj, xP, yP):
    """One Miller mixed addition — f ← f·l(R, Q), R ← R + Q."""
    line = _line_add(Rj, Qa, xP, yP)
    R2 = curve.jac_add(curve._F2, Rj, Qj)
    return tower.fq12_mul_line(f, line), R2


def miller_loop(P, Qa):
    """f_{|x|,Q}(P), conjugated for x < 0 — batched.

    P = (xP, yP, infP); Qa = (xQ fq2, yQ fq2, infQ).  Items with an
    infinite P or Q yield f = 1."""
    xP, yP, infP = P
    xQ, yQ, infQ = Qa
    batch_shape = xP.shape[:-1]
    dev = xP.device

    one2 = tower.fq2_broadcast(tower.FQ2_ONE, batch_shape, dev)
    fin = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    Rj = (xQ, yQ, one2, fin)
    Qj = (xQ, yQ, one2, fin)

    f = tower.fq12_broadcast_one(batch_shape, dev)
    for bit in _X_BITS:
        f, Rj = _miller_double_step(f, Rj, xP, yP)
        if bit:
            f, Rj = _miller_add_step(f, Rj, Qa, Qj, xP, yP)

    if BLS_X_IS_NEG:
        f = tower.fq12_conj(f)

    neutral = infP | infQ
    return tower.fq12_select(neutral, tower.fq12_broadcast_one(batch_shape, dev), f)


def miller_product(pairs):
    """Π_k ML(P_k, Q_k) per item.  The k loops run as ONE loop over the
    pairs stacked along the leading axis (k× the lanes per multiply)."""
    if len(pairs) == 1:
        return miller_loop(*pairs[0])
    ranks = {p[0][0].ndim for p in pairs}
    batches = {p[0][0].shape[0] for p in pairs}
    if ranks != {2} or len(batches) != 1:
        f = None
        for P, Qa in pairs:
            fk = miller_loop(P, Qa)
            f = fk if f is None else tower.fq12_mul(f, fk)
        return f

    def cat(*cs):
        return torch.cat(cs, dim=0)

    P = tree_map(cat, *[p for p, _ in pairs])
    Qa = tree_map(cat, *[q for _, q in pairs])
    f_all = miller_loop(P, Qa)
    batch = pairs[0][0][0].shape[0]
    parts = [
        tree_map(lambda c, i=i: c[i * batch : (i + 1) * batch], f_all)
        for i in range(len(pairs))
    ]
    f = parts[0]
    for fk in parts[1:]:
        f = tower.fq12_mul(f, fk)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def _cyclo_pow_x(m):
    """m^x for the BLS parameter x (negative) — cyclotomic elements only,
    where inverse = conjugate."""
    p = tower.fq12_cyclo_pow_segmented(m, BLS_X)
    return tower.fq12_conj(p) if BLS_X_IS_NEG else p


def final_exponentiation_fast(f):
    """f^{3·(Q¹²−1)/R} — the x-power addition chain for the hard part:
    3·(Q⁴−Q²+1)/R = c0 + c1·Q + c2·Q² + c3·Q³ with c3 = (x−1)²,
    c2 = c3·x, c1 = c2·x − c3, c0 = c1·x + 3."""
    # easy part: f^((Q⁶−1)(Q²+1)) → cyclotomic subgroup
    m = tower.fq12_mul(tower.fq12_conj(f), tower.fq12_inv(f))
    m = tower.fq12_mul(tower.fq12_frobenius_n(m, 2), m)
    # hard part ×3
    a = _cyclo_pow_x(m)  # m^x
    b = tower.fq12_mul(a, tower.fq12_conj(m))  # m^(x−1)
    c = _cyclo_pow_x(b)  # m^(x²−x)
    y3 = tower.fq12_mul(c, tower.fq12_conj(b))  # m^((x−1)²)
    y2 = _cyclo_pow_x(y3)  # m^(c3·x)
    y1 = tower.fq12_mul(_cyclo_pow_x(y2), tower.fq12_conj(y3))  # m^(c2·x−c3)
    m3 = tower.fq12_mul(tower.fq12_cyclo_sqr(m), m)
    y0 = tower.fq12_mul(_cyclo_pow_x(y1), m3)  # m^(c1·x+3)
    out = tower.fq12_mul(y0, tower.fq12_frobenius(y1))
    out = tower.fq12_mul(out, tower.fq12_frobenius_n(y2, 2))
    out = tower.fq12_mul(out, tower.fq12_frobenius_n(y3, 3))
    return out


def product2_fast(P1, Q1, P2, Q2):
    """THE verification kernel: FE_fast(ML(P1,Q1)·ML(P2,Q2)) as fq12
    residues.  Host-compare each lane against 1 to decide
    e(P1,Q1)·e(P2,Q2) == 1."""
    return final_exponentiation_fast(miller_product([(P1, Q1), (P2, Q2)]))


# ---------------------------------------------------------------------------
# Host-side comparison (the only canonical reduction, at the seam)
# ---------------------------------------------------------------------------


def is_one_host(f, idx=None) -> bool:
    """Exact check f == 1 in Fq12 (host ints)."""
    return tower.fq12_to_ints(f, idx) == FQ12_ONE


def is_one_host_batch(f, n: int) -> list:
    """Exact f == 1 for the first ``n`` lanes in one vectorized readback."""
    return [v == FQ12_ONE for v in tower.fq12_to_ints_batch(f, n)]
