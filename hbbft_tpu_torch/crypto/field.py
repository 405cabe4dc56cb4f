"""Prime-field helpers on Python ints.

Shared by the mock group, the pure-Python BLS12-381 golden reference, and the
DKG polynomial math.  The scalar field order ``R`` is BLS12-381's subgroup
order, used by *all* group backends (including the mock) so that Shamir /
Lagrange code paths are bit-identical across backends.

Reference analogue: the `ff`/`pairing` field arithmetic underneath the
`threshold_crypto` crate (external dep — SURVEY.md §2.2).
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Sequence, Tuple

# BLS12-381 base-field modulus (Fq) and subgroup order (Fr).
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def modinv(a: int, m: int) -> int:
    """Modular inverse via Python's native extended-gcd pow."""
    a %= m
    if a == 0:
        raise ZeroDivisionError("inverse of 0")
    return pow(a, -1, m)


def lagrange_coeffs_at_zero(xs: Sequence[int], modulus: int = R) -> List[int]:
    """Lagrange basis values λ_j(0) for interpolation points ``xs``.

    Given distinct x-coordinates, returns λ_j such that for any polynomial f
    of degree < len(xs):  f(0) = Σ_j λ_j · f(x_j)  (mod ``modulus``).

    This is the share-combination kernel: combining signature/decryption
    shares is exactly this sum computed "in the exponent"
    (threshold_crypto `combine_signatures` §).

    Memoized: every epoch combines thousands of share sets over the SAME
    x-coordinates (the lowest f+1 verified indices), and the coefficients
    are public constants of those coordinates.
    """
    return list(_lagrange_cached(tuple(xs), modulus))


@functools.lru_cache(maxsize=4096)
def _lagrange_cached(xs: tuple, modulus: int) -> tuple:
    xs = [x % modulus for x in xs]
    if len(set(xs)) != len(xs):
        raise ValueError("interpolation points must be distinct")
    coeffs = []
    for j, xj in enumerate(xs):
        num, den = 1, 1
        for k, xk in enumerate(xs):
            if k == j:
                continue
            num = (num * xk) % modulus
            den = (den * (xk - xj)) % modulus
        coeffs.append((num * modinv(den, modulus)) % modulus)
    return tuple(coeffs)


def interpolate_at_zero(points: Iterable[Tuple[int, int]], modulus: int = R) -> int:
    """Interpolate scalar values: f(0) from {(x_j, f(x_j))}."""
    pts = list(points)
    lam = lagrange_coeffs_at_zero([x for x, _ in pts], modulus)
    acc = 0
    for l, (_, y) in zip(lam, pts):
        acc = (acc + l * y) % modulus
    return acc
