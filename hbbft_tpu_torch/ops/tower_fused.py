"""Fused tower kernels: one launch per tower operation, per Miller doubling
and for the whole final-exponentiation hard part (the JAX package's
``ops/tower_fused.py``).

Three hand-written CUDA kernels (``csrc/tower_fused.cu``, bound in
``ops/tower_fused_cuda.py``) replace the three Pallas kernels of the
reference:

* ``tower_op``   ← ``_op_kernel``: one fq2/fq6/fq12 multiply or square, or a
  Granger–Scott cyclotomic square, its independent Fq products in one core
  pass and the ``ops/tower.py`` recombination between passes;
* ``miller_dbl`` ← ``_dbl_kernel``: one Miller doubling f ← f²·l_R(P),
  R ← 2R — the four stacked rounds of ``pairing._miller_double_step``
  (48 + 18 + 7 + 45 Fq products);
* ``hard_exp``   ← ``_hard_kernel``: the whole hard part — five x-chains of
  63 cyclotomic squares and set-bit multiplies over a register file of six
  fq12 values, the glue multiplies, Frobenius¹²³ from the precomputed
  K⁽ⁿ⁾ sets and the final products.

Beside each kernel sits its plain PyTorch version (``op_plain``,
``dbl_plain``, ``hard_plain``): the kernel's stage sequence, every Fq
product through ``fq_rns_cuda.mul_plain(…, reduced=False)`` and the
recombination through the port tower's own helpers.  They equal the JAX
package's Pallas kernels residue for residue.  The one liberty: the
reference computes the set-bit multiply of the x-chain at every step and
discards it by a select; the plain version and the kernel branch on the
(warp-uniform) bit instead — the selected values are the same.

Layout: the port keeps its lane-major rows.  A tower element with C Fq
coefficients travels as one ``(C, lanes, 79)`` float32 tensor in the
canonical leaf order (``tower.fq12_to_ints_batch``'s); there is no row
layout, no pad row and no tile padding.

The public wrappers (``fq2_mul`` … ``fq12_cyclo_sqr``,
``miller_double_step_rows``, ``hard_exp``) launch the kernel on a CUDA
tensor and run the plain version on a CPU tensor; nothing falls back from
one to the other.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from hbbft_tpu_torch.crypto import bls381 as gold
from hbbft_tpu_torch.crypto.bls381 import BLS_X, BLS_X_IS_NEG
from hbbft_tpu_torch.ops import fq, tower
from hbbft_tpu_torch.ops import fq_rns as R
from hbbft_tpu_torch.ops.fq_rns_cuda import mul_plain

NL = R.NLIMBS  # 79

#: final-exp x-chain bit schedule (MSB implicit — acc starts at the base,
#: mirroring tower.fq12_cyclo_pow_segmented's bin(x)[3:]).
_X_CHAIN_BITS = np.array([int(b) for b in bin(BLS_X)[3:]], dtype=np.int32)


def fused_tower_mode() -> bool:
    """Whether verification graphs ride the fused chain — read per call,
    never cached.  ``HBBFT_TPU_NO_FUSED_TOWER=1``, or
    ``HBBFT_TPU_FUSED_TOWER`` set to ``0`` or ``off``, restores the stacked
    composition, as the reference reads both; any other value of the
    latter (``auto``, ``native``, ``interpret``) or none keeps the fused
    chain, the card's default.  On a CUDA tensor the fused chain launches
    the kernels; on a CPU tensor it runs their plain versions.  The fused
    kernels read 79-wide residue rows, so the limb arm
    (``HBBFT_TPU_FQ_IMPL=limb``) always takes the stacked chain."""
    if fq.IMPL != "rns":
        return False
    if os.environ.get("HBBFT_TPU_NO_FUSED_TOWER"):
        return False
    return os.environ.get("HBBFT_TPU_FUSED_TOWER", "auto") not in ("0", "off")


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

#: packed tower constants (40, 79): row 0 = ONE (the reduce_small
#: multiplier), rows 1+12(n−1)..12n = the Frobenius^n fq2 coefficient sets
#: for n = 1, 2, 3 (component c of K^{(n)}[j][i] at row
#: 1 + 12(n−1) + 2(3j+i) + c).  K^{(n)} = conj(K^{(n−1)})·K^{(1)} —
#: frob^n(a)_ji = conj^n(a_ji)·K^{(n)}_ji, so each frob^n application is
#: ONE 6-fq2 constant round instead of n chained applications.
NTC = 40


@functools.lru_cache(maxsize=None)
def _tower_consts() -> np.ndarray:
    c = np.zeros((NTC, NL), dtype=np.float32)
    c[0] = R.ONE
    k1 = [
        [
            gold.fq2_mul(
                tower._gold_fq2_pow(tower._C3_INT, i),
                tower._gold_fq2_pow(tower._C6_INT, j),
            )
            for i in range(3)
        ]
        for j in range(2)
    ]
    kn = k1
    for n in (1, 2, 3):
        for j in range(2):
            for i in range(3):
                row = 1 + 12 * (n - 1) + 2 * (3 * j + i)
                c[row] = R.from_int(kn[j][i][0])
                c[row + 1] = R.from_int(kn[j][i][1])
        kn = [
            [gold.fq2_mul(gold.fq2_conj(kn[j][i]), k1[j][i]) for i in range(3)]
            for j in range(2)
        ]
    return c


_TC: dict = {}


def tower_consts(device) -> torch.Tensor:
    """``_tower_consts()`` as a tensor on ``device`` (cached)."""
    key = torch.device(device)
    t = _TC.get(key)
    if t is None:
        t = _TC[key] = torch.as_tensor(_tower_consts(), device=key)
    return t


# ---------------------------------------------------------------------------
# Element pack / unpack: tuples of (..., 79) tensors <-> (C, lanes, 79)
# ---------------------------------------------------------------------------


def _leaves(el) -> list:
    """Flatten an fq2/fq6/fq12 tuple into its Fq coefficient list, in the
    canonical order (matches tower.fq12_to_ints_batch for fq12)."""
    out = []

    def walk(x):
        if isinstance(x, tuple):
            for y in x:
                walk(y)
        else:
            out.append(x)

    walk(el)
    return out


def _fq2_of(rows):
    return (rows[0], rows[1])


def _fq6_of(rows):
    return ((rows[0], rows[1]), (rows[2], rows[3]), (rows[4], rows[5]))


def _fq12_of(rows):
    return (_fq6_of(rows[0:6]), _fq6_of(rows[6:12]))


_OF = {2: _fq2_of, 6: _fq6_of, 12: _fq12_of}


def pack(el, shape=None) -> torch.Tensor:
    """A tower element (tuple of (..., 79) tensors, constants allowed) as
    one contiguous (C, lanes, 79) float32 tensor."""
    leaves = _leaves(el)
    dev = next(c.device for c in leaves if isinstance(c, torch.Tensor))
    if shape is None:
        shape = torch.broadcast_shapes(*(tuple(np.shape(c)) for c in leaves))
    cols = [fq.const(c, dev).expand(shape) if not isinstance(c, torch.Tensor)
            else c.to(fq.DTYPE).expand(shape) for c in leaves]
    return torch.stack(cols).reshape(len(cols), -1, NL).contiguous()


def unpack(t: torch.Tensor, shape) -> tuple:
    """(C, lanes, 79) → the element tuple with coefficients of ``shape``."""
    return _OF[t.shape[0]]([c.reshape(shape) for c in t.unbind(0)])


def _rows(t: torch.Tensor, n: int):
    return _OF[n](list(t.unbind(0)))


def _stacked(el) -> torch.Tensor:
    return torch.stack(_leaves(el))


# ---------------------------------------------------------------------------
# The kernels' stages, in PyTorch (the plain versions' building blocks)
# ---------------------------------------------------------------------------


def _kmul(pairs) -> list:
    """n independent Fq products in ONE core pass (``reduced=False``: the
    core renormalizes its own inputs, as the reference's in-kernel
    ``_mul_core`` does)."""
    a = torch.stack([p[0] for p in pairs])
    b = torch.stack([p[1] for p in pairs])
    return list(mul_plain(a, b, reduced=False).unbind(0))


def _kmul2(pairs2) -> list:
    """n independent fq2 products (Karatsuba, 3 Fq lanes each) in one pass."""
    flat = []
    for a, b in pairs2:
        flat.extend(tower.fq2_mul_pairs(a, b))
    res = _kmul(flat)
    return [tower.fq2_from_products(res[3 * i : 3 * i + 3]) for i in range(len(pairs2))]


def _const_row(tc: torch.Tensor, row: int, like: torch.Tensor) -> torch.Tensor:
    return tc[row].expand(like.shape)


def _reduce12(coeffs, tc) -> list:
    """fq.reduce_small over 6 fq2 coefficients: one Montgomery pass against
    the broadcast ONE row (value renormalization)."""
    arrs = [c for pair in coeffs for c in pair]
    one = _const_row(tc, 0, arrs[0])
    out = _kmul([(a, one) for a in arrs])
    return [(out[2 * i], out[2 * i + 1]) for i in range(6)]


def _fq12_mul_many_r(ab_list) -> list:
    """k independent fq12 products (18 fq2 pairs each) in ONE core pass."""
    flat = []
    for a, b in ab_list:
        a0, a1 = a
        b0, b1 = b
        flat += (
            tower.fq6_mul_fq2_pairs(a0, b0)
            + tower.fq6_mul_fq2_pairs(a1, b1)
            + tower.fq6_mul_fq2_pairs(tower.fq6_add(a0, a1), tower.fq6_add(b0, b1))
        )
    res = _kmul2(flat)
    outs = []
    for idx in range(len(ab_list)):
        r = res[18 * idx : 18 * idx + 18]
        t0 = tower.fq6_from_products(r[0:6])
        t1 = tower.fq6_from_products(r[6:12])
        mid = tower.fq6_from_products(r[12:18])
        c0 = tower.fq6_add(t0, tower.fq6_mul_by_v(t1))
        c1 = tower.fq6_sub(mid, tower.fq6_add(t0, t1))
        outs.append((c0, c1))
    return outs


def _fq12_mul_r(a, b):
    """tower.fq12_mul — 18 fq2 (54 Fq) products, one core pass."""
    return _fq12_mul_many_r([(a, b)])[0]


def _fq12_sqr_r(a):
    return tower.fq12_sqr_from_products(_kmul2(tower.fq12_sqr_pairs(a)))


def _cyclo_sqr_r(a, tc):
    """tower.fq12_cyclo_sqr (Granger–Scott): 18 squaring lanes, then the
    12-lane value renormalization — two core passes."""
    (a0, a1, a2), (b0, b1, b2) = a
    flat = []
    for x, y in ((a0, b1), (a1, b2), (a2, b0)):
        flat.extend(tower.fq2_sqr_pairs(x))
        flat.extend(tower.fq2_sqr_pairs(y))
        flat.extend(tower.fq2_sqr_pairs(tower.fq2_add(x, y)))
    res = _kmul(flat)
    sq = [tower.fq2_sqr_from_products(res[2 * i : 2 * i + 2]) for i in range(9)]
    (x0s, y0s, s0s), (x1s, y1s, s1s), (x2s, y2s, s2s) = sq[0:3], sq[3:6], sq[6:9]

    def three(t):
        return tower.fq2_add(tower.fq2_add(t, t), t)

    def two(t):
        return tower.fq2_add(t, t)

    xy0 = tower.fq2_sub(tower.fq2_sub(s0s, x0s), y0s)
    xy1 = tower.fq2_sub(tower.fq2_sub(s1s, x1s), y1s)
    xy2 = tower.fq2_sub(tower.fq2_sub(s2s, x2s), y2s)

    s_a0 = tower.fq2_sub(three(tower.fq2_add(x0s, tower.fq2_mul_xi(y0s))), two(a0))
    s_b1 = tower.fq2_add(three(xy0), two(b1))
    s_a2 = tower.fq2_sub(three(tower.fq2_add(x1s, tower.fq2_mul_xi(y1s))), two(a2))
    s_b0 = tower.fq2_add(tower.fq2_mul_xi(three(xy1)), two(b0))
    s_a1 = tower.fq2_sub(three(tower.fq2_add(tower.fq2_mul_xi(x2s), y2s)), two(a1))
    s_b2 = tower.fq2_add(three(xy2), two(b2))

    out = _reduce12([s_a0, s_a1, s_a2, s_b0, s_b1, s_b2], tc)
    return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))


def _frob3_r(y1, y2, y3, tc):
    """frob(y1), frob²(y2), frob³(y3) in ONE 18-fq2 core round, from the
    precomputed K^{(n)} sets."""
    like = y1[0][0][0]
    pairs = []
    for n, a in ((1, y1), (2, y2), (3, y3)):
        off = 1 + 12 * (n - 1)
        for j in range(2):
            for i in range(3):
                row = off + 2 * (3 * j + i)
                kc = (_const_row(tc, row, like), _const_row(tc, row + 1, like))
                aji = tower.fq2_conj(a[j][i]) if n % 2 else a[j][i]
                pairs.append((aji, kc))
    res = _kmul2(pairs)

    def f12(r):
        return ((r[0], r[1], r[2]), (r[3], r[4], r[5]))

    return f12(res[0:6]), f12(res[6:12]), f12(res[12:18])


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

#: kind → (kernel kind index, coefficient count, body on element tuples)
_OP_BODY = {
    "fq2_mul": (0, 2, lambda a, b, tc: _kmul2([(a, b)])[0]),
    "fq2_sqr": (
        1, 2,
        lambda a, b, tc: tower.fq2_sqr_from_products(_kmul(tower.fq2_sqr_pairs(a))),
    ),
    "fq6_mul": (
        2, 6,
        lambda a, b, tc: tower.fq6_from_products(_kmul2(tower.fq6_mul_fq2_pairs(a, b))),
    ),
    # tower.fq6_sqr IS fq6_mul(a, a) — mirror it exactly
    "fq6_sqr": (
        3, 6,
        lambda a, b, tc: tower.fq6_from_products(_kmul2(tower.fq6_mul_fq2_pairs(a, a))),
    ),
    "fq12_mul": (4, 12, lambda a, b, tc: _fq12_mul_r(a, b)),
    "fq12_sqr": (5, 12, lambda a, b, tc: _fq12_sqr_r(a)),
    "fq12_cyclo_sqr": (6, 12, lambda a, b, tc: _cyclo_sqr_r(a, tc)),
}

#: every kind of the op kernel
OP_KINDS = tuple(_OP_BODY)


def op_plain(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tower_op``: a, b (C, lanes, 79) → (C, lanes, 79)."""
    _, n, body = _OP_BODY[kind]
    tc = tower_consts(a.device)
    return _stacked(body(_rows(a, n), _rows(b, n), tc))


def dbl_plain(f: torch.Tensor, r: torch.Tensor, p: torch.Tensor):
    """Plain version of ``miller_dbl``: one Miller doubling f ← f²·l_R(P),
    R ← 2R.  f (12, lanes, 79), r (6, lanes, 79) = [X0 X1 Y0 Y1 Z0 Z1],
    p (2, lanes, 79) = [xP yP] → (f', r')."""
    f = _rows(f, 12)
    X, Y, Z = (r[0], r[1]), (r[2], r[3]), (r[4], r[5])
    xP, yP = p[0], p[1]

    res = _kmul2(tower.fq12_sqr_pairs(f) + [(X, X), (Y, Y), (Z, Z), (Y, Z)])
    f2 = tower.fq12_sqr_from_products(res[:12])
    XX, YY, ZZ, YZ = res[12:]
    E = tower.fq2_add(tower.fq2_add(XX, XX), XX)
    XpYY = tower.fq2_add(X, YY)
    XXX, XXZZ, YZ3, C, T, Fv = _kmul2(
        [(XX, X), (XX, ZZ), (YZ, ZZ), (YY, YY), (XpYY, XpYY), (E, E)]
    )
    D = tower.fq2_sub(tower.fq2_sub(T, XX), C)
    D = tower.fq2_add(D, D)
    X3 = tower.fq2_sub(Fv, tower.fq2_add(D, D))
    C4 = tower.fq2_add(tower.fq2_add(C, C), tower.fq2_add(C, C))
    C8 = tower.fq2_add(C4, C4)

    c1a1 = tower.fq2_sub(tower.fq2_add(tower.fq2_add(XXX, XXX), XXX), tower.fq2_add(YY, YY))
    u = tower.fq2_mul_xi(tower.fq2_add(YZ3, YZ3))
    v = tower.fq2_add(tower.fq2_add(XXZZ, XXZZ), XXZZ)

    DmX3 = tower.fq2_sub(D, X3)
    prods = _kmul(
        tower.fq2_mul_pairs(E, DmX3) + [(u[0], yP), (u[1], yP), (v[0], xP), (v[1], xP)]
    )
    EDX3 = tower.fq2_from_products(prods[:3])
    c0a0 = (prods[3], prods[4])
    c1a2 = (fq.neg(prods[5]), fq.neg(prods[6]))

    Y3 = tower.fq2_sub(EDX3, C8)
    Z3p = tower.fq2_add(YZ, YZ)

    res4 = _kmul2(tower.fq12_mul_line_pairs(f2, (c0a0, c1a1, c1a2)))
    f_new = tower.fq12_mul_line_from_products(res4)
    return _stacked(f_new), torch.stack([X3[0], X3[1], Y3[0], Y3[1], Z3p[0], Z3p[1]])


def hard_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain version of ``hard_exp``: the whole final-exp hard part of a
    cyclotomic m (12, lanes, 79) → (12, lanes, 79).

    The five x-power chains run over the register file (acc, base, b, y3,
    y2, y1).  At each chain boundary the chain's result (conjugated: BLS
    x is negative) takes the glue multiply — ·conj(m) after chain 0 (→ b),
    ·conj(b) after chain 1 (→ y3), ·conj(y3) after chain 3 (→ y1); chains
    2 and 4 multiply by ONE (→ y2, → y0').  The tail regroups
    ((y0·F1)·F2)·F3 as (y0·F1)·(F2·F3), as the reference kernel does."""
    tc = tower_consts(m.device)
    m = _rows(m, 12)
    like = m[0][0][0]
    zero = torch.zeros_like(like)
    one2 = (_const_row(tc, 0, like), zero)
    z2 = (zero, zero)
    one12 = ((one2, z2, z2), (z2, z2, z2))
    bits = [int(b) for b in _X_CHAIN_BITS]
    acc = base = b = y3 = y2 = y1 = m
    for k in range(5):
        for bit in bits:
            acc = _cyclo_sqr_r(acc, tc)
            if bit:
                acc = _fq12_mul_r(acc, base)
        ca = tower.fq12_conj(acc) if BLS_X_IS_NEG else acc
        op = (tower.fq12_conj(m), tower.fq12_conj(b), one12, tower.fq12_conj(y3), one12)[k]
        val = _fq12_mul_r(ca, op)
        acc = base = val
        if k == 0:
            b = val
        elif k == 1:
            y3 = val
        elif k == 2:
            y2 = val
        elif k == 3:
            y1 = val
    m3 = _fq12_mul_r(_cyclo_sqr_r(m, tc), m)
    y0 = _fq12_mul_r(acc, m3)
    f1, f2, f3 = _frob3_r(y1, y2, y3, tc)
    u, v = _fq12_mul_many_r([(y0, f1), (f2, f3)])
    return _stacked(_fq12_mul_r(u, v))


# ---------------------------------------------------------------------------
# Public wrappers: the kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"unsupported device {t.device}")
    return True


def tower_op(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tower operation on packed (C, lanes, 79) operands."""
    if _on_card(a):
        from hbbft_tpu_torch.ops import tower_fused_cuda

        return tower_fused_cuda.tower_op(_OP_BODY[kind][0], a, b)
    return op_plain(kind, a, b)


def _element_op(kind: str, a, b):
    leaves = _leaves((a, b))
    shape = torch.broadcast_shapes(*(tuple(np.shape(c)) for c in leaves))
    return unpack(tower_op(kind, pack(a, shape), pack(b, shape)), shape)


def fq2_mul(a, b):
    """Fused tower.fq2_mul — one kernel, 3 Fq products."""
    return _element_op("fq2_mul", a, b)


def fq2_sqr(a):
    return _element_op("fq2_sqr", a, a)


def fq6_mul(a, b):
    """Fused tower.fq6_mul — 18 Fq products in one launch."""
    return _element_op("fq6_mul", a, b)


def fq6_sqr(a):
    return _element_op("fq6_sqr", a, a)


def fq12_mul(a, b):
    """Fused tower.fq12_mul — the 54 Fq products in one launch."""
    return _element_op("fq12_mul", a, b)


def fq12_sqr(a):
    return _element_op("fq12_sqr", a, a)


def fq12_cyclo_sqr(a):
    """Fused Granger–Scott cyclotomic squaring (incl. the reduce pass)."""
    return _element_op("fq12_cyclo_sqr", a, a)


def miller_double_step_rows(f: torch.Tensor, r: torch.Tensor, p: torch.Tensor):
    """One Miller doubling — ONE launch per bit of the Miller loop.

    f (12, lanes, 79), r (6, lanes, 79) = [X0 X1 Y0 Y1 Z0 Z1],
    p (2, lanes, 79) = [xP yP]; returns (f', r') in the same layout."""
    if _on_card(f):
        from hbbft_tpu_torch.ops import tower_fused_cuda

        return tower_fused_cuda.miller_dbl(f, r, p)
    return dbl_plain(f, r, p)


def hard_exp_packed(m: torch.Tensor) -> torch.Tensor:
    """Final-exp hard part of a packed cyclotomic m (12, lanes, 79)."""
    if _on_card(m):
        from hbbft_tpu_torch.ops import tower_fused_cuda

        return tower_fused_cuda.hard_exp(m)
    return hard_plain(m)


def hard_exp(m):
    """Final-exp hard part for a CYCLOTOMIC fq12 element m — one launch.

    Drop-in for the hard half of pairing.final_exponentiation_fast (the
    five ``_cyclo_pow_x`` chains + glue); the easy part (which needs the
    Fermat inverse) stays on the stacked path."""
    shape = tuple(_leaves(m)[0].shape)
    return unpack(hard_exp_packed(pack(m, shape)), shape)


def analytic_hard_field_muls() -> int:
    """Fq products the hard-part kernel runs per lane: a cyclotomic square
    (18 + 12) per chain step, a multiply (54) per set bit, five glue
    multiplies, the m³ (30 + 54), y0 (54), Frobenius (54), final (3 × 54)."""
    steps = 5 * len(_X_CHAIN_BITS)
    set_bits = 5 * int(_X_CHAIN_BITS.sum())
    return steps * 30 + set_bits * 54 + 5 * 54 + 84 + 54 + 54 + 108 + 54

