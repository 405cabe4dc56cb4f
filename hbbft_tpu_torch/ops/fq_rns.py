"""Batched BLS12-381 Fq arithmetic in a Residue Number System (RNS).

The port of the JAX package's ``ops/fq_rns.py``, same surface, same
numbers:

* An element is its residues modulo 78 fixed 11-bit primes (two RNS
  bases B1, B2 of 39 primes each) plus one redundant power-of-two
  modulus m_r = 256 — layout ``(..., 79)`` float32, all values exact
  integers < 2^24 (the f32 exact envelope).
* Multiplication is the full-RNS Montgomery product: 79 pointwise lane
  products plus two base extensions, each a constant-matrix product
  ``(..., 39) @ (39, 40)`` with entries split ``e = e_lo + 64·e_hi`` so
  every partial sum stays below 2^24 and exact in float32.
* ``mul(a, b)`` returns ``a·b·M1⁻¹ (mod Q)`` — elements are kept in
  Montgomery form, invisible to callers because every conversion goes
  through ``from_int``/``to_int``.

Value discipline: a represented VALUE may be any integer with
|v| < 2^16·Q; ``add``/``sub``/``neg`` are lazy, ``mul`` renormalizes its
own inputs (output < 41·Q).

Routing (the counterpart of the JAX package's ``_use_fused`` with
``HBBFT_TPU_RNS_FUSED=all``): on a CUDA tensor, ``mul``, ``_mul_body``
and ``pow_fixed`` launch the hand-written kernels of
``ops/fq_rns_cuda.py``; on a CPU tensor they run the plain stage-by-stage
form below, which is residue-for-residue the JAX package's XLA path.
Both compute the same represented values (the kernels follow the JAX
package's Pallas kernel, whose loose reductions may leave a lane one
modulus away from the XLA form's).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.utils import device as _device  # noqa: F401  (TF32 pins)
from hbbft_tpu_torch.utils.tree import associative_scan

DTYPE = torch.float32
NP_DTYPE = np.float32

# -- base construction (Python ints, import time) ----------------------------


def _primes_11bit() -> List[int]:
    sieve = np.ones(2048, dtype=bool)
    sieve[:2] = False
    for i in range(2, 46):
        if sieve[i]:
            sieve[i * i :: i] = False
    return [int(p) for p in np.nonzero(sieve)[0] if p > 1024][::-1]


_ALL = _primes_11bit()  # descending from 2039
N_B = 39  # primes per base
B1 = _ALL[:N_B]
B2 = _ALL[N_B : 2 * N_B]
M_R = 256  # redundant Shenoy–Kumaresan modulus (coprime: primes are odd)
M1 = 1
for _p in B1:
    M1 *= _p
M2 = 1
for _p in B2:
    M2 *= _p
assert M1 > (Q << 34), "M1 must exceed 2^34*Q for the lazy-value closure"
assert M2 > 80 * Q, "M2 must exceed the Montgomery-output bound"
assert M_R > N_B + 2, "S-K correction digit must fit the redundant modulus"
# The tightest f32-exactness bound any mul stage relies on (the fused r2r
# reduction): |x2r|·M1⁻¹ + q̂·(Q·M1⁻¹) < 3p² + p² = 4p² ≈ 2^23.99.
_P_MAX = _ALL[0]
assert 4 * _P_MAX * _P_MAX < (1 << 24), "fused r2r reduction exceeds f32-exact"

#: lane layout: [B1 | B2 | m_r]
NLIMBS = 2 * N_B + 1
_S1 = slice(0, N_B)
_S2 = slice(N_B, 2 * N_B)
_SR = slice(2 * N_B, 2 * N_B + 1)

_P_ALL = np.array(B1 + B2 + [M_R], dtype=np.int64)
P_VEC = _P_ALL.astype(NP_DTYPE)
_INV_P = (1.0 / _P_ALL).astype(NP_DTYPE)

# Montgomery per-lane constants.
_M1INV_B2R = np.array(
    [pow(M1, -1, p) for p in B2] + [pow(M1, -1, M_R)], dtype=NP_DTYPE
)  # M1⁻¹ mod p_j,  j ∈ B2∪{m_r}
# fused: σ_i = x_i·(−Q⁻¹·(M1/p_i)⁻¹ mod p_i) — one product+mod, not two
_SIGMA_C_B1 = np.array(
    [((-pow(Q, -1, p)) % p) * pow(M1 // p, -1, p) % p for p in B1],
    dtype=NP_DTYPE,
)
# fused: r_j = x_j·M1⁻¹ + q̂_j·(Q·M1⁻¹ mod p_j) — one reduction for the sum
_QM1INV_B2R = np.array(
    [Q * pow(M1, -1, p) % p for p in B2] + [Q * pow(M1, -1, M_R) % M_R],
    dtype=NP_DTYPE,
)
_W2INV_B2 = np.array(
    [pow(M2 // p, -1, p) for p in B2], dtype=NP_DTYPE
)  # (M2/p_j)⁻¹ mod p_j
_M2INV_R = float(pow(M2, -1, M_R))
_M2_B1 = np.array([M2 % p for p in B1], dtype=NP_DTYPE)  # M2 mod p_i

# Sign offset: a multiple of Q added to every Montgomery numerator so the
# integer being reduced is provably non-negative.
_X_OFFSET_INT = (1 << 33) * Q * Q
assert _X_OFFSET_INT % Q == 0

# Extension matrices, entry-split e = e_lo + 64·e_hi (entries ≤ 63 / 31).
_SPLIT_SHIFT = 64.0


def _split_matrix(e: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    hi = np.floor(e / _SPLIT_SHIFT)
    return (e - hi * _SPLIT_SHIFT).astype(NP_DTYPE), hi.astype(NP_DTYPE)


# E1[i, j] = (M1/p_i) mod (B2∪{m_r})_j   — extension 1 (B1 → B2∪m_r)
_E1 = np.array(
    [[(M1 // p) % pj for pj in B2 + [M_R]] for p in B1], dtype=np.float64
)
# E2[j, i] = (M2/p_j) mod (B1∪{m_r})_i   — extension 2 (B2 → B1∪m_r)
_E2 = np.array(
    [[(M2 // p) % pi for pi in B1 + [M_R]] for p in B2], dtype=np.float64
)
_E1_LO, _E1_HI = _split_matrix(_E1)
_E2_LO, _E2_HI = _split_matrix(_E2)

ZERO = np.zeros(NLIMBS, dtype=NP_DTYPE)


# -- host <-> device conversion ----------------------------------------------


def from_int(x: int) -> np.ndarray:
    """Residue vector of the MONTGOMERY form x·M1 mod Q."""
    v = (x % Q) * M1 % Q
    return np.array(
        [v % p for p in B1] + [v % p for p in B2] + [v % M_R], dtype=NP_DTYPE
    )


ONE = from_int(1)

# 30-bit limb decomposition for vectorized host<->device conversion.
# Residues/limbs < 2^11/2^30, so the int64 matmuls peak at
# 13·2^30·2^11 < 2^45 (from) and 39·2^11·2^30 < 2^47 (to) — no wrap.
_N_IN_LIMBS = 13  # ceil(381 / 30)
_POW30 = np.array(
    [[pow(1 << 30, j, int(p)) for p in _P_ALL] for j in range(_N_IN_LIMBS)],
    dtype=np.int64,
)  # (13, 79)
_P_VEC_I64 = np.asarray(P_VEC, dtype=np.int64)
_MASK30 = (1 << 30) - 1


def from_ints(xs) -> np.ndarray:
    """Stack of residue vectors (host numpy), value-deduplicated."""
    xs = [int(x) for x in xs]
    uniq: dict = {}
    vals: List[int] = []
    idx = np.empty(len(xs), dtype=np.int64)
    for j, x in enumerate(xs):
        pos = uniq.get(x)
        if pos is None:
            pos = uniq[x] = len(vals)
            vals.append(x)
        idx[j] = pos
    if not vals:
        return np.zeros((0, NLIMBS), dtype=NP_DTYPE)
    limbs = np.empty((len(vals), _N_IN_LIMBS), dtype=np.int64)
    for i, x in enumerate(vals):
        v = (x % Q) * M1 % Q
        for j in range(_N_IN_LIMBS):
            limbs[i, j] = v & _MASK30
            v >>= 30
    res = np.mod(limbs @ _POW30, _P_VEC_I64)  # (u, 79)
    return res.astype(NP_DTYPE)[idx]


# Garner/CRT weights over B1 for host readback.
_CRT_W_B1 = [(M1 // p) * pow(M1 // p, -1, p) % M1 for p in B1]
_M1_INV_Q = pow(M1, -1, Q)


def to_numpy(res) -> np.ndarray:
    """A tensor (on any device) or array-like as host numpy."""
    if isinstance(res, torch.Tensor):
        return res.detach().cpu().numpy()
    return np.asarray(res)


def to_int(res) -> int:
    """Exact represented value mod Q (strips the Montgomery factor).

    Recovered from base B1 alone: CRT gives v mod M1, and |v| < 2^16·Q ≪
    M1/2 maps the high half to negatives unambiguously."""
    arr = to_numpy(res)
    v = 0
    for k, p in enumerate(B1):
        r = int(round(float(arr[..., k]))) % p
        v = (v + r * _CRT_W_B1[k]) % M1
    if v > M1 // 2:
        v -= M1
    return v * _M1_INV_Q % Q


_W_LIMBS = np.array(
    [[(w >> (30 * j)) & _MASK30 for j in range(15)] for w in _CRT_W_B1],
    dtype=np.int64,
)
_B1_I64 = np.asarray(B1, dtype=np.int64)


def to_ints(batch) -> list:
    """Vectorized batch readback of a (n, 79) stack (host)."""
    arr = to_numpy(batch)
    if arr.ndim == 1:
        return [to_int(arr)]
    n = arr.shape[0]
    if n == 0:
        return []
    r = np.mod(np.rint(arr[..., : len(B1)]).astype(np.int64), _B1_I64)
    S = r @ _W_LIMBS  # (n, 15), exact: 39·2^11·2^30 < 2^47
    out = []
    half = M1 // 2
    for i in range(n):
        v = 0
        row = S[i]
        for j in range(14, -1, -1):
            v = (v << 30) + int(row[j])
        v %= M1
        if v > half:
            v -= M1
        out.append(v * _M1_INV_Q % Q)
    return out


# -- constants on a device ----------------------------------------------------

_P_B2R = np.concatenate([P_VEC[_S2], P_VEC[_SR]])
_INVP_B2R = np.concatenate([_INV_P[_S2], _INV_P[_SR]])
_P_B1R = np.concatenate([P_VEC[_S1], P_VEC[_SR]])
_INVP_B1R = np.concatenate([_INV_P[_S1], _INV_P[_SR]])
_X_OFF = np.array([_X_OFFSET_INT % int(p) for p in _P_ALL], dtype=NP_DTYPE)

#: Zero-test constants (see is_zero).
_Z_BOUND = 256
assert 2 * _Z_BOUND * Q < M1, "zero-test bound must stay CRT-unambiguous"
assert 2 * _Z_BOUND < min(B1), "zero-test digit must fit every base prime"
_Z_OFF_B1 = np.array([(_Z_BOUND * Q) % int(p) for p in B1], dtype=NP_DTYPE)
_Z_QINV_B1 = np.array([pow(Q, -1, int(p)) for p in B1], dtype=NP_DTYPE)

_NP_CONSTS = {
    "p": P_VEC,
    "invp": _INV_P,
    "x_off": _X_OFF,
    "sigma_c": _SIGMA_C_B1,
    "e1_lo": _E1_LO,
    "e1_hi": _E1_HI,
    "e2_lo": _E2_LO,
    "e2_hi": _E2_HI,
    "p_b2r": _P_B2R,
    "invp_b2r": _INVP_B2R,
    "p_b1r": _P_B1R,
    "invp_b1r": _INVP_B1R,
    "m1inv_b2r": _M1INV_B2R,
    "qm1inv_b2r": _QM1INV_B2R,
    "w2inv_b2": _W2INV_B2,
    "m2_b1": _M2_B1,
    "one": ONE,
    "z_off": _Z_OFF_B1,
    "z_qinv": _Z_QINV_B1,
}
_DEV_CONSTS: dict = {}


def _consts(device) -> dict:
    """The module's constant vectors as tensors on ``device`` (cached)."""
    key = torch.device(device)
    c = _DEV_CONSTS.get(key)
    if c is None:
        c = {k: torch.as_tensor(v, device=key) for k, v in _NP_CONSTS.items()}
        _DEV_CONSTS[key] = c
    return c


_SMALL_CONSTS: dict = {}


def const(arr, device) -> torch.Tensor:
    """A small host constant (a residue row or a stack of a few) as a
    tensor on ``device``, converted once per (value, device)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.size > 4096:
        return torch.as_tensor(arr, device=device)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, torch.device(device))
    t = _SMALL_CONSTS.get(key)
    if t is None:
        t = _SMALL_CONSTS[key] = torch.as_tensor(arr, device=device)
    return t


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise TypeError("at least one operand must be a tensor")


def _tensor(x, device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else const(x, device)


# -- lane-wise modular reduction ---------------------------------------------


def _mod_lanes(x: torch.Tensor, p, invp) -> torch.Tensor:
    """Exact per-lane reduction to [0, p) for integer-valued f32 inputs
    with |x| < 2^24: one estimated-quotient pass and two clamps."""
    x = x - torch.floor(x * invp) * p
    x = x - p * (x >= p)
    x = x + p * (x < 0)
    return x


def _mod_loose(x: torch.Tensor, p, invp) -> torch.Tensor:
    """One-pass reduction to (−p, 2p) — same congruence class, no clamps."""
    return x - torch.floor(x * invp) * p


def carry3(x) -> torch.Tensor:
    """Reduce every lane into (−p, 2p) (the represented VALUE is unchanged)."""
    c = _consts(x.device)
    return _mod_loose(x.to(DTYPE), c["p"], c["invp"])


def reduce_small(x: torch.Tensor) -> torch.Tensor:
    """VALUE renormalization: a Montgomery product with ONE brings the
    represented value back below 41·Q."""
    return mul(x, _consts(x.device)["one"])


# -- core ops ----------------------------------------------------------------


def add(a, b):
    """Lazy add — pointwise, no reduction (mul renormalizes)."""
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def select(cond: torch.Tensor, a, b) -> torch.Tensor:
    dev = _device_of(cond, a, b)
    return torch.where(cond[..., None], _tensor(a, dev), _tensor(b, dev))


def _ext_matmul(sigma, lo, hi, p_out, invp_out) -> torch.Tensor:
    """Σ_i sigma_i · E[i, j] mod p_j via the two entry-split constant
    matmuls (the JAX package's ``highest`` mode): sigma lanes are reduced
    (< 2^11), each partial contraction stays below 2^22.3, so float32
    accumulation is exact in any summation order."""
    s_lo = sigma @ lo
    s_hi = _mod_lanes(sigma @ hi, p_out, invp_out)
    return _mod_lanes(s_lo + _SPLIT_SHIFT * s_hi, p_out, invp_out)


def _use_kernel(x: torch.Tensor) -> bool:
    """CUDA tensors go through the hand-written kernels (fq_rns_cuda);
    CPU tensors take the plain form.  Decided by where the data lies."""
    return x.is_cuda


def mul(a, b) -> torch.Tensor:
    """Montgomery product a·b·M1⁻¹ (mod Q)."""
    dev = _device_of(a, b)
    a, b = _tensor(a, dev), _tensor(b, dev)
    if _use_kernel(a):
        from hbbft_tpu_torch.ops import fq_rns_cuda

        return fq_rns_cuda.mul(a, b, reduced=False)
    return _mul_body(carry3(a), carry3(b))


def _mul_body(a, b) -> torch.Tensor:
    """mul minus the input renormalization: both operands' lanes must be
    in (−p, 2p) already — true for carry3 output and for any output of
    this function itself (|a·b| ≤ 4p² < 2^24)."""
    dev = _device_of(a, b)
    a, b = _tensor(a, dev), _tensor(b, dev)
    if _use_kernel(a):
        from hbbft_tpu_torch.ops import fq_rns_cuda

        return fq_rns_cuda.mul(a, b, reduced=True)
    c = _consts(dev)
    p, invp = c["p"], c["invp"]
    # x lanes stay unreduced in (−p, 3p): both downstream products still
    # fit the exact envelope (3p·p ≈ 2^23.6 < 2^24).
    x = _mod_loose(a * b, p, invp) + c["x_off"]

    # σ_i = (−x·Q⁻¹ mod M1)·(M1/p_i)⁻¹ mod p_i, constants fused.
    p1, ip1 = p[_S1], invp[_S1]
    sigma = _mod_lanes(x[..., _S1] * c["sigma_c"], p1, ip1)

    # Extension 1 (uncorrected CRT sum): q̂ = q + δ·M1, δ ≤ 38.
    qhat = _ext_matmul(sigma, c["e1_lo"], c["e1_hi"], c["p_b2r"], c["invp_b2r"])

    # r = (x + q̂·Q)/M1 over B2 ∪ {m_r}: x·M1⁻¹ + q̂·(Q·M1⁻¹), one reduction.
    x2r = x[..., N_B:]
    r2r = _mod_loose(
        x2r * c["m1inv_b2r"] + qhat * c["qm1inv_b2r"], c["p_b2r"], c["invp_b2r"]
    )
    r2 = r2r[..., :N_B]
    r_mr = r2r[..., N_B:]

    # Extension 2 (Shenoy–Kumaresan, exact through m_r): B2 → B1.
    p2, ip2 = p[_S2], invp[_S2]
    xi = _mod_lanes(r2 * c["w2inv_b2"], p2, ip2)
    raw = _ext_matmul(xi, c["e2_lo"], c["e2_hi"], c["p_b1r"], c["invp_b1r"])
    raw1 = raw[..., :N_B]
    raw_mr = raw[..., N_B:]
    delta = _mod_lanes((raw_mr - r_mr) * _M2INV_R, float(M_R), 1.0 / M_R)
    r1 = _mod_loose(raw1 - delta * c["m2_b1"], p1, ip1)
    return torch.cat([r1, r2, r_mr], dim=-1)


def sqr(a):
    return mul(a, a)


def mul_n(pairs) -> list:
    """Stacked independent products: one multiply over all pairs."""
    if len(pairs) == 1:
        return [mul(pairs[0][0], pairs[0][1])]
    dev = _device_of(*[x for pr in pairs for x in pr])
    ops = [(_tensor(a, dev), _tensor(b, dev)) for a, b in pairs]
    common = torch.broadcast_shapes(*[t.shape for pr in ops for t in pr])
    A = torch.stack([a.expand(common) for a, _ in ops])
    B = torch.stack([b.expand(common) for _, b in ops])
    C = mul(A, B)
    return list(C.unbind(0))


def mul_small(a, k: int) -> torch.Tensor:
    """Multiply by a small int, |k| < 2^15, through a full Montgomery
    product (the value renormalizes, so chains of scalings compose)."""
    if not -(1 << 15) < k < (1 << 15):
        raise ValueError("|k| must be < 2^15")
    return mul(a, const(from_int(k), a.device))


def pow_fixed(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent for a fixed Python-int exponent (square-and-multiply).

    The base is carried once and the loop chains :func:`_mul_body`; on the
    card the whole chain is one kernel launch (exponent ≥ 1)."""
    if exponent >= 1 and _use_kernel(x):
        from hbbft_tpu_torch.ops import fq_rns_cuda

        return fq_rns_cuda.pow_fixed(x, exponent)
    bits = [int(b) for b in bin(exponent)[2:]]
    x_c = carry3(x)
    acc = _consts(x.device)["one"].expand(x.shape)
    for bit in bits:
        acc = _mul_body(acc, acc)
        if bit:
            acc = _mul_body(acc, x_c)
    return acc


def inv(x: torch.Tensor) -> torch.Tensor:
    return pow_fixed(x, Q - 2)


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse of every element along axis 0 with ONE Fermat inverse
    (prefix/suffix products by parallel scan, Montgomery's trick).  The
    stack is carried once, so every scan operand meets _mul_body's
    (−p, 2p) contract."""
    xc = carry3(x)
    prefix = associative_scan(_mul_body, xc)
    suffix = associative_scan(_mul_body, xc, reverse=True)
    tinv = inv(prefix[-1])
    one = _consts(x.device)["one"].expand(x[:1].shape)
    pre = torch.cat([one, prefix[:-1]], dim=0)
    suf = torch.cat([suffix[1:], one], dim=0)
    return _mul_body(_mul_body(pre, suf), tinv.expand(x.shape))


def is_zero_host(res) -> bool:
    return to_int(res) == 0


# -- in-graph zero test (complete-add route selector; ops/curve.py) ----------
#
# An RNS vector determines its integer value v exactly mod M1 (base B1
# alone), and every value the curve layer feeds here is a short linear
# combination of Montgomery-mul outputs, so |v| < _Z_BOUND·Q ≪ M1/2.
# With v' = v + _Z_BOUND·Q and w ≡ v'·Q⁻¹ (mod p_i) per lane, Q | v
# exactly when all 39 lanes of w agree on one value c < 2·_Z_BOUND.


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """Exact test: does the residue vector represent 0 mod Q?  Bool over
    the batch shape.  The represented INTEGER must satisfy |v| <
    _Z_BOUND·Q (true for sums/differences of a few mul outputs)."""
    c = _consts(x.device)
    p1, ip1 = c["p"][_S1], c["invp"][_S1]
    v = _mod_lanes(x.to(DTYPE)[..., _S1], p1, ip1)
    v = _mod_lanes(v + c["z_off"], p1, ip1)
    w = _mod_lanes(v * c["z_qinv"], p1, ip1)
    same = torch.all(w == w[..., :1], dim=-1)
    return same & (w[..., 0] < 2 * _Z_BOUND)
