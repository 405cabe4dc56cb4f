"""Batched BLS12-381 Fq arithmetic on 8-bit float32 limbs (the JAX
package's ``ops/fq_limb.py``, its default 8-bit arm).

The field's second representation, selected by ``HBBFT_TPU_FQ_IMPL=limb``
through the facade (``ops/fq.py``) and kept as an independent
cross-check of the RNS default:

* An element is any vector ``l[0..49]`` of float32 integers whose value
  Σ l_i·2^(8·i) is congruent to the element mod Q — layout ``(..., 50)``.
  Limbs may be negative (subtraction never borrows) and the value may
  exceed Q; every op tolerates inputs with a dozen chained lazy adds.
* Every intermediate stays an integer below 2^24, so float32 arithmetic
  is exact in any summation order:

      products  ≤ 257²                  ≈ 2^16.01
      conv sum  ≤ 50 · 257²             ≈ 2^21.7
      fold sum  ≤ 51 · 257 · 255        ≈ 2^21.7

* ``carry3`` renormalizes limbs to [-1, 257] in three vector passes; the
  top limb is never split, so no carry is dropped.  There is no canonical
  form on the device: ``to_int`` reduces exactly on the host.

A product is the 50×50 limb convolution, then carries and two folds of
the limbs ≥ 48 through the rows ``FOLD[j] = limbs(2^(8·(48+j)) mod Q)``.
There is one arithmetic for it: ``mul`` and ``pow_fixed`` go through
``ops/fq_limb_cuda.py``, which launches the hand-written kernels on a
CUDA tensor and runs their plain versions — the JAX package's Pallas
kernels (``ops/fq_pallas.py``) stage for stage — on a CPU tensor.  So
``mul`` equals the reference's ``fq_limb.mul`` and ``fq_pallas.mul`` limb
for limb, and ``pow_fixed`` equals ``fq_pallas.pow_fixed`` (the
reference's XLA ``pow_fixed`` starts from ONE and re-carries before each
product, so it gives another limb vector of the same value).

Only the 8-bit width is ported; ``HBBFT_TPU_FQ_BITS`` set to anything
else raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from hbbft_tpu_torch.crypto.field import Q

# Helpers that know nothing of the representation (device constants, the
# exact lane reduction): one copy, shared with the RNS arm (importing
# fq_rns also pins TF32 off for the matmuls below).
from hbbft_tpu_torch.ops.fq_rns import _device_of, _mod_lanes, _tensor, const, to_numpy
from hbbft_tpu_torch.utils.tree import associative_scan

BITS = int(os.environ.get("HBBFT_TPU_FQ_BITS", "8"))
if BITS != 8:
    raise NotImplementedError(
        f"HBBFT_TPU_FQ_BITS={BITS}: the port carries only the 8-bit float32 "
        "limb width (the 11-bit int32 width is queued in ROADMAP.md)"
    )
NLIMBS = 50  # 50·8 = 400 bits capacity; values stay below 2^396
FOLD_FROM = 48  # 2^(8·48) = 2^384 > Q ≈ 2^381.4
DTYPE = torch.float32
NP_DTYPE = np.float32
BASE = 1 << BITS
CONV = 2 * NLIMBS - 1
_INV_BASE = 1.0 / BASE  # exact power of two


def _int_to_limbs(x: int) -> np.ndarray:
    """Canonical little-endian limb decomposition of a non-negative int
    (8-bit limbs are its bytes)."""
    if x < 0:
        raise ValueError("canonical limbs are non-negative")
    return np.frombuffer(x.to_bytes(NLIMBS, "little"), dtype=np.uint8).astype(NP_DTYPE)


#: FOLD_ROWS[j] = canonical limbs of 2^(8·(FOLD_FROM+j)) mod Q: replaces the
#: limb at position FOLD_FROM+j by its mod-Q equivalent.  (51, 50)
FOLD_ROWS = np.stack(
    [_int_to_limbs(pow(1 << BITS, FOLD_FROM + j, Q)) for j in range(CONV - FOLD_FROM)]
)

Q_LIMBS = _int_to_limbs(Q)
ZERO = np.zeros(NLIMBS, dtype=NP_DTYPE)
ONE = _int_to_limbs(1)


# -- host <-> device conversion ----------------------------------------------


def from_int(x: int) -> np.ndarray:
    """Canonical limb vector for x (reduced mod Q first)."""
    return _int_to_limbs(x % Q)


def from_ints(xs) -> np.ndarray:
    """Stack of canonical limb vectors, shape (len(xs), 50), converting
    each distinct value once (whole-network batches repeat coordinates)."""
    xs = [int(x) for x in xs]
    uniq: dict = {}
    vals: List[int] = []
    idx = np.empty(len(xs), dtype=np.int64)
    for j, x in enumerate(xs):
        pos = uniq.get(x)
        if pos is None:
            pos = uniq[x] = len(vals)
            vals.append(x % Q)
        idx[j] = pos
    raw = b"".join(v.to_bytes(NLIMBS, "little") for v in vals)
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), NLIMBS)
    return rows.astype(NP_DTYPE)[idx]


def to_int(limbs) -> int:
    """Exact value of a (possibly lazy, negative-limbed) vector, mod Q."""
    val = 0
    ints = np.rint(to_numpy(limbs)).astype(np.int64).reshape(-1).tolist()
    for limb in reversed(ints):
        val = (val << BITS) + limb
    return val % Q


def to_ints(batch) -> list:
    arr = to_numpy(batch)
    if arr.ndim == 1:
        return [to_int(arr)]
    return [to_int(row) for row in arr]


# -- constants on a device -----------------------------------------------------

_NZ_NPRIMES = 40


def _probe_primes(limit: int, count: int) -> List[int]:
    out: List[int] = []
    x = limit
    while len(out) < count and x > 2:
        x -= 1
        if all(x % d for d in range(2, int(x**0.5) + 1)):
            out.append(x)
    return out


# In-graph zero test (see is_zero).  Residue weights w[i, j] = 2^(8i) mod
# p_j for 40 probe primes < 1300 (product ≈ 2^407), and the quotient
# estimate weights 2^(8i)/Q.
_NZ_P = np.array(_probe_primes(1300, _NZ_NPRIMES), dtype=np.int64)
_NZ_W = np.array(
    [[pow(BASE, i, int(p)) for p in _NZ_P] for i in range(NLIMBS)], dtype=np.float32
)
_NZ_QMOD = np.array([Q % int(p) for p in _NZ_P], dtype=np.float32)
_NZ_EST = np.array([float(1 << (BITS * i)) / float(Q) for i in range(NLIMBS)],
                   dtype=np.float32)
# The residue matmul accumulates post-carry limbs (≤ 257) times weights
# (< 1297) over 50 limbs in float32: exact only because the sum stays
# below 2^24 (only just).
assert NLIMBS * (BASE + 1) * (int(_NZ_P[0]) - 1) < (1 << 24), (
    "residue-probe matmul would exceed the f32-exact envelope"
)

_NP_CONSTS = {
    "fold": FOLD_ROWS,
    "nz_w": _NZ_W,
    "nz_p": _NZ_P.astype(np.float32),
    "nz_invp": (1.0 / _NZ_P).astype(np.float32),
    "nz_qmod": _NZ_QMOD,
    "nz_est": _NZ_EST,
    "one": ONE,
}
_DEV_CONSTS: dict = {}


def _consts(device) -> dict:
    """The module's constant tables as tensors on ``device`` (cached)."""
    key = torch.device(device)
    c = _DEV_CONSTS.get(key)
    if c is None:
        c = _DEV_CONSTS[key] = {k: torch.as_tensor(v, device=key) for k, v in _NP_CONSTS.items()}
    return c


# -- core ops ------------------------------------------------------------------


def carry3(x) -> torch.Tensor:
    """Three carry passes: limbs land in [-1, 257]; the top limb keeps
    every incoming carry and is never split."""
    x = x.to(DTYPE)
    for _ in range(3):
        hi = torch.floor(x * _INV_BASE)
        lo = torch.cat([x[..., :-1] - hi[..., :-1] * BASE, x[..., -1:]], dim=-1)
        x = lo + F.pad(hi[..., :-1], (1, 0))
    return x


def fold(c: torch.Tensor) -> torch.Tensor:
    """Replace the limbs ≥ FOLD_FROM through the mod-Q rows: (…, k) limbs
    in, (…, 50) out (k = 99 after a convolution, 50 to tidy up)."""
    rows = _consts(c.device)["fold"][: c.shape[-1] - FOLD_FROM]
    return F.pad(c[..., :FOLD_FROM], (0, NLIMBS - FOLD_FROM)) + c[..., FOLD_FROM:] @ rows


def reduce_small(x) -> torch.Tensor:
    """Renormalize a 50-limb vector whose limbs grew (adds, scalars)."""
    return carry3(fold(carry3(x)))


def add(a, b):
    """Lazy add: no carry (mul/carry3 downstream absorb the growth)."""
    return a + b


def sub(a, b):
    """Lazy subtract: limbs may go negative."""
    return a - b


def neg(a):
    return -a


def select(cond: torch.Tensor, a, b) -> torch.Tensor:
    dev = _device_of(cond, a, b)
    return torch.where(cond[..., None], _tensor(a, dev), _tensor(b, dev))


def mul(a, b) -> torch.Tensor:
    """Full product and reduction; lazy inputs are renormalized first.
    One ``fq_limb_mul`` launch on the card."""
    from hbbft_tpu_torch.ops import fq_limb_cuda

    dev = _device_of(a, b)
    return fq_limb_cuda.mul(_tensor(a, dev), _tensor(b, dev))


def sqr(a) -> torch.Tensor:
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
    return list(mul(A, B).unbind(0))


def mul_small(a, k: int) -> torch.Tensor:
    """Multiply by a small int, |k| < 2^15: the carried limbs (≤ 257)
    times k stay inside the float32 exact envelope (257·2^15 < 2^24)."""
    if not -(1 << 15) < k < (1 << 15):
        raise ValueError("|k| must be < 2^15")
    return reduce_small(carry3(a) * float(k))


def pow_fixed(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent for a fixed Python-int exponent: the whole
    square-and-multiply chain is one ``fq_limb_pow`` launch on the card."""
    from hbbft_tpu_torch.ops import fq_limb_cuda

    if exponent < 0:
        raise ValueError("exponent must be >= 0")
    if exponent == 0:
        return const(ONE, x.device).expand(x.shape)
    return fq_limb_cuda.pow_fixed(x, exponent)


def inv(x: torch.Tensor) -> torch.Tensor:
    """Fermat inverse x^(Q−2)."""
    return pow_fixed(x, Q - 2)


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse of every element along axis 0 with ONE Fermat inverse
    (prefix/suffix products by parallel scan, Montgomery's trick)."""
    prefix = associative_scan(mul, x)
    suffix = associative_scan(mul, x, reverse=True)
    tinv = inv(prefix[-1])
    one = const(ONE, x.device).expand(x[:1].shape)
    pre = torch.cat([one, prefix[:-1]], dim=0)
    suf = torch.cat([suffix[1:], one], dim=0)
    return mul(mul(pre, suf), tinv.expand(x.shape))


def is_zero_host(limbs) -> bool:
    return to_int(limbs) == 0


# -- in-graph zero test (complete-add route selector; ops/curve.py) -------------
#
# The lazy representation has no canonical form, so v ≡ 0 (mod Q) is no
# limb compare.  After reduce_small, |v| < 2·(BASE+2)·Q, so the quotient
# lies in m_est + c, c ∈ {−2..2}, with m_est the rounded float32 estimate
# Σ l_i·2^(8i)/Q.  Then v ≡ 0 iff v = m·Q for a candidate m iff the exact
# residues y_j = Σ_i l_i·(2^(8i) mod p_j) match m·(Q mod p_j) mod p_j for
# every probe prime — sound because |v − m·Q| < Π p_j.  A wrong estimate
# only fails the residue check; the ±2 window keeps every true zero.


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """Exact test: does the limb vector represent 0 mod Q?  Bool over the
    batch shape; any lazy input in the representation's domain."""
    c = _consts(x.device)
    x = reduce_small(x)
    m0 = torch.round(x @ c["nz_est"])
    p, invp, qmod = c["nz_p"], c["nz_invp"], c["nz_qmod"]
    y = _mod_lanes(x @ c["nz_w"], p, invp)
    hit = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    for k in (-2, -1, 0, 1, 2):
        # (m0+k)·qmod ≤ ~600·1300 < 2^20: exact before the reduction
        r = y - _mod_lanes((m0 + k)[..., None] * qmod, p, invp)
        hit = hit | torch.all(r == 0, dim=-1)
    return hit
