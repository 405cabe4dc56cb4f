"""Fused pairing chain: the verification graph on the fused tower kernels
(the JAX package's ``ops/pairing_chain.py``).

The orchestration over ``ops/tower_fused.py`` — the Miller loop, product
merge and final exponentiation of ``ops/pairing.py`` rebuilt so that the
heavy tower arithmetic runs inside the fused kernels:

* ``miller_loop_fused``: a host loop over the 63 bits of |x| whose body
  launches the fused double-step kernel on a packed carry (f (12, W, 79),
  R (6, W, 79)).  The addition step (5 of 63 bits) stays the stacked
  ``pairing._miller_add_step`` on the unpacked coefficients.
* ``final_exponentiation_fast_fused``: the easy part stays stacked (it
  needs the Fermat inverse, the ``fq_rns_pow`` kernel); the whole hard
  part is ONE ``tower_fused.hard_exp`` launch.
* ``product2_fast_fused``: ``pairing.miller_product`` (one merge policy,
  ``HBBFT_TPU_NO_MERGE`` included) over the fused loop, with cross-pair
  merges on the fused fq12_mul.

Every kernel repeats the exact recombination of ops/tower.py on the
shared Montgomery core, so represented values equal the stacked graph's
(the tests compare canonical readback), and ``HBBFT_TPU_NO_FUSED_TOWER=1``
restores the stacked graph.

Analytic dispatch model (the reference's, kept under its names).  Per
merged 2-pair verification graph the stacked composition launches one
``fq_rns_mul`` per stacked round —

    63 doubles × 4 rounds + 5 adds × 11 rounds     = 307   (Miller)
    1 cross-pair merge                             = 1
    ~12 rounds easy part                           = 12
    5 chains × (63×2 rounds/sqr + ~6 set-bit muls) = 660   (hard part)

while the fused chain launches 63 ``miller_dbl`` kernels + the same 55
add rounds + 1 merge (``tower_op``) + the same ~12 easy rounds + ONE
``hard_exp`` kernel.  ``analytic_pallas_calls`` counts these launches of
the port's kernels (the name is the reference's, so the counterpart is
easy to find); the elementwise PyTorch ops between them are not counted.
"""

from __future__ import annotations


import torch

from hbbft_tpu_torch.crypto.bls381 import BLS_X_IS_NEG
from hbbft_tpu_torch.ops import pairing, tower
from hbbft_tpu_torch.ops import tower_fused as tf
from hbbft_tpu_torch.ops.tower_fused import fused_tower_mode


def resolve_mode(fused=None) -> bool:
    """Normalize a per-call routing override: ``None`` consults the kill
    switch (``tower_fused.fused_tower_mode``), ``False`` forces the
    stacked graph, anything else truthy forces the fused chain."""
    if fused is None:
        return fused_tower_mode()
    return bool(fused)


# ---------------------------------------------------------------------------
# Analytic dispatch/throughput model (see module docstring for derivation)
# ---------------------------------------------------------------------------

_N_BITS = len(pairing._X_BITS)  # 63
_N_ADDS = sum(pairing._X_BITS)  # 5 set bits of |x| below the MSB
_DBL_ROUNDS = 4  # pairing._miller_double_step stacked multiplies
_ADD_ROUNDS = 11  # _line_add 5 + jac_add 5 + fq12_mul_line 1
_EASY_ROUNDS = 12  # conj-free: inv (~10 stacked rounds) + frob² + mul
_CHAIN_ROUNDS = 5 * (2 * _N_BITS + 6)  # 5 chains; cyclo sqr = mul+reduce
_HARD_GLUE_ROUNDS = 10  # b/y3/y1/y0 muls, m3, 3 frobenius, 2 final muls

#: Fq multiplies inside one fused double-step launch (48+18+7+45 lanes).
DBL_FIELD_MULS = 118
#: Fq multiplies the reference's hard-part kernel runs per lane: 5·63 loop
#: steps of cyclo-sqr (18+12 reduce) + branch-free blend multiply (54), 5
#: boundary glue multiplies, and the m3/y0/frobenius/final tail.  The
#: port's kernel branches on the bit instead of blending, so it runs
#: ``tower_fused.analytic_hard_field_muls()`` of them.
HARD_FIELD_MULS = 5 * _N_BITS * (30 + 54) + 5 * 54 + 84 + 54 + 54 + 108 + 54


def analytic_pallas_calls(n_pairs: int = 2, fused: bool = False) -> int:
    """Kernel launches per verification graph (merged Miller), of the
    port's kernels: ``fq_rns_mul``/``fq_rns_pow`` per stacked round, plus
    ``miller_dbl``, ``tower_op`` and ``hard_exp`` on the fused chain."""
    shared = _N_ADDS * _ADD_ROUNDS + (n_pairs - 1) + _EASY_ROUNDS
    if fused:
        return _N_BITS + shared + 1  # dbl launches + add/easy/merge + hard
    return _N_BITS * _DBL_ROUNDS + shared + _CHAIN_ROUNDS + _HARD_GLUE_ROUNDS


def analytic_chain_field_muls(n_items: int, n_pairs: int = 2) -> int:
    """Fq multiplies executed INSIDE the fused kernels for ``n_items``
    verifications, in the reference's count (blend multiplies included)."""
    per_item = n_pairs * _N_BITS * DBL_FIELD_MULS + (n_pairs - 1) * 54
    return n_items * (per_item + HARD_FIELD_MULS)


# ---------------------------------------------------------------------------
# Fused Miller loop
# ---------------------------------------------------------------------------


def miller_loop_fused(P, Qa):
    """``pairing.miller_loop`` with the doubling step on the fused kernel.

    The carry stays packed (f (12, W, 79), R (6, W, 79)) so the dominant
    path — 63 doubling steps — is one kernel launch per bit with no
    relayout; only the 5 set-bit addition steps unpack for the stacked
    ``_miller_add_step`` and pack again."""
    xP, yP, infP = P
    xQ, yQ, infQ = Qa
    shape = tuple(xP.shape)
    batch_shape = shape[:-1]
    dev = xP.device

    one2 = tower.fq2_broadcast(tower.FQ2_ONE, batch_shape, dev)
    inf0 = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    Qj = (xQ, yQ, one2, inf0)

    p_rows = tf.pack((xP, yP), shape)
    f_rows = tf.pack(tower.fq12_broadcast_one(batch_shape, dev), shape)
    r_rows = tf.pack(((xQ, yQ), one2), shape)

    for bit in pairing._X_BITS:
        f_rows, r_rows = tf.miller_double_step_rows(f_rows, r_rows, p_rows)
        if bit:
            f = tf.unpack(f_rows, shape)
            c = [x.reshape(shape) for x in r_rows.unbind(0)]
            Rj = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]), inf0)
            f2, R2 = pairing._miller_add_step(f, Rj, Qa, Qj, xP, yP)
            f_rows = tf.pack(f2, shape)
            r_rows = tf.pack((R2[0], R2[1], R2[2]), shape)

    f = tf.unpack(f_rows, shape)
    if BLS_X_IS_NEG:
        f = tower.fq12_conj(f)
    neutral = infP | infQ
    return tower.fq12_select(neutral, tower.fq12_broadcast_one(batch_shape, dev), f)


def final_exponentiation_fast_fused(f):
    """``pairing.final_exponentiation_fast`` with the hard part as ONE
    kernel launch.  The easy part stays stacked (it needs the Fermat
    inverse, which rides the ``fq_rns_pow`` kernel)."""
    m = tower.fq12_mul(tower.fq12_conj(f), tower.fq12_inv(f))
    m = tower.fq12_mul(tower.fq12_frobenius_n(m, 2), m)
    return tf.hard_exp(m)


def product2_fast_fused(P1, Q1, P2, Q2):
    """Fused-chain ``pairing.product2_fast`` — same represented values."""
    f = pairing.miller_product([(P1, Q1), (P2, Q2)], miller_loop_fused, tf.fq12_mul)
    return final_exponentiation_fast_fused(f)
