"""The port's G1/G2 curve layer against the JAX package's, on canonical
readback (exact), plus the host-side scalar preparation.

Shapes: three lanes per ladder.  The G1 GLV and G2 GLS ladders include
the crafted collision inputs of tests/test_glv_degenerate.py, which drive
the complete add's doubling and infinity routes; the 64-bit w2 ladder is
the RLC group check's (G, k) linear combination.  The JAX reference runs
jitted on XLA:CPU — four graphs: the two joint-table ladders, the (G, k)
RLC combine, and jac_to_affine for both groups.
"""

import random

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import bls381 as gold
from hbbft_tpu.crypto.field import R
from hbbft_tpu.ops import curve as JC, fq as JF, tower as JT
from hbbft_tpu_torch.ops import curve as TC, fq as TF, tower as TT
from hbbft_tpu_torch.utils.tree import tree_map

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

RNG = random.Random(404)
LAM = JC._G1_LAM
U = JC._G2_U
P1 = gold.ec_mul(gold.FQ, RNG.randrange(1, R), gold.G1_GEN)
P2 = gold.ec_mul(gold.FQ, RNG.randrange(1, R), gold.G1_GEN)
Q1 = gold.ec_mul(gold.FQ2, RNG.randrange(1, R), gold.G2_GEN)


# -- host-side preparation (pure Python on both sides) -----------------------

SCALARS = [0, 1, 2, R - 1, R - 2, (1 << 254) - 1, 1 << 254] + [
    RNG.randrange(R) for _ in range(25)
]


@pytest.mark.parametrize("k", SCALARS[:12])
def test_decompositions_equal_the_reference(k):
    assert TC.glv_decompose_g1(k) == JC.glv_decompose_g1(k)
    assert TC.gls_decompose_g2(k) == JC.gls_decompose_g2(k)


def test_prep_and_bit_matrices_equal_the_reference():
    for prep in ("prep_g1_scalars", "prep_g2_scalars"):
        pb, pn = getattr(TC, prep)(SCALARS)
        rb, rn = getattr(JC, prep)(SCALARS)
        assert np.array_equal(pb, rb) and np.array_equal(pn, rn)
        assert pb.dtype == rb.dtype
    small = [RNG.randrange(1 << 64) for _ in range(9)]
    assert np.array_equal(TC.scalars_to_bits(small, 64), JC.scalars_to_bits(small, 64))
    with pytest.raises(ValueError):
        TC.scalars_to_bits([1 << 64], 64)


def test_field_mul_accounting_equals_the_reference():
    for bits, glv in (
        (JC.prep_g1_scalars(SCALARS[:3])[0], True),
        (JC.prep_g2_scalars(SCALARS[:3])[0], True),
        (JC.scalars_to_bits(SCALARS[:3]), False),
        (JC.scalars_to_bits([5, 6], 64), False),
    ):
        assert TC.ladder_scan_field_muls(bits, glv) == JC.ladder_scan_field_muls(bits, glv)
        if glv:
            assert TC.glv_table_field_muls(bits) == JC.glv_table_field_muls(bits)


# -- device conversion ---------------------------------------------------------


def test_point_conversion_roundtrip():
    pts = [P1, None, P2]
    port = TC.g1_to_device(pts, device="cpu")
    ref = JC.g1_to_device(pts)
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy(), np.asarray(r))
    assert TC.g1_from_device(port) == pts
    qs = [Q1, None]
    port2 = TC.g2_to_device(qs, device="cpu")
    assert TC.g2_from_device(port2) == JC.g2_from_device(JC.g2_to_device(qs)) == qs


# -- ladders -------------------------------------------------------------------


def _g1_glv_case():
    """Lane 0: random scalar; lanes 1-2: the crafted doubling (6·P) and
    infinity (r·P) routes of tests/test_glv_degenerate.py."""
    k = RNG.randrange(R)
    bits, negs = JC.prep_g1_scalars([k])
    crafted = JC.scalars_to_bits([7, LAM + 1, 1, LAM + 1], JC.GLV_HALF_BITS)
    bits = np.concatenate([bits, crafted.reshape(2, 2, JC.GLV_HALF_BITS)])
    negs = np.concatenate([negs, np.zeros((2, 2), dtype=bool)])
    want = [gold.ec_mul(gold.FQ, k, P1), gold.ec_mul(gold.FQ, 6, P1), None]
    return [P1, P1, P1], bits, negs, want


def _g2_gls_case():
    """Lane 0: random scalar; lane 1: the crafted doubling route
    (quarters (3, 0, 3, |u|), signs (+, +, −, −)) → (2 − 2u²)·Q."""
    k = RNG.randrange(R)
    bits, negs = JC.prep_g2_scalars([k])
    crafted = JC.scalars_to_bits([3, 0, 3, abs(U)], JC.GLS_QUARTER_BITS)
    bits = np.concatenate([bits, crafted.reshape(1, 4, JC.GLS_QUARTER_BITS)])
    negs = np.concatenate([negs, np.array([[False, False, True, True]])])
    want = [gold.ec_mul(gold.FQ2, k, Q1), gold.ec_mul(gold.FQ2, (2 - 2 * U * U) % R, Q1)]
    return [Q1, Q1], bits, negs, want


def test_g1_glv_ladder_with_collision_routes():
    pts, bits, negs, want = _g1_glv_case()
    got = TC.g1_from_device(
        TC.g1_scalar_mul_signed(TC.g1_to_device(pts, device="cpu"), bits, negs)
    )
    ref = JC.g1_from_device(
        jax.jit(JC.g1_scalar_mul_signed)(JC.g1_to_device(pts), bits, negs)
    )
    assert got == ref == want


def test_g2_gls_ladder_with_collision_route():
    pts, bits, negs, want = _g2_gls_case()
    got = TC.g2_from_device(
        TC.g2_scalar_mul_signed(TC.g2_to_device(pts, device="cpu"), bits, negs)
    )
    ref = JC.g2_from_device(
        jax.jit(JC.g2_scalar_mul_signed)(JC.g2_to_device(pts), bits, negs)
    )
    assert got == ref == want


def test_rlc_linear_combine_g1_and_jac_to_affine():
    """The RLC group check's shape: (G=2, k=3) points with 64-bit
    coefficients (classic w2 ladder, tree sum over k, one padding lane of
    ∞ with scalar 0), then jac_to_affine_g1 — both on the same inputs."""
    G, K = 2, 3
    pts = [P1, P2, None, P2, P1, P1]
    ks = [RNG.randrange(1, 1 << 64) for _ in range(G * K)]
    ks[2] = 0
    bits = JC.scalars_to_bits(ks, 64).reshape(G, K, 64)
    negs = np.zeros((G, K), dtype=bool)

    port_pts = tree_map(lambda c: c.reshape((G, K) + tuple(c.shape[1:])),
                        TC.g1_to_device(pts, device="cpu"))
    comb = TC.linear_combine_g1(port_pts, torch.as_tensor(bits), torch.as_tensor(negs))
    port_jac = tree_map(lambda c: c[:, 0], comb)
    port_aff = TC.jac_to_affine_g1(port_jac)

    def ref_fn(P, b, n):
        c = jax.vmap(JC.linear_combine_g1)(P, b, n)
        jac = jax.tree_util.tree_map(lambda x: x[:, 0], c)
        return jac, JC.jac_to_affine_g1(jac)

    ref_pts = jax.tree_util.tree_map(
        lambda c: c.reshape((G, K) + c.shape[1:]), JC.g1_to_device(pts)
    )
    ref_jac, ref_aff = jax.jit(ref_fn)(ref_pts, bits, negs)

    want = []
    for g in range(G):
        acc = None
        for j in range(K):
            if pts[g * K + j] is not None:
                acc = gold.ec_add(gold.FQ, acc, gold.ec_mul(gold.FQ, ks[g * K + j], pts[g * K + j]))
        want.append(acc)
    assert TC.g1_from_device(port_jac) == JC.g1_from_device(ref_jac) == want
    # affine readback: x, y canonical and equal
    got_aff = [(TF.to_int(port_aff[0][i]), TF.to_int(port_aff[1][i])) for i in range(G)]
    ref_aff_ints = [
        (JF.to_int(np.asarray(ref_aff[0])[i]), JF.to_int(np.asarray(ref_aff[1])[i]))
        for i in range(G)
    ]
    assert got_aff == ref_aff_ints == want
    assert port_aff[2].tolist() == np.asarray(ref_aff[2]).tolist() == [False, False]


def test_linear_combine_g2_against_the_host_golden():
    """Σ ±k_i·Q_i over one group of three G2 points (64-bit coefficients,
    one negated, one ∞ lane), read back canonically."""
    qs = [Q1, None, gold.ec_mul(gold.FQ2, 3, Q1)]
    ks = [RNG.randrange(1, 1 << 64) for _ in qs]
    negs = np.array([[False, False, True]])
    bits = TC.scalars_to_bits(ks, 64).reshape(1, 3, 64)
    pts = tree_map(lambda c: c.reshape((1, 3) + tuple(c.shape[1:])),
                   TC.g2_to_device(qs, device="cpu"))
    comb = TC.linear_combine_g2(pts, torch.as_tensor(bits), torch.as_tensor(negs))
    got = TC.g2_from_device(tree_map(lambda c: c[:, 0], comb))
    want = gold.ec_add(
        gold.FQ2, gold.ec_mul(gold.FQ2, ks[0], qs[0]), gold.ec_mul(gold.FQ2, (R - ks[2]) % R, qs[2])
    )
    assert got == [want]


def test_jac_to_affine_g2_with_infinity():
    qs = [Q1, None, gold.ec_mul(gold.FQ2, 5, Q1)]
    P = TC.g2_to_device(qs, device="cpu")
    # doubling leaves Z ≠ 1, so the affine conversion has real work
    twice = TC.jac_double(TC._F2, P)
    port = TC.jac_to_affine_g2(twice)
    ref = jax.jit(lambda p: JC.jac_to_affine_g2(JC.jac_double(JC._F2, p)))(JC.g2_to_device(qs))
    got = [(TT.fq2_to_ints(port[0], i), TT.fq2_to_ints(port[1], i)) for i in range(3)]
    refv = [(JT.fq2_to_ints(ref[0], i), JT.fq2_to_ints(ref[1], i)) for i in range(3)]
    assert got == refv
    assert port[2].tolist() == [False, True, False]
    assert got[0] == gold.ec_double(gold.FQ2, Q1)
    assert got[1] == ((0, 0), (1, 0))  # infinity lanes read (0, 1)
