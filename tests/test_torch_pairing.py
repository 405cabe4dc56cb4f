"""The port's pairing (stacked composition) against the JAX package's, on
canonical fq12 readback (exact).

One shared shape: four lanes, one per verification equation the backend
checks (ops/backend.py:10-16 of the JAX package), each written as
e(a1, b1) == e(a2, b2) and evaluated as FE_fast(ML(a1, b1)·ML(−a2, b2)):

* sig share:   e(G1, σ_i) == e(PK_i, H2(doc))
* full sig:    e(G1, σ)   == e(PK, H2(msg))
* dec share:   e(D_i, H)  == e(PK_i, W)
* ciphertext:  e(G1, W)   == e(U, H)

once with valid values and once with a forgery in every lane.  The JAX
reference is one jitted graph (Miller product and product2_fast).
"""

import random

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import bls381 as gold
from hbbft_tpu.crypto.field import R
from hbbft_tpu.ops import pairing as JP, tower as JT
from hbbft_tpu_torch.ops import pairing as TP, tower as TT

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

RNG = random.Random(5150)


def _quads(forged: bool):
    g1, g2 = gold.G1_GEN, gold.G2_GEN
    bls = gold.BLS381Group()
    sk_i, sk, r = (RNG.randrange(1, R) for _ in range(3))
    other = RNG.randrange(1, R)
    h_doc = bls.hash_to_g2(b"coin round 7")
    h_msg = bls.hash_to_g2(b"batch of epoch 3")
    u = gold.ec_mul(gold.FQ, r, g1)
    h_ct = bls.hash_to_g2(bls.g1_to_bytes(u) + b"payload")
    w = gold.ec_mul(gold.FQ2, r, h_ct)
    pk_i = gold.ec_mul(gold.FQ, sk_i, g1)
    bad = other if forged else None
    sig_i = gold.ec_mul(gold.FQ2, bad or sk_i, h_doc)
    sig = gold.ec_mul(gold.FQ2, bad or sk, h_msg)
    d_i = gold.ec_mul(gold.FQ, bad or sk_i, u)
    w_ct = gold.ec_mul(gold.FQ2, bad or r, h_ct)
    return [
        (g1, sig_i, pk_i, h_doc),
        (g1, sig, gold.ec_mul(gold.FQ, sk, g1), h_msg),
        (d_i, h_ct, pk_i, w),
        (g1, w_ct, u, h_ct),
    ]


def _operands(P, quads, **kw):
    return (
        P.g1_affine_to_device([q[0] for q in quads], **kw),
        P.g2_affine_to_device([q[1] for q in quads], **kw),
        P.g1_affine_to_device([gold.ec_neg(gold.FQ, q[2]) for q in quads], **kw),
        P.g2_affine_to_device([q[3] for q in quads], **kw),
    )


def _ref_fn(P1, Q1, P2, Q2):
    return (
        JP.miller_product([(P1, Q1), (P2, Q2)]),
        JP.product2_fast(P1, Q1, P2, Q2, fused=False),
    )


_REF = jax.jit(_ref_fn)


@pytest.fixture(scope="module", params=["valid", "forged"])
def case(request):
    quads = _quads(request.param == "forged")
    port_ops = _operands(TP, quads, device="cpu")
    ref_ml, ref_f = _REF(*_operands(JP, quads))
    return {
        "forged": request.param == "forged",
        "port_ml": TP.miller_product([(port_ops[0], port_ops[1]), (port_ops[2], port_ops[3])]),
        "port_f": TP.product2_fast(*port_ops),
        "ref_ml": ref_ml,
        "ref_f": ref_f,
    }


def test_operands_equal_the_reference():
    quads = _quads(False)
    for p, r in zip(_operands(TP, quads, device="cpu"), _operands(JP, quads)):
        for pl, rl in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(r)):
            assert np.array_equal(pl.numpy(), np.asarray(rl))


def test_miller_product_matches(case):
    assert TT.fq12_to_ints_batch(case["port_ml"], 4) == JT.fq12_to_ints_batch(case["ref_ml"], 4)


def test_product2_fast_matches(case):
    got = TT.fq12_to_ints_batch(case["port_f"], 4)
    assert got == JT.fq12_to_ints_batch(case["ref_f"], 4)


def test_verdicts(case):
    want = [not case["forged"]] * 4
    assert TP.is_one_host_batch(case["port_f"], 4) == want
    assert [TP.is_one_host(case["port_f"], i) for i in range(4)] == want
    assert [bool(v) for v in JP.is_one_host_batch(case["ref_f"], 4)] == want


def test_infinity_inputs_give_one():
    P = TP.g1_affine_to_device([None, gold.G1_GEN], device="cpu")
    Q = TP.g2_affine_to_device([gold.G2_GEN, None], device="cpu")
    f = TP.miller_loop(P, Q)
    assert TT.fq12_to_ints_batch(f, 2) == [gold.FQ12_ONE] * 2
    assert isinstance(f[0][0][0], torch.Tensor)
