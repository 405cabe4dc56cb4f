"""The port's Fq2/Fq6/Fq12 tower against the JAX package's, on canonical
readback (exact).

Both sides take the same random elements (two lanes, one shared shape);
the JAX reference runs as ONE jitted function on XLA:CPU that returns
every operation under test, so the file compiles one graph.  Each result
is compared through ``fq12_to_ints_batch`` (or the fq2/fq6 readback) and
held against the pure-Python golden tower where that is cheap.
"""

import random

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import bls381 as gold
from hbbft_tpu.crypto.bls381 import BLS_X
from hbbft_tpu.crypto.field import Q
from hbbft_tpu.ops import tower as JT
from hbbft_tpu_torch.ops import tower as TT
from hbbft_tpu_torch.utils.tree import tree_map

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

LANES = 2


def _rnd_fq12(rng):
    return tuple(
        tuple((rng.randrange(Q), rng.randrange(Q)) for _ in range(3)) for _ in range(2)
    )


def _cyclotomic(f):
    """f^((Q⁶−1)(Q²+1)) on the golden side: an element of the cyclotomic
    subgroup, the domain of fq12_cyclo_sqr and the x-power chain."""
    m = gold.fq12_mul(gold.fq12_conj(f), gold.fq12_inv(f))
    m2 = m
    for _ in range(2):
        m2 = gold.fq12_pow(m2, Q)
    return gold.fq12_mul(m2, m)


RNG = random.Random(31)
XS = [_rnd_fq12(RNG) for _ in range(LANES)]
YS = [_rnd_fq12(RNG) for _ in range(LANES)]
CYC = [_cyclotomic(x) for x in XS]
LINE = [
    ((RNG.randrange(Q), RNG.randrange(Q)), (RNG.randrange(Q), RNG.randrange(Q)),
     (RNG.randrange(Q), RNG.randrange(Q)))
    for _ in range(LANES)
]


def _line_stack(lines):
    return tuple(TT.fq2_stack([ln[i] for ln in lines]) for i in range(3))


OPS = (
    "fq12_mul", "fq12_sqr", "fq12_inv", "fq12_mul_line", "fq12_frobenius",
    "fq12_frobenius_3", "fq12_cyclo_sqr", "fq12_cyclo_pow_x", "fq12_pow_fixed",
    "fq6_inv", "fq2_inv", "fq2_sqr", "batch_inv_fq2",
)


def _ops(T, a, b, c, line, fq2a, fq6a):
    """Every tower operation under test (the names in OPS), written once
    for both packages."""
    out = {
        "fq12_mul": T.fq12_mul(a, b),
        "fq12_sqr": T.fq12_sqr(a),
        "fq12_inv": T.fq12_inv(a),
        "fq12_mul_line": T.fq12_mul_line(a, line),
        "fq12_frobenius": T.fq12_frobenius(a),
        "fq12_frobenius_3": T.fq12_frobenius_n(a, 3),
        "fq12_cyclo_sqr": T.fq12_cyclo_sqr(c),
        "fq12_cyclo_pow_x": T.fq12_cyclo_pow_segmented(c, BLS_X),
        "fq12_pow_fixed": T.fq12_pow_fixed(a, 0b100101),
        "fq6_inv": T.fq6_inv(fq6a),
        "fq2_inv": T.fq2_inv(fq2a),
        "fq2_sqr": T.fq2_sqr(fq2a),
        "batch_inv_fq2": T.batch_inv_fq2(fq2a),
    }
    assert tuple(out) == OPS
    return out


def _inputs(T, to):
    a = tree_map(to, T.fq12_stack(XS))
    b = tree_map(to, T.fq12_stack(YS))
    c = tree_map(to, T.fq12_stack(CYC))
    line = tree_map(to, _line_stack(LINE))
    return a, b, c, line, a[0][1], a[1]


@pytest.fixture(scope="module")
def results():
    """(port, reference) results of every op, computed once."""
    port = _ops(TT, *_inputs(TT, lambda x: torch.as_tensor(np.asarray(x))))
    ref_fn = jax.jit(lambda *args: _ops(JT, *args))
    ref = ref_fn(*_inputs(JT, lambda x: jax.numpy.asarray(x)))
    return port, jax.tree_util.tree_map(np.asarray, ref)


def _readback(T, x):
    depth = 0
    node = x
    while isinstance(node, tuple):
        depth += 1
        node = node[0]
    if depth == 3:
        return T.fq12_to_ints_batch(x, LANES)
    if depth == 2:
        return [T.fq6_to_ints(x, i) for i in range(LANES)]
    return [T.fq2_to_ints(x, i) for i in range(LANES)]


_GOLDEN = {
    "fq12_mul": lambda i: gold.fq12_mul(XS[i], YS[i]),
    "fq12_sqr": lambda i: gold.fq12_sqr(XS[i]),
    "fq12_inv": lambda i: gold.fq12_inv(XS[i]),
    "fq12_frobenius": lambda i: gold.fq12_pow(XS[i], Q),
    "fq12_cyclo_sqr": lambda i: gold.fq12_sqr(CYC[i]),
    "fq12_pow_fixed": lambda i: gold.fq12_pow(XS[i], 0b100101),
    "fq6_inv": lambda i: gold.fq6_inv(XS[i][1]),
    "fq2_inv": lambda i: gold.fq2_inv(XS[i][0][1]),
    "fq2_sqr": lambda i: gold.fq2_sqr(XS[i][0][1]),
}


@pytest.mark.parametrize("name", OPS)
def test_op_matches_the_reference(results, name):
    port, ref = results
    got = _readback(TT, port[name])
    assert got == _readback(JT, ref[name])
    if name in _GOLDEN:
        assert got == [_GOLDEN[name](i) for i in range(LANES)]


def test_cyclo_pow_x_is_the_x_power(results):
    port, _ = results
    got = TT.fq12_to_ints_batch(port["fq12_cyclo_pow_x"], LANES)
    assert got == [gold.fq12_pow(c, BLS_X) for c in CYC]


def test_batch_inv_fq2_inverts_every_lane(results):
    port, _ = results
    got = _readback(TT, port["batch_inv_fq2"])
    assert got == [gold.fq2_inv(x[0][1]) for x in XS]


def test_conversions_roundtrip():
    a = TT.fq12_stack(XS)
    ja = JT.fq12_stack(XS)
    flat_p = [c for x6 in a for x2 in x6 for c in x2]
    flat_r = [c for x6 in ja for x2 in x6 for c in x2]
    assert all(np.array_equal(p, r) for p, r in zip(flat_p, flat_r))
    assert TT.fq12_to_ints_batch(tree_map(torch.as_tensor, a), LANES) == XS
    assert TT.fq12_to_ints(tree_map(torch.as_tensor, a), 1) == XS[1]
    one = TT.fq12_broadcast_one((3,), "cpu")
    assert TT.fq12_to_ints_batch(one, 3) == [gold.FQ12_ONE] * 3


def test_single_element_from_ints_equals_the_reference():
    port = [c for x6 in TT.fq12_from_ints(XS[0]) for x2 in x6 for c in x2]
    ref = [c for x6 in JT.fq12_from_ints(XS[0]) for x2 in x6 for c in x2]
    assert all(np.array_equal(p, np.asarray(r)) for p, r in zip(port, ref))
    one_lane = tree_map(lambda c: torch.as_tensor(c)[None], TT.fq12_from_ints(XS[0]))
    assert TT.fq12_to_ints(one_lane, 0) == XS[0]
