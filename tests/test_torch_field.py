"""The port's RNS field against the JAX package's, residue for residue.

``hbbft_tpu_torch.ops.fq_rns`` (CPU tensors) must produce the SAME float32
residues as ``hbbft_tpu.ops.fq_rns`` on XLA:CPU, and the plain versions of
the two CUDA kernels (``fq_rns_cuda.mul_plain`` / ``pow_plain``) the same
residues as the Pallas kernels they replace (``fq_rns_pallas`` in
interpret mode).  Tolerance 0 everywhere: every stage is exact integer
float32 arithmetic, so any difference is a bug.

One shared shape: a lazy-domain stack of 24 lanes built from 8 canonical
values — canonical rows, sums, differences, negations and scalings up to
the edge of the lazy bound (lanes near 2^24, values near 2^13·Q).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.field import Q
from hbbft_tpu.ops import fq_rns as JR, fq_rns_pallas as JK
from hbbft_tpu_torch.ops import fq, fq_rns as TR, fq_rns_cuda as TK

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

#: scalings whose lanes stay below 2^24 (2047·8191) and whose values stay
#: inside the lazy bound 2^16·Q
_EDGE_K = (2, 41, 1000, 8191, -8191)


def _lazy_stack(seed: int):
    rng = random.Random(seed)
    xs = [rng.randrange(Q) for _ in range(8)]
    xs[0], xs[1] = 0, Q - 1
    base = JR.from_ints(xs)
    rows = [base, base[:4] + base[4:], base[:4] - base[4:], -base[:3]]
    vals = xs + [(xs[i] + xs[4 + i]) % Q for i in range(4)]
    vals += [(xs[i] - xs[4 + i]) % Q for i in range(4)] + [(-x) % Q for x in xs[:3]]
    for j, k in enumerate(_EDGE_K):
        rows.append(base[j + 2 : j + 3] * np.float32(k))
        vals.append(k * xs[j + 2] % Q)
    arr = np.concatenate(rows).astype(np.float32)
    assert arr.shape == (24, JR.NLIMBS) and np.abs(arr).max() < 2**24
    return arr, vals


A_NP, A_VALS = _lazy_stack(1)
B_NP, B_VALS = _lazy_stack(2)


def _t(arr):
    return torch.as_tensor(np.array(arr, dtype=np.float32))


def _same(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape and p.dtype == r.dtype
    assert np.array_equal(p, r), f"{int((p != r).sum())} residues differ"


# -- constants ---------------------------------------------------------------

_CONST_NAMES = (
    "B1", "B2", "M_R", "M1", "M2", "NLIMBS", "_X_OFFSET_INT", "_M2INV_R",
    "P_VEC", "_INV_P", "_M1INV_B2R", "_SIGMA_C_B1", "_QM1INV_B2R", "_W2INV_B2",
    "_M2_B1", "_E1_LO", "_E1_HI", "_E2_LO", "_E2_HI", "ZERO", "ONE", "_POW30",
    "_CRT_W_B1", "_W_LIMBS", "_Z_BOUND", "_Z_OFF_B1", "_Z_QINV_B1",
)


@pytest.mark.parametrize("name", _CONST_NAMES)
def test_constants_equal_the_reference(name):
    port, ref = getattr(TR, name), getattr(JR, name)
    if isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and np.array_equal(port, ref)
    else:
        assert port == ref


def test_kernel_constants_equal_the_pallas_layout():
    """The kernel's per-residue columns and split matrices are the Pallas
    kernel's (80, 16) / (80, 80) constants without its padding row."""
    keep = np.r_[0:39, 40:80]  # drop the pad row 39 of the (80, ·) layout
    c = JK._CONSTS
    assert np.array_equal(TK._P, c[keep, 0])
    assert np.array_equal(TK._IP, c[keep, 1])  # f32 1/p, as fq_rns_pallas.py:95
    assert np.array_equal(TK._XOFF, c[keep, 2])
    assert np.array_equal(TK._PB1R, c[:40, 7])
    assert np.array_equal(TK._IPB1R, c[:40, 8])
    em = JK._EMAT
    assert np.array_equal(TR._E1_LO.T, em[:40, :39])
    assert np.array_equal(TR._E1_HI.T, em[:40, 40:79])
    assert np.array_equal(TR._E2_LO.T, em[40:, :39])
    assert np.array_equal(TR._E2_HI.T, em[40:, 40:79])
    assert TK._M2INV_R == JK._M2INV_R


# -- host conversion ---------------------------------------------------------


def test_from_ints_to_ints_roundtrip():
    vals = A_VALS + [Q - 2, 1, 1]
    _same(TR.from_ints(vals), JR.from_ints(vals))
    assert TR.to_ints(_t(A_NP)) == JR.to_ints(A_NP) == A_VALS
    assert TR.to_int(_t(A_NP[5])) == JR.to_int(A_NP[5])
    _same(TR.from_int(7), JR.from_int(7))


# -- the XLA-path surface ----------------------------------------------------


def test_mul_lazy_edges():
    got = TR.mul(_t(A_NP), _t(B_NP))
    _same(got, JR.mul(jnp.asarray(A_NP), jnp.asarray(B_NP)))
    assert TR.to_ints(got) == [x * y % Q for x, y in zip(A_VALS, B_VALS)]


def test_mul_broadcast_sqr_and_mul_n():
    one_row = B_NP[7]
    _same(TR.mul(_t(A_NP), _t(one_row)), JR.mul(jnp.asarray(A_NP), jnp.asarray(one_row)))
    _same(TR.sqr(_t(A_NP)), JR.sqr(jnp.asarray(A_NP)))
    pairs_np = [(A_NP[:6], B_NP[:6]), (A_NP[6:12], B_NP[6:12]), (A_NP[12:18], one_row)]
    got = TR.mul_n([(_t(a), _t(b)) for a, b in pairs_np])
    want = JR.mul_n([(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs_np])
    for g, w in zip(got, want):
        _same(g, w)


def test_mul_body_on_carried_operands():
    ca, cb = JR.carry3(jnp.asarray(A_NP)), JR.carry3(jnp.asarray(B_NP))
    _same(TR.carry3(_t(A_NP)), ca)
    got = TR._mul_body(_t(ca), _t(cb))
    want = JR._mul_body(ca, cb)
    _same(got, want)
    # chained: every mul output is a valid _mul_body operand
    _same(TR._mul_body(got, got), JR._mul_body(want, want))


@pytest.mark.parametrize("k", [3, -5, 32767, -32767])
def test_mul_small_and_reduce_small(k):
    _same(TR.mul_small(_t(A_NP), k), JR.mul_small(jnp.asarray(A_NP), k))
    _same(TR.reduce_small(_t(A_NP) * k), JR.reduce_small(jnp.asarray(A_NP) * k))


def test_add_sub_neg_select():
    a, b = _t(A_NP), _t(B_NP)
    ja, jb = jnp.asarray(A_NP), jnp.asarray(B_NP)
    _same(TR.add(a, b), JR.add(ja, jb))
    _same(TR.sub(a, b), JR.sub(ja, jb))
    _same(TR.neg(a), JR.neg(ja))
    cond = np.arange(24) % 3 == 0
    _same(TR.select(torch.as_tensor(cond), a, b), JR.select(jnp.asarray(cond), ja, jb))


@pytest.mark.parametrize("exponent", [1, 2, 0b1011010111, Q - 2])
def test_pow_fixed_and_inv(exponent):
    rows = A_NP[2:10]
    got = TR.pow_fixed(_t(rows), exponent)
    _same(got, JR.pow_fixed(jnp.asarray(rows), exponent))
    assert TR.to_ints(got) == [pow(v, exponent, Q) for v in A_VALS[2:10]]
    if exponent == Q - 2:
        _same(TR.inv(_t(rows)), JR.inv(jnp.asarray(rows)))


def test_batch_inv():
    rows = A_NP[2:9]  # nonzero values
    got = TR.batch_inv(_t(rows))
    _same(got, JR.batch_inv(jnp.asarray(rows)))
    assert TR.to_ints(got) == [pow(v, Q - 2, Q) for v in A_VALS[2:9]]


def test_is_zero_inside_the_bound():
    a = _t(A_NP)
    z = torch.cat([a - a, a[:4] + _t(JR.from_ints([(-v) % Q for v in A_VALS[:4]])), a])
    jz = np.concatenate([A_NP - A_NP, np.asarray(z[24:28]), A_NP])
    got = TR.is_zero(z)
    assert got.tolist() == np.asarray(JR.is_zero(jnp.asarray(jz))).tolist()
    assert got[:28].all() and got[28:].tolist() == [v == 0 for v in A_VALS]
    assert TR.is_zero_host(a[0]) and not TR.is_zero_host(a[2])


def test_facade_binds_the_rns_field():
    assert fq.mul is TR.mul and fq.NLIMBS == JR.NLIMBS


# -- the kernels' plain versions against the Pallas kernels -------------------


def test_mul_plain_matches_the_pallas_kernel():
    want = JK.mul(jnp.asarray(A_NP), jnp.asarray(B_NP), interpret=True)
    _same(TK.mul_plain(_t(A_NP), _t(B_NP)), want)
    # the wrapper on CPU tensors is the plain version
    _same(TK.mul(_t(A_NP), _t(B_NP)), want)


def test_mul_plain_reduced_matches_mul_core():
    """reduced=True against _mul_core(reduced=True) on the kernel layout,
    with operands that are themselves kernel outputs."""
    a = np.asarray(JK.mul(jnp.asarray(A_NP), jnp.asarray(A_NP), interpret=True))
    b = np.asarray(JK.mul(jnp.asarray(B_NP), jnp.asarray(B_NP), interpret=True))
    lanes, tiles = JK._lane_count(a.shape)
    rows = JK._mul_core(
        JK._to_rows(jnp.asarray(a), lanes, tiles),
        JK._to_rows(jnp.asarray(b), lanes, tiles),
        jnp.asarray(JK._EMAT), jnp.asarray(JK._CONSTS), reduced=True,
    )
    want = JK._from_rows(rows, lanes, a.shape)
    _same(TK.mul_plain(_t(a), _t(b), reduced=True), want)


@pytest.mark.parametrize("exponent", [1, 0b1011010111, Q - 2])
def test_pow_plain_matches_the_pallas_kernel(exponent):
    rows = A_NP[:8]
    want = JK.pow_fixed(jnp.asarray(rows), exponent, interpret=True)
    _same(TK.pow_plain(_t(rows), exponent), want)
    _same(TK.pow_fixed(_t(rows), exponent), want)


def test_pow_plain_rejects_exponent_zero():
    with pytest.raises(ValueError):
        TK.pow_plain(_t(A_NP[:2]), 0)
