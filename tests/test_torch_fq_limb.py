"""The port's limb field against the JAX package's, limb for limb.

``hbbft_tpu_torch.ops.fq_limb`` (CPU tensors, i.e. the plain versions of
the ``fq_limb_*`` kernels) must give the SAME float32 limbs as
``hbbft_tpu.ops.fq_limb`` on XLA:CPU and as the Pallas kernels of
``hbbft_tpu.ops.fq_pallas`` in interpret mode.  Tolerance 0 everywhere:
every stage is exact integer float32 arithmetic.  The two exceptions are
representation-visible by design and compared canonically (mod Q): the
reference's XLA ``pow_fixed`` (it starts from ONE and re-carries before
each product, the Pallas kernel and the port do neither) and
``batch_inv`` (its scan order).

Also here, because they share the shape: the RNS chain kernel's plain
version against ``fq_rns_pallas.mul_chain`` (interpret mode), the FMA
probe's plain version against a numpy float32 run of the same
recurrence, and the port's kernel bench on the CPU at a tiny width.

One shared shape: 24 lanes built from 8 canonical values (0, 1, Q−1 and
random) — canonical rows, a dozen chained lazy adds, differences
(negative limbs), negations and small scalings.
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.field import Q
from hbbft_tpu.ops import fq_limb as JL, fq_pallas as JP, fq_rns as JR, fq_rns_pallas as JRP
from hbbft_tpu_torch import convert
from hbbft_tpu_torch.ops import fq, fq_limb as TL, fq_limb_cuda as TK, fq_rns_cuda, probe_cuda
from hbbft_tpu_torch.tools import kernel_bench

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)


def _lazy_stack(seed: int):
    rng = random.Random(seed)
    xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(5)]
    base = JL.from_ints(xs)
    chained = base[:4].copy()
    for k in range(11):  # a dozen chained lazy adds
        chained = chained + base[4 + k % 4 : 5 + k % 4]
    rows = [base, chained, base[:4] - base[4:], -base[:4], base[4:] * np.float32(3)]
    vals = xs + [(xs[i] + sum(xs[4 + k % 4] for k in range(11))) % Q for i in range(4)]
    vals += [(xs[i] - xs[4 + i]) % Q for i in range(4)] + [(-x) % Q for x in xs[:4]]
    vals += [3 * x % Q for x in xs[4:]]
    arr = np.concatenate(rows).astype(np.float32)
    assert arr.shape == (24, JL.NLIMBS) and arr.min() < 0
    return arr, vals


A_NP, A_VALS = _lazy_stack(1)
B_NP, B_VALS = _lazy_stack(2)


def _t(arr):
    return torch.as_tensor(np.array(arr, dtype=np.float32))


def _same(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape and p.dtype == r.dtype
    assert np.array_equal(p, r), f"max |port - ref| = {np.abs(p - r).max()}"


@pytest.fixture(scope="module")
def pallas_mul():
    return np.asarray(JP.mul(A_NP, B_NP, interpret=True))


def test_constants_equal_the_reference():
    assert (TL.NLIMBS, TL.FOLD_FROM, TL.BITS, TL.BASE, TL.CONV) == (
        JL.NLIMBS, JL.FOLD_FROM, JL.BITS, JL.BASE, JL.CONV)
    _same(TL.FOLD_ROWS, JL._FOLD_ROWS)
    for name in ("Q_LIMBS", "ZERO", "ONE"):
        _same(getattr(TL, name), getattr(JL, name))
    assert np.array_equal(TL._NZ_P, JL._NZ_P)
    for name in ("_NZ_W", "_NZ_QMOD", "_NZ_EST"):
        _same(getattr(TL, name), np.asarray(getattr(JL, name), dtype=np.float32))


def test_facade_keeps_the_limb_module():
    assert fq.IMPL == "rns" and fq.limb is TL
    assert (fq.BITS, fq.BASE) == (8, 256)


def test_host_conversion():
    xs = [0, 1, Q - 1, Q, Q + 5, 3 * Q + 7, 2**380, 12345] * 2
    _same(TL.from_ints(xs), JL.from_ints(xs))
    for x in xs[:8]:
        _same(TL.from_int(x), JL.from_int(x))
    assert TL.from_ints([]).shape == (0, TL.NLIMBS)
    assert TL.to_ints(_t(A_NP)) == JL.to_ints(A_NP) == A_VALS
    assert TL.to_int(_t(A_NP[9])) == A_VALS[9]
    t = convert.limbs(A_NP, device="cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), A_NP)
    with pytest.raises(ValueError):
        convert.limbs(np.zeros((2, 79)), device="cpu")


def test_carry_reduce_scale_select():
    _same(TL.carry3(_t(A_NP)), JL.carry3(A_NP))
    grown = A_NP * np.float32(200)  # limbs grown by scalars, |limb| < 2^24
    _same(TL.reduce_small(_t(grown)), JL.reduce_small(grown))
    for k in (2, 41, -77, 32767, -32767):
        _same(TL.mul_small(_t(A_NP), k), JL.mul_small(A_NP, k))
    with pytest.raises(ValueError):
        TL.mul_small(_t(A_NP), 1 << 15)
    cond = np.arange(24) % 3 == 0
    _same(TL.select(torch.as_tensor(cond), _t(A_NP), _t(B_NP)), JL.select(cond, A_NP, B_NP))
    _same(TL.add(_t(A_NP), _t(B_NP)), JL.add(A_NP, B_NP))
    _same(TL.sub(_t(A_NP), _t(B_NP)), JL.sub(A_NP, B_NP))
    _same(TL.neg(_t(A_NP)), JL.neg(A_NP))


def test_mul_equals_both_reference_paths(pallas_mul):
    got = TL.mul(_t(A_NP), _t(B_NP))
    _same(got, JL.mul(A_NP, B_NP))  # the XLA path
    _same(got, pallas_mul)  # the Pallas kernel, interpret mode
    _same(TK.mul_plain(_t(A_NP), _t(B_NP)), pallas_mul)
    assert TL.to_ints(got) == [x * y % Q for x, y in zip(A_VALS, B_VALS)]


def test_mul_n_sqr_and_broadcast():
    a, b = _t(A_NP), _t(B_NP)
    outs = TL.mul_n([(a, b), (b, b), (a, TL.ONE)])
    _same(outs[0], JL.mul(A_NP, B_NP))
    _same(outs[1], JL.sqr(B_NP))
    _same(outs[2], JL.mul(A_NP, np.broadcast_to(JL.ONE, A_NP.shape)))
    _same(TL.sqr(a), JL.sqr(A_NP))


@pytest.mark.parametrize("exponent", [1, Q - 2])
def test_pow_equals_the_pallas_kernel(exponent):
    got = TL.pow_fixed(_t(A_NP), exponent)
    _same(got, JP.pow_fixed(A_NP, exponent, interpret=True))
    _same(TK.pow_plain(_t(A_NP), exponent), got)
    assert TL.to_ints(got) == [pow(v, exponent, Q) for v in A_VALS]


@pytest.mark.parametrize("exponent", [3, Q - 2])
def test_pow_equals_the_xla_path_canonically(exponent):
    got = TL.pow_fixed(_t(B_NP), exponent)
    assert TL.to_ints(got) == JL.to_ints(JL.pow_fixed(B_NP, exponent))
    assert TL.to_ints(TL.inv(_t(B_NP[3:]))) == [pow(v, Q - 2, Q) for v in B_VALS[3:]]
    assert TL.to_ints(TL.pow_fixed(_t(B_NP), 0)) == [1] * 24
    with pytest.raises(ValueError):
        TL.pow_fixed(_t(B_NP), -1)


def test_batch_inv_canonically():
    keep = [1, 2, 5, 9, 14]  # nonzero values: canonical, chained, difference
    x = A_NP[keep]
    vals = [A_VALS[i] for i in keep]
    got = TL.batch_inv(_t(x))
    assert TL.to_ints(got) == JL.to_ints(JL.batch_inv(x)) == [pow(v, Q - 2, Q) for v in vals]


def test_is_zero_equals_the_reference():
    ql = JL.Q_LIMBS.astype(np.float32)
    one = JL.ONE.astype(np.float32)
    cases = [np.zeros(50, np.float32), ql, ql * 2, ql * 5, -ql * 3,
             ql + one, ql - one, ql * 2 + one, one, -one, A_NP[5] - A_NP[5],
             A_NP[9] + A_NP[13] - (A_NP[9] + A_NP[13]), A_NP[6] + A_NP[6] - A_NP[6]]
    z = np.stack(cases)
    got = TL.is_zero(_t(z)).numpy()
    assert got.tolist() == np.asarray(JL.is_zero(z)).tolist()
    assert got.tolist() == [True] * 5 + [False] * 5 + [True, True, False]
    assert TL.is_zero_host(_t(ql)) and not TL.is_zero_host(_t(one))


def test_cpu_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        TK.mul(torch.zeros((2, 79)), torch.zeros((2, 79)))
    with pytest.raises(ValueError):
        TK.pow_fixed(torch.zeros((2, 50)), 0)  # the kernel needs exponent >= 1
    meta = torch.empty((2, 50), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        TK.mul(meta, meta)
    with pytest.raises(ValueError):
        TK.pow_fixed(meta, 3)


@pytest.mark.parametrize("chain", [0, 3])
def test_rns_chain_plain_equals_the_pallas_kernel(chain):
    """fq_rns_chain's plain version, residue for residue, against
    ``fq_rns_pallas.mul_chain`` in interpret mode (the shape of
    tests/test_fq_rns_pallas.py)."""
    rng = random.Random(5)
    xs = [rng.randrange(Q) for _ in range(6)] + [0, Q - 1]
    ys = [rng.randrange(Q) for _ in range(6)] + [Q - 1, 1]
    a = JR.from_ints(xs)
    a = np.concatenate([a, a[:4] + a[4:], -a[:2] * np.float32(41)])
    b = JR.from_ints(ys)
    b = np.concatenate([b, b[4:] - b[:4], b[:2]])
    got = fq_rns_cuda.mul_chain_plain(_t(a), _t(b), chain)
    _same(got, JRP.mul_chain(a, b, chain, interpret=True))
    _same(fq_rns_cuda.mul_chain(_t(a), _t(b), chain), got)  # the CPU wrapper
    vx = JR.to_ints(a)
    vy = JR.to_ints(b)
    assert JR.to_ints(got.numpy()) == [x * pow(y, chain, Q) % Q for x, y in zip(vx, vy)]


def test_probe_plain_equals_numpy():
    x = np.random.default_rng(3).random((4, 8), dtype=np.float32)
    iters = 50
    a = [x * np.float32(s) for s in probe_cuda.STARTS]
    for _ in range(iters):
        a = [ak * np.float32(probe_cuda.RATE) + x for ak in a]
    want = a[0]
    for ak in a[1:]:
        want = want + ak
    got = probe_cuda.fma_probe(torch.as_tensor(x), iters)
    assert np.array_equal(got.numpy(), want)
    assert probe_cuda.fma_probe.launches == 0  # the CPU runs the plain version
    assert probe_cuda.flops(x.size, iters) == 2 * 8 * iters * 32
    # the derived bound at the reference's 2,000 steps
    assert 3.5e-4 < probe_cuda.rel_tolerance(probe_cuda.REF_ITERS) < 3.7e-4


def test_kernel_bench_on_the_cpu(capsys):
    res = kernel_bench.main(["--device", "cpu", "--lanes", "4", "--chain", "2",
                             "--probe-shape", "2x8", "--probe-iters", "5"])
    out = capsys.readouterr().out
    assert [r["kernel"] for r in res["rows"]] == ["fq_rns_mul", "fq_limb_mul", "fq_rns_chain"]
    assert all(r["lanes"] == 4 and r["ms"] > 0 and r["m_muls_per_s"] > 0 for r in res["rows"])
    assert res["probe"]["shape"] == [2, 8] and res["probe"]["tflops"] > 0
    assert "not a device metric" in res["card"]
    assert out.count("M muls/s") == 3 and "TFLOP/s" in out
    assert all(res["card"] in line for line in out.splitlines()[:-1])


def test_kernel_bench_launch_times_on_the_cpu(capsys):
    """``--launch``: one row per kernel with both timings, every line
    naming the device."""
    res = kernel_bench.main(["--device", "cpu", "--launch", "--launch-lanes",
                             "fq_rns_mul=5,miller_dbl=2,fq_limb_mul=5"])
    out = capsys.readouterr().out
    assert [(r["kernel"], r["lanes"]) for r in res["launch"]] == [
        ("fq_rns_mul", 5), ("miller_dbl", 2), ("fq_limb_mul", 5)]
    assert all(r["single"] > 0 and r["stream"] > 0 for r in res["launch"])
    assert "not a device metric" in res["card"]
    assert out.count("back to back") == 3
    assert all(res["card"] in line for line in out.splitlines()[:-1])


def test_kernel_bench_launches_the_limb_kernels():
    """``--launch``'s limb names call the limb wrappers (their plain
    versions on the CPU): fq_limb_mul on two rows, fq_limb_pow at Q−2;
    both are in the default widths, at the limb arm's mean launch widths."""
    rng = np.random.default_rng(3)
    cpu = torch.device("cpu")
    got = kernel_bench._launch_fn("fq_limb_mul", 3, rng, cpu)()
    assert got.shape == (3, JL.NLIMBS) and got.dtype == torch.float32
    rng = np.random.default_rng(4)
    x = kernel_bench._rows(rng, 1, JL.NLIMBS, cpu)
    got = kernel_bench._launch_fn("fq_limb_pow", 1, np.random.default_rng(4), cpu)()
    assert TL.to_ints(got) == [pow(TL.to_int(x[0]), Q - 2, Q)]
    assert kernel_bench.LAUNCH_LANES["fq_limb_mul"] == (35450,)
    assert kernel_bench.LAUNCH_LANES["fq_limb_pow"] == (14,)

