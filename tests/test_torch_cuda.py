"""Card-only checks of the port: each CUDA kernel against its plain
version (the field kernels of csrc/fq_rns.cu and the fused tower kernels
of csrc/tower_fused.cu), the fused chain against the stacked one, and the
backend on the card against the backend on the CPU.

They carry the ``cuda`` marker, need an NVIDIA GPU and skip without one
(the kernels have no CPU mode; their arithmetic is held against the JAX
package on the CPU by the other tests/test_torch_*.py files through the
plain versions).  On a machine with the card, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
card machine does not need.)
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K
from hbbft_tpu_torch.ops import tower_fused as TF, tower_fused_cuda as TK
from hbbft_tpu_torch.ops.backend import TorchBackend

pytestmark = pytest.mark.cuda  # registered in pyproject.toml


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    K.build()
    TK.build()
    return torch.device("cuda", 0)


def _lazy(rng, n):
    xs = [rng.randrange(Q) for _ in range(n)]
    base = R.from_ints(xs)
    rows = np.concatenate([base, base[: n // 2] + base[n // 2 :], -base[:3] * 41])
    vals = xs + [(xs[i] + xs[n // 2 + i]) % Q for i in range(n // 2)]
    vals += [(-41 * x) % Q for x in xs[:3]]
    return rows, vals


@pytest.mark.parametrize("reduced", [False, True])
def test_mul_kernel_equals_plain(dev, reduced):
    rng = random.Random(9)
    a_np, va = _lazy(rng, 666)  # 1002 lanes: a ragged last block
    b_np, vb = _lazy(rng, 666)
    a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
    if reduced:  # reduced operands are mul outputs
        a, b = K.mul_plain(a, a), K.mul_plain(b, b)
        va, vb = [x * x % Q for x in va], [y * y % Q for y in vb]
    n0 = K.mul.launches
    got = K.mul(a, b, reduced=reduced)
    torch.cuda.synchronize()
    assert K.mul.launches == n0 + 1
    assert torch.equal(got, K.mul_plain(a, b, reduced=reduced))
    assert R.to_ints(got) == [x * y % Q for x, y in zip(va, vb)]
    one = torch.as_tensor(R.from_int(5), device=dev)  # broadcast operand
    assert torch.equal(K.mul(a, one), K.mul_plain(a, one.expand_as(a)))


@pytest.mark.parametrize("exponent", [1, 2, 0b1011010111, Q - 2])
def test_pow_kernel_equals_plain(dev, exponent):
    rows, vals = _lazy(random.Random(10), 100)
    x = torch.as_tensor(rows, device=dev)
    got = K.pow_fixed(x, exponent)
    torch.cuda.synchronize()
    assert torch.equal(got, K.pow_plain(x, exponent))
    assert R.to_ints(got) == [pow(v, exponent, Q) for v in vals]


def test_field_routes_through_the_kernels(dev):
    rows, vals = _lazy(random.Random(11), 8)
    x = torch.as_tensor(rows, device=dev)
    K.reset_launches()
    inv = R.batch_inv(x)
    assert R.to_ints(inv) == [pow(v, Q - 2, Q) for v in vals]
    assert K.mul.launches > 0 and K.pow_fixed.launches == 1


def test_backend_on_the_card_matches_the_cpu(dev):
    rng = random.Random(12)
    cpu = TorchBackend(device="cpu")
    card = TorchBackend()
    sks = cpu.generate_key_set(1, rng)
    pks = sks.public_keys()
    cts = [pks.encrypt(b"card check %d" % i, rng) for i in range(3)]
    items = [
        (pks.public_key_share(i), cts[0],
         sks.secret_key_share(0 if i == 3 else i).decrypt_share_unchecked(cts[0]))
        for i in range(5)
    ]
    K.reset_launches()
    want = [True, True, True, False, True]
    assert card.verify_dec_shares(items) == cpu.verify_dec_shares(items) == want
    assert card.counters.device_dispatches == cpu.counters.device_dispatches
    assert card.verify_ciphertexts(cts) == [True] * 3
    for b in (cpu, card):
        b.device_combine_threshold = 2
    gen = [(sks.secret_key_share(i), ct) for ct in cts for i in range(3)]
    shares = card.decrypt_shares_batch(gen)
    assert shares == cpu.decrypt_shares_batch(gen)
    combs = [({i: shares[3 * c + i] for i in (0, 2)}, cts[c]) for c in range(3)]
    assert card.combine_dec_shares_batch(pks, combs) == [b"card check %d" % i for i in range(3)]
    assert K.mul.launches > 0 and K.pow_fixed.launches > 0


def _packed(dev, rng, coeffs, n):
    rows, _ = _lazy(rng, -(-coeffs * n * 2 // 3))
    return torch.as_tensor(rows[: coeffs * n].reshape(coeffs, n, R.NLIMBS), device=dev)


@pytest.mark.parametrize("kind", TF.OP_KINDS)
def test_tower_op_kernel_equals_plain(dev, kind):
    rng = random.Random(13)
    idx, coeffs = TF.OP_KINDS.index(kind), TF._OP_BODY[kind][1]
    for n in (1, 300, 1001):  # one lane, one lane per block, a ragged last block
        a, b = _packed(dev, rng, coeffs, n), _packed(dev, rng, coeffs, n)
        n0 = TK.tower_op.launches
        got = TK.tower_op(idx, a, b)
        torch.cuda.synchronize()
        assert TK.tower_op.launches == n0 + 1
        assert torch.equal(got, TF.op_plain(kind, a, b))


def test_miller_dbl_kernel_equals_plain(dev):
    rng = random.Random(14)
    for n in (1, 300, 1001):
        f, r, p = (_packed(dev, rng, c, n) for c in (12, 6, 2))
        got_f, got_r = TK.miller_dbl(f, r, p)
        want_f, want_r = TF.dbl_plain(f, r, p)
        assert torch.equal(got_f, want_f) and torch.equal(got_r, want_r)


def test_hard_exp_kernel_equals_plain(dev):
    rng = random.Random(15)
    for n in (1, 37):
        m = _packed(dev, rng, 12, n)
        assert torch.equal(TK.hard_exp(m), TF.hard_plain(m))


def test_fused_chain_on_the_card_equals_the_stacked_arm(dev, monkeypatch):
    from hbbft_tpu_torch.crypto import bls381 as gold
    from hbbft_tpu_torch.crypto.field import R as SUBR
    from hbbft_tpu_torch.ops import pairing as P, tower as T

    rng = random.Random(16)
    quads = []
    for _ in range(3):
        a = rng.randrange(1, SUBR)
        quads.append((gold.ec_neg(gold.FQ, gold.G1_GEN), gold.ec_mul(gold.FQ2, a, gold.G2_GEN),
                      gold.ec_mul(gold.FQ, a + (len(quads) == 2), gold.G1_GEN), gold.G2_GEN))
    ops = (P.g1_affine_to_device([q[0] for q in quads]),
           P.g2_affine_to_device([q[1] for q in quads]),
           P.g1_affine_to_device([q[2] for q in quads]),
           P.g2_affine_to_device([q[3] for q in quads]))
    TK.reset_launches()
    fused = P.product2_fast(*ops, fused=True)
    assert (TK.miller_dbl.launches, TK.hard_exp.launches, TK.tower_op.launches) == (63, 1, 1)
    stacked = P.product2_fast(*ops, fused=False)
    assert T.fq12_to_ints_batch(fused) == T.fq12_to_ints_batch(stacked)
    assert P.is_one_host_batch(fused, 3) == [True, True, False]
