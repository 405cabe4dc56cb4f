"""Card-only checks of the port: each CUDA kernel against its plain
version (the field kernels of csrc/fq_rns.cu and csrc/fq_limb.cu, the
fused tower kernels of csrc/tower_fused.cu and the FMA probe of
csrc/probe.cu), the fused chain against the stacked one, and the
backend on the card against the backend on the CPU (the threshold-
decryption and the signature/coin methods).

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
from hbbft_tpu_torch.ops import fq_limb as L, fq_limb_cuda as LK, probe_cuda as PK
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
    LK.build()
    PK.build()
    return torch.device("cuda", 0)


def _lazy(rng, n):
    xs = [rng.randrange(Q) for _ in range(n)]
    base = R.from_ints(xs)
    rows = np.concatenate([base, base[: n // 2] + base[n // 2 :], -base[:3] * 41])
    vals = xs + [(xs[i] + xs[n // 2 + i]) % Q for i in range(n // 2)]
    vals += [(-41 * x) % Q for x in xs[:3]]
    return rows, vals


#: fq_rns_mul's checked widths: one lane, around two 64-lane blocks, a
#: ragged persistent grid, full blocks, and the epoch path's mean launch
#: width (191,251 lanes over two N=100 epochs, PERF.md)
MUL_WIDTHS = (1, 127, 128, 129, 1001, 65536, 191251)


def _lazy_n(rng, n):
    """n lazy-domain rows (and their values) from _lazy's pattern."""
    rows, vals = _lazy(rng, 2 * max(1, -(-n // 3)))  # _lazy halves an even count
    reps = -(-n // len(rows))
    return np.tile(rows, (reps, 1))[:n], (vals * reps)[:n]


@pytest.mark.parametrize("bcast", ["none", "left", "right"])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("n", MUL_WIDTHS)
def test_mul_kernel_equals_plain(dev, n, reduced, bcast):
    """Bit-equal to the plain version; with a one-row operand on either
    side (read at lane stride 0, no expand) too."""
    rng = random.Random(9 + n)
    a_np, va = _lazy_n(rng, n)
    b_np, vb = _lazy_n(rng, n)
    a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
    if bcast == "left":
        a, va = a[n // 2], [va[n // 2]] * n  # a (79,) row
    elif bcast == "right":
        b, vb = b[n // 3 : n // 3 + 1], [vb[n // 3]] * n  # a (1, 79) row
    if reduced:  # reduced operands are mul outputs
        a, b = K.mul_plain(a, a), K.mul_plain(b, b)
        va, vb = [x * x % Q for x in va], [y * y % Q for y in vb]
    n0, s0 = K.mul.launches, K.mul.broadcast_launches
    got = K.mul(a, b, reduced=reduced)
    torch.cuda.synchronize()
    assert K.mul.launches == n0 + 1
    assert K.mul.broadcast_launches == s0 + (bcast != "none" and n > 1)
    assert got.shape == (n, R.NLIMBS)
    assert torch.equal(got, K.mul_plain(a, b, reduced=reduced))
    assert R.to_ints(got) == [x * y % Q for x, y in zip(va, vb)]


#: fq_rns_pow's checked widths: one lane, around one warp's group of 16,
#: a few groups, and the epoch path's widest launch (~4k lanes, PERF.md)
POW_WIDTHS = (1, 15, 16, 17, 100, 4095)


@pytest.mark.parametrize("n", POW_WIDTHS)
@pytest.mark.parametrize("exponent", [1, 2, 0b1011010111, Q - 2])
def test_pow_kernel_equals_plain(dev, exponent, n):
    rows, vals = _lazy_n(random.Random(10 + n), n)
    x = torch.as_tensor(rows, device=dev)
    n0 = K.pow_fixed.launches
    got = K.pow_fixed(x, exponent)
    torch.cuda.synchronize()
    assert K.pow_fixed.launches == n0 + 1
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


def test_sig_side_on_the_card_matches_the_cpu(dev):
    """verify_sig_shares (an RLC group with a forged share, a passing
    group, a direct pair), sign_shares_batch and combine_sig_shares_batch
    (with and without a doc) on the card equal the same calls on the CPU."""
    rng = random.Random(13)
    cpu = TorchBackend(device="cpu")
    card = TorchBackend()
    sks = cpu.generate_key_set(1, rng)
    pks = sks.public_keys()
    docs = [b"coin %d" % i for i in range(3)]
    for b in (cpu, card):
        b.device_combine_threshold = 2
    sign = [(sks.secret_key_share(i), d) for d in docs for i in range(4)]
    K.reset_launches()
    shares = card.sign_shares_batch(sign)
    assert shares == cpu.sign_shares_batch(sign) == [sk.sign_share(d) for sk, d in sign]
    items = [(pks.public_key_share(i), docs[0], shares[0 if i == 3 else i]) for i in range(4)]
    items += [(pks.public_key_share(i), docs[1], shares[4 + i]) for i in range(4)]
    items += [(pks.public_key_share(i), docs[2], shares[8 + i]) for i in (1, 2)]
    want = [True, True, True, False] + [True] * 6
    assert card.verify_sig_shares(items) == cpu.verify_sig_shares(items) == want
    assert card.counters.device_dispatches == cpu.counters.device_dispatches
    assert card.verify_sig_shares_deferred(items)() == want
    combs = [({i: shares[4 * c + i] for i in ix}, doc)
             for c, ix in ((0, (0, 1)), (1, (1, 3)), (2, (0, 2)))
             for doc in (docs[c], None)]
    got = card.combine_sig_shares_batch(pks, combs)
    assert got == cpu.combine_sig_shares_batch(pks, combs)
    assert got == [pks.combine_signatures(sh) for sh, _ in combs]
    assert K.mul.launches > 0 and K.pow_fixed.launches > 0
    assert TK.miller_dbl.launches > 0 and TK.hard_exp.launches > 0


def _packed(dev, rng, coeffs, n):
    rows, _ = _lazy(rng, 2 * -(-coeffs * n // 3))  # _lazy halves an even count
    return torch.as_tensor(rows[: coeffs * n].reshape(coeffs, n, R.NLIMBS), device=dev)


#: tower_op's checked widths: one lane (most of each warp pass padding),
#: around one warp's 16 tasks, a few groups, the epoch path's mean launch
#: width (796 lanes, PERF.md) and a grid of 2 and 4 lanes a block with a
#: ragged last block
OP_WIDTHS = (1, 15, 16, 17, 33, 796, 2049)


@pytest.mark.parametrize("n", OP_WIDTHS)
@pytest.mark.parametrize("kind", TF.OP_KINDS)
def test_tower_op_kernel_equals_plain(dev, kind, n):
    rng = random.Random(13 + n)
    idx, coeffs = TF.OP_KINDS.index(kind), TF._OP_BODY[kind][1]
    a, b = _packed(dev, rng, coeffs, n), _packed(dev, rng, coeffs, n)
    n0 = TK.tower_op.launches
    got = TK.tower_op(idx, a, b)
    torch.cuda.synchronize()
    assert TK.tower_op.launches == n0 + 1
    assert torch.equal(got, TF.op_plain(kind, a, b))


#: miller_dbl's checked widths besides one per lanes-per-block class: one
#: lane, a ragged last block, a full grid, and the epoch path's mean
#: launch width (1,593 lanes, PERF.md)
DBL_WIDTHS = (1, 1001, 2112, 1593)


@pytest.mark.parametrize("width", [*(f"n={n}" for n in DBL_WIDTHS),
                                   *(f"lb={lb}" for lb in (1, 2, 4, 8))])
def test_miller_dbl_kernel_equals_plain(dev, width):
    """Bit-equal to the plain version.  ``lb=L`` is the widest launch of
    the class that sizes blocks of L lanes on this card, less one lane
    (a ragged last block when L > 1)."""
    kind, val = width.split("=")
    n = int(val)
    if kind == "lb":
        resident = TK.resident_blocks(dev, "miller_dbl")
        n = max(1, resident * n - (n > 1))
        assert TK.lanes_per_block(n, resident) == int(val)
    rng = random.Random(14 + n)
    f, r, p = (_packed(dev, rng, c, n) for c in (12, 6, 2))
    n0 = TK.miller_dbl.launches
    got_f, got_r = TK.miller_dbl(f, r, p)
    want_f, want_r = TF.dbl_plain(f, r, p)
    torch.cuda.synchronize()
    assert TK.miller_dbl.launches == n0 + 1
    assert torch.equal(got_f, want_f) and torch.equal(got_r, want_r)


#: hard_exp's checked widths besides where its lanes per block step: one
#: to three lanes, a ragged 37, and the epoch path's mean launch width
#: (796 lanes, PERF.md)
HARD_WIDTHS = (1, 2, 3, 37, 796)
#: widths in hard_exp's resident blocks R, and the lanes per block each
#: gets: the widest launch at LB 1, the narrowest and widest at LB 2, the
#: narrowest at LB 4
HARD_STEPS = {"R": 1, "R+1": 2, "2R": 2, "2R+1": 4}


@pytest.mark.parametrize("width", [*(f"n={n}" for n in HARD_WIDTHS), *HARD_STEPS])
def test_hard_exp_kernel_equals_plain(dev, width):
    """Bit-equal to the plain version at the listed widths and where the
    lanes-per-block policy steps up (R: hard_exp's resident blocks)."""
    resident = TK.resident_blocks(dev, "hard_exp")
    if width.startswith("n="):
        n = int(width[2:])
    else:
        times, _, plus = width.partition("R")
        n = int(times or 1) * resident + int(plus or 0)
        assert TK.lanes_per_block(n, resident) == HARD_STEPS[width]
    m = _packed(dev, random.Random(15 + n), 12, n)
    n0 = TK.hard_exp.launches
    got = TK.hard_exp(m)
    torch.cuda.synchronize()
    assert TK.hard_exp.launches == n0 + 1
    assert torch.equal(got, TF.hard_plain(m))


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


def _lazy_limbs(rng, n):
    """n limb rows: canonical rows, sums of four and differences (negative
    limbs), with their values."""
    xs = [rng.randrange(Q) for _ in range(n)]
    xs[: min(n, 3)] = [0, 1, Q - 1][:n]
    base = L.from_ints(xs)
    k = n // 3
    rows = np.concatenate([base[:k], base[k : 2 * k] * 4, base[:k] - base[2 * k : 3 * k],
                           base[3 * k :]])
    vals = xs[:k] + [4 * x % Q for x in xs[k : 2 * k]]
    vals += [(xs[i] - xs[2 * k + i]) % Q for i in range(k)] + xs[3 * k :]
    return rows, vals


#: fq_limb_mul's checked widths: one lane, around two 8-lane warps, a
#: ragged last block, full blocks, and the limb arm's mean launch width
LIMB_MUL_WIDTHS = (1, 15, 16, 17, 1001, 4096, 35450)


@pytest.mark.parametrize("n", LIMB_MUL_WIDTHS)
def test_limb_mul_kernel_equals_plain(dev, n):
    rng = random.Random(17)
    a_np, va = _lazy_limbs(rng, n)
    b_np, vb = _lazy_limbs(rng, n)
    a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
    n0 = LK.mul.launches
    got = LK.mul(a, b)
    torch.cuda.synchronize()
    assert LK.mul.launches == n0 + 1
    assert torch.equal(got, LK.mul_plain(a, b))
    assert L.to_ints(got) == [x * y % Q for x, y in zip(va, vb)]
    # a one-row operand on either side, read in place at lane stride 0
    b0 = LK.mul.broadcast_launches
    for row in (b[n // 2], b[n // 2 :][:1]):
        assert torch.equal(LK.mul(a, row), LK.mul_plain(a, row))
        assert torch.equal(LK.mul(row, a), LK.mul_plain(row, a))
    assert LK.mul.broadcast_launches == b0 + (4 if n > 1 else 0)


#: fq_limb_pow's checked widths: one lane, the limb arm's mean launch
#: width (14), a few warps, and the top of a wide launch
LIMB_POW_WIDTHS = (1, 14, 150, 4095)


@pytest.mark.parametrize("n", LIMB_POW_WIDTHS)
@pytest.mark.parametrize("exponent", [1, 2, 0b1011010111, Q - 2])
def test_limb_pow_kernel_equals_plain(dev, exponent, n):
    rows, vals = _lazy_limbs(random.Random(18), n)
    x = torch.as_tensor(rows, device=dev)
    got = LK.pow_fixed(x, exponent)
    torch.cuda.synchronize()
    assert torch.equal(got, LK.pow_plain(x, exponent))
    assert L.to_ints(got) == [pow(v, exponent, Q) for v in vals]


def test_limb_field_routes_through_the_kernels(dev):
    rows, vals = _lazy_limbs(random.Random(19), 9)
    LK.reset_launches()
    inv = L.batch_inv(torch.as_tensor(rows[3:], device=dev))  # nonzero values
    assert L.to_ints(inv) == [pow(v, Q - 2, Q) for v in vals[3:]]
    assert LK.mul.launches > 0 and LK.pow_fixed.launches == 1


#: fq_rns_chain's checked widths: one lane, one full group of 16, a
#: ragged second group, one wave and a lane (4,096 lanes: 256 one-warp
#: blocks), a ragged group at 2 warps a block (16,385 lanes: 1,025 groups,
#: more than the H100's 792 resident blocks) and the kernel bench's mean
#: launch width (87,040 lanes, 4 warps a block)
CHAIN_WIDTHS = (1, 16, 17, 4097, 16385, 87040)


def test_chain_widths_take_every_block_size(dev):
    """The chain's widths cover each block size it launches: 1, 2 and 4
    warps, each with its own grid and dynamic shared memory."""
    resident = K.chain_blocks_per_sm(dev) * torch.cuda.get_device_properties(
        dev).multi_processor_count
    warps = [K.group_warps_per_block(n, resident) for n in CHAIN_WIDTHS]
    assert warps[CHAIN_WIDTHS.index(16385)] == 2
    assert set(warps) == {1, 2, 4}


@pytest.mark.parametrize("n", CHAIN_WIDTHS)
@pytest.mark.parametrize("chain", [0, 1, 200])
def test_rns_chain_kernel_equals_plain(dev, chain, n):
    """Bit-equal to the plain version (n = 0: loose(a)); 64 lanes against
    Python ints mod Q."""
    a_np, va = _lazy_n(random.Random(20 + n), n)
    b_np, vb = _lazy_n(random.Random(21 + n), n)
    a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
    n0 = K.mul_chain.launches
    got = K.mul_chain(a, b, chain)
    torch.cuda.synchronize()
    assert K.mul_chain.launches == n0 + 1
    assert torch.equal(got, K.mul_chain_plain(a, b, chain))
    assert R.to_ints(got[:64]) == [x * pow(y, chain, Q) % Q for x, y in zip(va[:64], vb[:64])]


def test_constant_buffers_match_the_libraries(dev):
    """Both libraries that run the body take the packed float vectors (no
    extension matrices: 516 floats) and int8 planes the wrapper packs, and
    every warp-body kernel's occupancy query answers."""
    assert K._lib().fq_rns_const_floats() == K._KCONSTS.size == 516
    assert TK._lib().tower_fused_const_floats() == K._KCONSTS.size
    assert K._lib().fq_rns_tc_bytes() == TK._lib().tower_fused_tc_bytes() == K._KPLANES.size
    for query in (K.mul_blocks_per_sm, K.pow_blocks_per_sm, K.chain_blocks_per_sm):
        assert query(dev) >= 1
    for kernel in ("tower_op", "miller_dbl", "hard_exp"):
        assert TK.resident_blocks(dev, kernel) >= torch.cuda.get_device_properties(
            dev).multi_processor_count


def test_fma_probe_within_its_tolerance(dev):
    x = torch.as_tensor(np.random.default_rng(22).random(PK.REF_SHAPE, dtype=np.float32),
                        device=dev)
    n0 = PK.fma_probe.launches
    got = PK.fma_probe(x, PK.REF_ITERS)
    want = PK.probe_plain(x, PK.REF_ITERS)
    torch.cuda.synchronize()
    assert PK.fma_probe.launches == n0 + 1
    rel = float(((got - want).abs() / want.abs()).max())
    assert rel <= PK.rel_tolerance(PK.REF_ITERS)
