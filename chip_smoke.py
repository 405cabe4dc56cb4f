#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # one H100; builds the kernels at first use

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every kernel source of hbbft_tpu_torch/csrc/ in
             parallel, one process each (fq_rns.cu: the RNS field multiply,
             power and chain; tower_fused.cu: the fused tower op, Miller
             doubling and final-exponentiation hard part; fq_limb.cu: the
             limb field multiply and power; probe.cu: the FMA probe).
2. kernels — each kernel against its plain PyTorch version on the card,
             bit for bit (tolerance 0: the arithmetic is exact integer
             float32) at one lane, partial blocks and full widths, plus
             field samples against Python-int arithmetic mod Q; the FMA
             probe within its derived relative tolerance
             (``probe_cuda.rel_tolerance``: the kernel fuses each step,
             the plain version rounds twice).  ``fq_rns_mul`` (timing
             phase) at MUL_WIDTHS and the epoch's mean width, reduced or
             not, with a one-row operand on either side or none;
             ``miller_dbl`` at DBL_WIDTHS, the epoch's mean width and one
             width per lanes-per-block class of this card; ``hard_exp`` at
             HARD_WIDTHS, the mean and where its lanes per block step up;
             ``fq_rns_pow`` at POW_WIDTHS and the epoch's widest launch.
3. path    — the threshold-decryption crypto path of one N=100, f=33
             HoneyBadger epoch through ``TorchBackend()`` (the first slice's
             path, now on the fused chain): ciphertext checks (one
             tampered), the epoch's 10k decryption-share generations, one
             2^17-item engine chunk of share verifies with planted forgeries,
             and 10k Lagrange combines (k=34); verdicts and plaintexts are
             checked exactly.  Then a short pass with
             HBBFT_TPU_NO_FUSED_TOWER=1 (the stacked arm) must give the fused
             arm's verdicts.
   limb arm — the same path in the field's second configuration: a child
             process with HBBFT_TPU_FQ_IMPL=limb (the facade binds at
             import) runs, on phase 3's keys and items (passed through a file
             under chiprun_out/), the ciphertext checks, the 10k shares, the
             stacked-arm pass's 19,800 share verifies and the 10k combines;
             its verdicts, shares and plaintexts must equal the RNS arm's,
             the limb kernels must have launched and the RNS and fused
             kernels must not have.
   sig path — the signature/coin crypto of one N=100 coin round on phase
             3's keys: the round's 10k coin-share signings (a sample equal to
             the host ``sign_share``), one 2^17-item engine chunk of share
             verifies with planted forgeries, the round's 10k Lagrange
             combines (k=34, no doc, as the engine calls them: every receiver
             of an instance must get the same signature, a sample equal to
             the host golden combine) and the 100 combined signatures' checks
             (plus one tampered); verdicts exact.
4. epoch   — the main path: whole N=100 HoneyBadger epochs through the
             port's ``ArrayHoneyBadgerNet`` on ``TorchBackend()``; every node
             must output the same Batch holding every contribution, and the
             native host kernels of the RS/Merkle plane must have been built.
   coin epoch — one N=100 epoch with ``coin_rounds=1`` (binary agreement
             on split inputs: one real threshold-sign coin round per
             instance): the same Batch checks, the coin's counts in the
             ``EpochReport`` (10,000 signs, 990,000 share verifies, 10,000
             combines), the native hash-to-G2 built; then ``fq_rns_mul`` and
             ``fq_rns_pow`` against their plain versions at the coin path's
             mean and widest launches.
   bench   — the port's kernel bench (``hbbft_tpu_torch.tools.kernel_bench``)
             at its default widths: M muls/s of both field arms and the RNS
             chain, TFLOP/s of the FMA probe.
             Kernel launch counts are zeroed just before each of phases 3,
             limb arm (in the child), sig path, 4, coin epoch and bench, and
             read just after; every kernel of the path must have launched.
5. a ``{"kernels": [...]}`` line, one row per kernel: launches on its own
   path (epoch, limb arm or bench; the epoch kernels also carry their
   launches on the coin epoch, ``coin_launches``), largest difference from the plain
   version (phase 2's widths and the path's), median kernel time at the
   path's mean launch width (``time_ms``: one call between two CUDA
   events; ``fq_rns_pow`` at the epoch's widest launch, no launch having
   its mean width, with its 1-lane time beside), the plain version's time
   and the bound (the least time the card could take: see ``bound`` and
   ``roofline``).  Before it: the compiler's ``-Xptxas -v`` lines, each
   kernel's occupancy and the epoch's launch widths.
6. per-phase seconds, device_dispatches, and the card's name and power
   limit; the last line is ``{"ok": true, "device": {...}}``.

``--profile`` runs phase 3 (each backend phase) and one epoch of phase 4 a
second time under torch.profiler (kernel time by name, the hand-written
kernels' device seconds each, device busy share).  The whole result
is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bandwidth, int8 tensor cores (every tensor-core product of the port is an
# s8 x s8 mma.sync), float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS = 1979e12
FP32_FLOPS = 67e12

# The least work one Montgomery product needs per lane (the bound below):
# * the two base extensions as int8 tensor-core products, as mul_warp
#   runs them on the 6-bit/5-bit planes (csrc/fq_rns_core.cuh): 2
#   extensions x 4 plane products x (40 x 40) multiply-adds x 2 ops;
# * the stage-wise reductions as float32 work, counted from the stages of
#   fq_rns_pallas._mul_core (one op per mul, add, floor or compare; a
#   loose reduction is 4, an exact one 10): lane product and offset 79x6,
#   sigma 39x11, two plane splits 39x4 each, extension-1 recombination
#   40x29, r2r 40x7, xi 39x11, extension-2 recombination 40x23, delta 12,
#   r1 39x6; the input renormalisation adds 79x2x4 when not `reduced`;
# * the bytes: each operand row read once, the result row written once.
MUL_TC_OPS = 2 * 4 * 40 * 40 * 2
MUL_EW_OPS_REDUCED = (79 * 6 + 39 * 11 + 2 * 39 * 4 + 40 * 29 + 40 * 7 + 39 * 11
                      + 40 * 23 + 12 + 39 * 6)
MUL_EW_OPS = MUL_EW_OPS_REDUCED + 79 * 2 * 4
ROW_BYTES = 79 * 4

# The main path's size: the N=100, f=33 epoch of engine/array_engine.py,
# one engine verify chunk of 2^17 items (array_engine.py:172) with a few
# forged shares, and 10k combines; then the kernel checks' widths.
N = 100
VERIFY_ITEMS = 1 << 17
COMBINES = 10_000
FORGED = 3
MUL_LANES = 1 << 17
POW_LANES = 4096
EPOCHS = 2
PAYLOAD = 128  # bytes per contribution (run_epochs' default)
#: widths the fused tower kernels are checked at besides the main path's
#: mean: one lane, and 1001 lanes (two lanes per block on the H100, the
#: last block one lane)
TOWER_WIDTHS = (1, 1001)
#: widths fq_rns_mul is checked at besides the main path's mean: one lane,
#: around two 64-lane blocks (4 warps x 16), a ragged persistent grid and
#: full blocks;
#: each with reduced False and True and a one-row operand on either side
MUL_WIDTHS = (1, 127, 128, 129, 1001, 65536)
#: widths miller_dbl is checked at besides the main path's mean and one
#: width per lanes-per-block class: one lane, a ragged last block (LB = 2),
#: a grid that fills the card exactly (LB = 4)
DBL_WIDTHS = (1, 1001, 2112)
#: widths hard_exp is checked at besides the main path's mean and the two
#: widths where its lanes per block step from 1 to 2: one to three lanes
#: and a ragged 37
HARD_WIDTHS = (1, 2, 3, 37)
#: widths fq_rns_pow is checked at besides the main path's widest launch:
#: one lane, and around one warp's group of 16
POW_WIDTHS = (1, 15, 16, 17)
#: widths the limb kernels and the RNS chain are checked at besides their
#: path's mean: one lane, a ragged last warp (8 lanes a warp for the limb
#: kernels; a ragged group of 16 lanes for the chain), full blocks; the
#: chain's widths take each of its block sizes on the H100 (1, 2 and 4
#: warps: 16,385 lanes are 1,025 groups, more than its 792 resident blocks)
LIMB_WIDTHS = (1, 1001, 4096)
CHAIN_WIDTHS = (1, 1001, 16385, 65536)
CHAIN_CHECK = 8  # products per checked chain launch
#: the limb arm's share verifies: the stacked-arm pass's 2·N·(N−1) items
LIMB_ARM_ITEMS = 2 * N * (N - 1)
#: the coin epoch: one real coin round a BA instance (the split-input
#: schedule)
COIN_ROUNDS = 1
#: host golden checks of the sig path: signature shares and instances sampled
SIGN_SAMPLES = 100
COMBINE_SAMPLES = 3

#: the kernels, by the path whose launches each row reports
EPOCH_KERNELS = ("fq_rns_mul", "fq_rns_pow", "tower_op", "miller_dbl", "hard_exp")
LIMB_KERNELS = ("fq_limb_mul", "fq_limb_pow")
BENCH_KERNELS = ("fq_rns_chain", "fma_probe")


# The limb field (csrc/fq_limb.cu).  Its operations per lane, counted from
# the code (an FMA is 2, a multiply, add or floor 1; a carry pass over n
# limbs is 5(n-1)+1): one carried product is the 50x50 convolution 2*2500,
# carry3 over 99 limbs 3*491, carry3 over 50 limbs 3*246 twice (float32
# operations), and the two folds, fold 1 (51 rows into 50 limbs) and fold 2
# (2 rows), counted as int8 tensor-core operations (2*50*51 + 2*50*2), as
# the RNS extensions are; a multiply adds carry3 on both operands.  A row
# is 50 limbs of 4 bytes.
LIMB_CARRY3_50 = 3 * (5 * 49 + 1)
LIMB_CORE_OPS = 2 * 2500 + 3 * (5 * 98 + 1) + 2 * LIMB_CARRY3_50
LIMB_CORE_TC_OPS = 2 * 50 * 51 + 2 * 50 * 2
LIMB_MUL_OPS = LIMB_CORE_OPS + 2 * LIMB_CARRY3_50
LIMB_ROW_BYTES = 50 * 4


def roofline(nbytes: float, fp32_ops: float, tc_ops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the largest of the time to move ``nbytes``,
    the time of the int8 tensor-core operations and the time of the
    float32 operations, each at its peak (the tensor cores and the float32
    pipe run at once, so the operations take the longer of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tc_ops / INT8_TC_OPS, fp32_ops / FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def bound(lanes: int, products: int, ew_ops: int, rows_moved: int) -> tuple:
    """(bound_ms, bound_by) of ``products`` Montgomery products on each of
    ``lanes`` lanes that move ``rows_moved`` residue rows per lane."""
    return roofline(lanes * rows_moved * ROW_BYTES, lanes * ew_ops,
                    lanes * products * MUL_TC_OPS)


def log(*parts) -> None:
    print(*parts, flush=True)


def lazy_rows(rng, n: int, R):
    """Lazy-domain residue rows as tests/test_fq_rns_pallas.py makes them:
    from_ints rows plus sums, differences and negations; returns the rows
    and their represented values."""
    import numpy as np

    from hbbft_tpu_torch.crypto.field import Q

    m = max(2, n // 4)
    xs = [rng.randrange(Q) for _ in range(m)]
    base = R.from_ints(xs)
    h = m // 2
    blocks = [base, base[:h] + base[h : 2 * h], base[:h] - base[h : 2 * h], -base]
    vals = [
        xs,
        [(xs[i] + xs[h + i]) % Q for i in range(h)],
        [(xs[i] - xs[h + i]) % Q for i in range(h)],
        [(-x) % Q for x in xs],
    ]
    rows = np.concatenate(blocks)
    flat = [v for blk in vals for v in blk]
    reps = -(-n // len(rows))
    return np.tile(rows, (reps, 1))[:n], (flat * reps)[:n]


def time_ms(fn, reps: int = 7) -> float:
    """Median device time of fn() with CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_kernels(dev, rng, mul_lanes: int, pow_lanes: int) -> dict:
    """Each kernel against its plain version on the same card inputs."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K

    out = {}
    a_np, va = lazy_rows(rng, mul_lanes, R)
    b_np, vb = lazy_rows(rng, mul_lanes, R)
    a = torch.as_tensor(a_np, device=dev)
    b = torch.as_tensor(b_np[::-1].copy(), device=dev)
    vb = vb[::-1]
    err = 0.0
    for reduced in (False, True):
        x, y = (K.mul_plain(a, a), K.mul_plain(b, b)) if reduced else (a, b)
        err = max(err, same(f"fq_rns_mul reduced={reduced}", K.mul(x, y, reduced=reduced),
                            K.mul_plain(x, y, reduced=reduced)))
    sample = R.to_ints(K.mul(a[:64], b[:64]))
    if sample != [x * y % Q for x, y in zip(va[:64], vb[:64])]:
        raise AssertionError("fq_rns_mul disagrees with Python ints mod Q")
    out["fq_rns_mul"] = err

    got = K.pow_fixed(a[:pow_lanes], Q - 2)
    out["fq_rns_pow"] = same("fq_rns_pow e=Q-2", got, K.pow_plain(a[:pow_lanes], Q - 2))
    inv = R.to_ints(got[:64])
    if inv != [pow(v, Q - 2, Q) for v in va[:64]]:
        raise AssertionError("fq_rns_pow disagrees with Python ints mod Q")
    return out


def tower_inputs(dev, rng, coeffs: int, n: int):
    """A packed (coeffs, n, 79) operand of lazy-domain rows on the card."""
    import torch

    from hbbft_tpu_torch.ops import fq_rns as R

    rows = lazy_rows(rng, coeffs * n, R)[0]
    return torch.as_tensor(rows.reshape(coeffs, n, R.NLIMBS), device=dev)


def check_tower_kernels(dev, rng, widths, errs: dict) -> None:
    """Each fused tower kernel (all seven kinds of the op kernel) against
    its plain version at each width in ``widths``; the largest difference
    is folded into ``errs``."""
    from hbbft_tpu_torch.ops import tower_fused as TF, tower_fused_cuda as TK

    for n in widths:
        for idx, kind in enumerate(TF.OP_KINDS):
            c = TF._OP_BODY[kind][1]
            a, b = tower_inputs(dev, rng, c, n), tower_inputs(dev, rng, c, n)
            errs["tower_op"] = max(errs.get("tower_op", 0.0), same(
                f"tower_op {kind}", TK.tower_op(idx, a, b), TF.op_plain(kind, a, b)))
        f, r, p = (tower_inputs(dev, rng, c, n) for c in (12, 6, 2))
        got_f, got_r = TK.miller_dbl(f, r, p)
        want_f, want_r = TF.dbl_plain(f, r, p)
        errs["miller_dbl"] = max(errs.get("miller_dbl", 0.0),
                                 same("miller_dbl f", got_f, want_f),
                                 same("miller_dbl R", got_r, want_r))
        m = tower_inputs(dev, rng, 12, n)
        errs["hard_exp"] = max(errs.get("hard_exp", 0.0),
                               same("hard_exp", TK.hard_exp(m), TF.hard_plain(m)))


def check_limb_kernels(dev, rng, widths, errs: dict) -> None:
    """The limb multiply (also with a one-row operand on either side, read
    at lane stride 0) and power against their plain versions at each
    width, and samples against Python ints mod Q."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_limb as L, fq_limb_cuda as LK

    for n in widths:
        a_np, va = lazy_rows(rng, n, L)
        b_np, vb = lazy_rows(rng, n, L)
        a = torch.as_tensor(a_np, device=dev)
        b = torch.as_tensor(b_np[::-1].copy(), device=dev)
        vb = vb[::-1]
        got = LK.mul(a, b)
        errs["fq_limb_mul"] = max(errs.get("fq_limb_mul", 0.0),
                                  same("fq_limb_mul", got, LK.mul_plain(a, b)))
        for tag, u, v in (("(50,) x rows", a[n // 2], b),
                          ("rows x (1, 50)", a, b[n // 3:n // 3 + 1])):
            errs["fq_limb_mul"] = max(errs["fq_limb_mul"], same(
                f"fq_limb_mul {tag}", LK.mul(u, v), LK.mul_plain(u, v)))
        if L.to_ints(got[:64]) != [x * y % Q for x, y in zip(va[:64], vb[:64])]:
            raise AssertionError("fq_limb_mul disagrees with Python ints mod Q")
        got = LK.pow_fixed(a, Q - 2)
        errs["fq_limb_pow"] = max(errs.get("fq_limb_pow", 0.0),
                                  same("fq_limb_pow e=Q-2", got, LK.pow_plain(a, Q - 2)))
        if L.to_ints(got[:16]) != [pow(v, Q - 2, Q) for v in va[:16]]:
            raise AssertionError("fq_limb_pow disagrees with Python ints mod Q")


def check_chain_kernel(dev, rng, widths, errs: dict) -> None:
    """The RNS chain kernel (CHAIN_CHECK products per launch) against its
    plain version at each width, and samples against Python ints; the
    widths must take every block size (1, 2 and 4 warps) on this card."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K

    resident = K.chain_blocks_per_sm(dev) * torch.cuda.get_device_properties(
        dev).multi_processor_count
    warps = {n: K.group_warps_per_block(n, resident) for n in widths}
    if set(warps.values()) != {1, 2, 4}:
        raise AssertionError(f"the chain's widths take {warps} warps a block, not 1, 2 and 4")
    for n in widths:
        a_np, va = lazy_rows(rng, n, R)
        b_np, vb = lazy_rows(rng, n, R)
        a = torch.as_tensor(a_np, device=dev)
        b = torch.as_tensor(b_np[::-1].copy(), device=dev)
        vb = vb[::-1]
        got = K.mul_chain(a, b, CHAIN_CHECK)
        errs["fq_rns_chain"] = max(errs.get("fq_rns_chain", 0.0), same(
            f"fq_rns_chain n={CHAIN_CHECK} ({warps[n]} warps a block)", got,
            K.mul_chain_plain(a, b, CHAIN_CHECK)))
        want = [x * pow(y, CHAIN_CHECK, Q) % Q for x, y in zip(va[:64], vb[:64])]
        if R.to_ints(got[:64]) != want:
            raise AssertionError("fq_rns_chain disagrees with Python ints mod Q")


def check_probe(dev, seed: int, shape, iters: int, errs: dict) -> None:
    """The FMA probe against its plain version within the derived relative
    tolerance (the kernel fuses each step, the plain version rounds the
    product and the sum: ``probe_cuda.rel_tolerance``)."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import probe_cuda as PK

    x = torch.as_tensor(np.random.default_rng(seed).random(shape, dtype=np.float32), device=dev)
    got, want = PK.fma_probe(x, iters), PK.probe_plain(x, iters)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = PK.rel_tolerance(iters)
    err, rel = float(diff.max()), float((diff / want.abs().clamp_min(1e-30)).max())
    log(f"fma_probe {shape[0]}x{shape[1]} x {iters} steps: max |kernel - plain| = {err}, "
        f"relative {rel:.3e} (tolerance {tol:.3e})")
    if not bool((diff <= tol * want.abs()).all()):
        raise AssertionError("fma_probe is outside its tolerance of the plain version")
    errs["fma_probe"] = max(errs.get("fma_probe", 0.0), err)


def phase_main(backend, rng, n: int, f: int, verify_items: int, combines: int,
               forged: int, wrap=None, keep=None) -> dict:
    """The threshold-decryption path of one epoch through the backend.
    ``wrap(phase)``, when given, is a context manager around each phase;
    ``keep``, when given, a dict that receives the ciphertexts, verify
    items and verdicts for ``phase_stacked_arm``."""
    from hbbft_tpu_torch.crypto.keys import Ciphertext, DecryptionShare

    group = backend.group
    secs = {}

    @contextmanager
    def timed(name):
        t = time.perf_counter()
        with wrap(name) if wrap else nullcontext():
            yield
        secs[name] = time.perf_counter() - t

    with timed("host_setup"):
        sks = backend.generate_key_set(f, rng)
        pks = sks.public_keys()
        sk_shares = [sks.secret_key_share(i) for i in range(n)]
        pk_shares = [pks.public_key_share(i) for i in range(n)]
        msgs = [f"batch of proposer {p}".encode() * 3 for p in range(n)]
        cts = [pks.encrypt(m, rng) for m in msgs]

    # ciphertext validation: every honest one passes, the tampered one fails
    tampered = Ciphertext(group, cts[0].u, bytes([cts[0].v[0] ^ 1]) + cts[0].v[1:], cts[0].w)
    with timed("verify_ciphertexts"):
        ok = backend.verify_ciphertexts(cts + [tampered])
    if ok != [True] * n + [False]:
        raise AssertionError(f"ciphertext verdicts wrong: {ok.count(False)} rejected")
    log(f"verify_ciphertexts: {n} honest accepted, 1 tampered rejected")

    # every node's decryption share of every proposer's ciphertext
    gen_items = [(sk, cts[p]) for p in range(n) for sk in sk_shares]
    with timed("decrypt_shares_batch"):
        gen = backend.decrypt_shares_batch(gen_items)
    for i in rng.sample(range(len(gen_items)), 4):
        sk, ct = gen_items[i]
        if gen[i] != sk.decrypt_share_unchecked(ct):
            raise AssertionError(f"decryption share {i} differs from the host golden")
    log(f"decrypt_shares_batch: {len(gen)} shares, 4 sampled equal the host golden")

    # one engine verify chunk: items replicated per receiver (n-1 copies of
    # each (pk share, ciphertext, share) object), with forged shares planted
    distinct = [(pk_shares[s], cts[p], gen[p * n + s]) for p in range(n) for s in range(n)]
    per_ct = n * (n - 1)
    span = max(1, min(n, verify_items // per_ct))
    bad = set()
    for j in range(forged):
        p = (j * 7) % span
        s = (j * 37 + 5) % n
        bad.add(p * n + s)
    for d in bad:
        pk, ct, share = distinct[d]
        wrong = DecryptionShare(group, group.g1_add(share.el, group.g1()))
        distinct[d] = (pk, ct, wrong)
    items = [it for it in distinct for _ in range(n - 1)][:verify_items]
    want = [i // (n - 1) not in bad for i in range(len(items))]
    with timed("verify_dec_shares"):
        got = backend.verify_dec_shares(items)
    if got != want:
        miss = sum(1 for g, w in zip(got, want) if g != w)
        raise AssertionError(f"dec-share verdicts wrong on {miss} items")
    log(f"verify_dec_shares: {len(items)} items, {want.count(False)} forged (from "
        f"{len(bad)} distinct shares) all rejected, the rest accepted")

    # every receiver combines the f+1 lowest shares of every proposer
    k = f + 1
    reps = max(1, combines // n)
    combine_items = []
    for p in range(n):
        chosen = {i: gen[p * n + i] for i in range(k)}
        combine_items.extend([(chosen, cts[p])] * reps)
    combine_items = combine_items[:combines]
    with timed("combine_dec_shares_batch"):
        plains = backend.combine_dec_shares_batch(pks, combine_items)
    msg_of = {id(ct): m for ct, m in zip(cts, msgs)}
    for (shares, ct), pt in zip(combine_items, plains):
        if pt != msg_of[id(ct)]:
            raise AssertionError("a combined plaintext differs from the encrypted one")
    log(f"combine_dec_shares_batch: {len(plains)} combines (k={k}), every plaintext equal")
    if keep is not None:
        keep.update(n=n, f=f, combines=combines, pks=pks, sk_shares=sk_shares,
                    pk_shares=pk_shares, cts=cts + [tampered], ct_ok=ok, gen=gen, items=items,
                    want=want, plains=plains)
    return {"seconds": secs, "verify_items": len(items), "forged_items": want.count(False),
            "combines": len(plains)}


def phase_stacked_arm(state, n_items: int, device=None) -> dict:
    """HBBFT_TPU_NO_FUSED_TOWER=1 (the stacked composition) against the
    fused arm: the same verdicts on phase 3's ciphertexts and on the first
    ``n_items`` share verifies (forgeries included)."""
    from hbbft_tpu_torch.ops.backend import TorchBackend

    items, want = state["items"][:n_items], state["want"][:n_items]
    t = time.perf_counter()
    fused = TorchBackend(device).verify_dec_shares(items)
    fused_s = time.perf_counter() - t
    os.environ["HBBFT_TPU_NO_FUSED_TOWER"] = "1"
    try:
        stacked = TorchBackend(device)
        ct_ok = stacked.verify_ciphertexts(state["cts"])
        t = time.perf_counter()
        dec_ok = stacked.verify_dec_shares(items)
        stacked_s = time.perf_counter() - t
    finally:
        del os.environ["HBBFT_TPU_NO_FUSED_TOWER"]
    if ct_ok != state["ct_ok"] or dec_ok != fused or fused != want:
        raise AssertionError("the stacked and fused arms disagree on a verdict")
    if stacked.counters.fused_tower_calls or not stacked.counters.stacked_chain_pallas_calls:
        raise AssertionError("HBBFT_TPU_NO_FUSED_TOWER=1 did not route the stacked arm")
    log(f"stacked arm: {len(ct_ok)} ciphertext and {len(items)} share verdicts "
        f"({want.count(False)} forged) equal the fused arm's; verify_dec_shares "
        f"{fused_s:.3f} s fused, {stacked_s:.3f} s stacked")
    return {"ciphertexts": len(ct_ok), "dec_items": len(items),
            "dec_seconds": {"fused": fused_s, "stacked": stacked_s}}


def phase_sig(backend, rng, state, verify_items: int, forged: int, card: str) -> dict:
    """The signature/coin crypto of one coin round through the backend, on
    phase 3's keys: every node's share of every instance's coin document,
    one engine verify chunk with forged shares planted, every receiver's
    combine (no doc, as the engine calls it) and the combined signatures'
    checks (one tampered)."""
    from hbbft_tpu_torch.crypto.keys import SignatureShare
    from hbbft_tpu_torch.utils import canonical

    n, f = state["n"], state["f"]
    pks, sk_shares, pk_shares = state["pks"], state["sk_shares"], state["pk_shares"]
    group = backend.group
    secs = {}

    @contextmanager
    def timed(name):
        t = time.perf_counter()
        yield
        secs[name] = time.perf_counter() - t

    docs = [canonical.encode(("coin", 0, p, 0)) for p in range(n)]
    sign_items = [(sk, docs[p]) for p in range(n) for sk in sk_shares]
    with timed("sign_shares_batch"):
        shares = backend.sign_shares_batch(sign_items)
    for i in rng.sample(range(len(sign_items)), min(SIGN_SAMPLES, len(sign_items))):
        sk, doc = sign_items[i]
        if shares[i] != sk.sign_share(doc):
            raise AssertionError(f"signature share {i} differs from the host sign_share")
    log(f"sign_shares_batch: {len(shares)} shares, "
        f"{min(SIGN_SAMPLES, len(sign_items))} sampled equal the host sign_share")

    # one engine verify chunk: each (pk share, doc, share) object repeated
    # for the n-1 receivers, with forged shares planted
    distinct = [(pk_shares[s], docs[p], shares[p * n + s]) for p in range(n) for s in range(n)]
    span = max(1, min(n, verify_items // (n * (n - 1))))
    bad = {((j * 7) % span) * n + (j * 37 + 5) % n for j in range(forged)}
    for d in bad:
        pk, doc, share = distinct[d]
        distinct[d] = (pk, doc, SignatureShare(group, group.g2_add(share.el, group.g2())))
    items = [it for it in distinct for _ in range(n - 1)][:verify_items]
    want = [i // (n - 1) not in bad for i in range(len(items))]
    with timed("verify_sig_shares"):
        got = backend.verify_sig_shares(items)
    if got != want:
        miss = sum(1 for g, w in zip(got, want) if g != w)
        raise AssertionError(f"sig-share verdicts wrong on {miss} items")
    log(f"verify_sig_shares: {len(items)} items, {want.count(False)} forged (from {len(bad)} "
        f"distinct shares) all rejected, the rest accepted")

    # every receiver combines the f+1 shares from its own index on
    k = f + 1
    combine_items = [
        ({(r + j) % n: shares[p * n + (r + j) % n] for j in range(k)}, None)
        for p in range(n) for r in range(n)
    ]
    with timed("combine_sig_shares_batch"):
        sigs = backend.combine_sig_shares_batch(pks, combine_items)
    for p in range(n):
        if any(sig != sigs[p * n] for sig in sigs[p * n : (p + 1) * n]):
            raise AssertionError(f"the receivers of instance {p} combined different signatures")
    for p in rng.sample(range(n), COMBINE_SAMPLES):
        if sigs[p * n] != pks.combine_signatures(combine_items[p * n][0]):
            raise AssertionError(f"instance {p}'s signature differs from the host golden combine")
    log(f"combine_sig_shares_batch: {len(sigs)} combines (k={k}), one signature per instance, "
        f"{COMBINE_SAMPLES} sampled equal the host golden combine")

    pk = pks.public_key()
    sig_items = [(pk, docs[p], sigs[p * n]) for p in range(n)] + [(pk, docs[1], sigs[0])]
    with timed("verify_signatures"):
        ok = backend.verify_signatures(sig_items)
    if ok != [True] * n + [False]:
        raise AssertionError(f"signature verdicts wrong: {ok.count(False)} rejected")
    log(f"verify_signatures: {n} combined signatures accepted, 1 tampered rejected")
    log(f"sig path N={n}, f={f} [{card}]: seconds {json.dumps(secs)}")
    return {"seconds": secs, "signs": len(shares), "verify_items": len(items),
            "forged_items": want.count(False), "combines": len(sigs),
            "signatures": len(sig_items)}


def _enc(v):
    """A group element (affine int tuples, None at infinity) as JSON."""
    return None if v is None else hex(v) if isinstance(v, int) else [_enc(x) for x in v]


def _dec(v):
    return None if v is None else int(v, 16) if isinstance(v, str) else tuple(_dec(x) for x in v)


def check_dbl_widths(dev, rng, n_mean: int, errs: dict) -> None:
    """miller_dbl against its plain version at DBL_WIDTHS, the main path's
    mean width and, for each lanes-per-block class the sizing can pick on
    this card, its widest launch less one lane (a ragged last block)."""
    from hbbft_tpu_torch.ops import tower_fused as TF, tower_fused_cuda as TK

    resident = TK.resident_blocks(dev, "miller_dbl")
    classes, lb = [], 1
    while lb <= TK.MAX_LB:
        classes.append(max(1, resident * lb - (lb > 1)))
        lb *= 2
    for n in (*DBL_WIDTHS, n_mean, *classes):
        f, r, p = (tower_inputs(dev, rng, c, n) for c in (12, 6, 2))
        got_f, got_r = TK.miller_dbl(f, r, p)
        want_f, want_r = TF.dbl_plain(f, r, p)
        lb = TK.lanes_per_block(n, resident)
        errs["miller_dbl"] = max(errs.get("miller_dbl", 0.0),
                                 same(f"miller_dbl f (LB={lb})", got_f, want_f),
                                 same(f"miller_dbl R (LB={lb})", got_r, want_r))


def check_hard_widths(dev, rng, errs: dict) -> None:
    """hard_exp against its plain version at HARD_WIDTHS and where its
    lanes per block step from 1 to 2 on this card (the resident blocks,
    and one lane more)."""
    from hbbft_tpu_torch.ops import tower_fused as TF, tower_fused_cuda as TK

    resident = TK.resident_blocks(dev, "hard_exp")
    for n in (*HARD_WIDTHS, resident, resident + 1):
        m = tower_inputs(dev, rng, 12, n)
        lb = TK.lanes_per_block(n, resident)
        errs["hard_exp"] = max(errs.get("hard_exp", 0.0),
                               same(f"hard_exp (LB={lb})", TK.hard_exp(m), TF.hard_plain(m)))


def limb_arm_payload(state, n_items: int) -> dict:
    """Phase 3's keys, ciphertexts, shares and first ``n_items`` verify
    items as JSON.  Points travel as affine coordinates (the child trusts
    its parent's points instead of re-running the subgroup checks), and
    each distinct item once, so the child's list repeats the same objects
    as the parent's."""
    pk_idx = {id(pk): i for i, pk in enumerate(state["pk_shares"])}
    ct_idx = {id(ct): i for i, ct in enumerate(state["cts"])}
    uniq: dict = {}
    distinct, order = [], []
    for it in state["items"][:n_items]:
        j = uniq.get(id(it))
        if j is None:
            j = uniq[id(it)] = len(distinct)
            pk, ct, share = it
            distinct.append([pk_idx[id(pk)], ct_idx[id(ct)], _enc(share.el)])
        order.append(j)
    return {
        "n": state["n"], "f": state["f"], "combines": state["combines"],
        "pks": state["pks"].to_bytes().hex(),
        "sk_shares": [hex(sk.x) for sk in state["sk_shares"]],
        "pk_shares": [_enc(pk.el) for pk in state["pk_shares"]],
        "cts": [[_enc(ct.u), ct.v.hex(), _enc(ct.w)] for ct in state["cts"]],
        "gen": [_enc(sh.el) for sh in state["gen"]],
        "distinct": distinct, "items": order,
    }


def limb_arm_unpack(d: dict, group) -> dict:
    """``limb_arm_payload``'s JSON back into the port's objects: the key
    set, the secret key shares, the ciphertexts, the RNS arm's decryption
    shares, the verify items (distinct objects shared as in the parent)
    and the combine items built as ``phase_main`` builds them."""
    from hbbft_tpu_torch.crypto.keys import (
        Ciphertext, DecryptionShare, PublicKeySet, PublicKeyShare, SecretKeyShare,
    )

    n, f = d["n"], d["f"]
    pk_shares = [PublicKeyShare(group, _dec(p)) for p in d["pk_shares"]]
    cts = [Ciphertext(group, _dec(u), bytes.fromhex(v), _dec(w)) for u, v, w in d["cts"]]
    gen = [DecryptionShare(group, _dec(p)) for p in d["gen"]]
    distinct = [(pk_shares[s], cts[p], DecryptionShare(group, _dec(e)))
                for s, p, e in d["distinct"]]
    k, reps = f + 1, max(1, d["combines"] // n)
    combine_items = []
    for p in range(n):
        chosen = {i: gen[p * n + i] for i in range(k)}
        combine_items.extend([(chosen, cts[p])] * reps)
    return {
        "n": n, "pks": PublicKeySet.from_bytes(group, bytes.fromhex(d["pks"])),
        "sk_shares": [SecretKeyShare(group, int(x, 16)) for x in d["sk_shares"]],
        "cts": cts, "gen": gen, "items": [distinct[j] for j in d["items"]],
        "combine_items": combine_items[: d["combines"]],
    }


def limb_arm_child(in_path: str, out_path: str) -> int:
    """The child of ``phase_limb_arm`` (HBBFT_TPU_FQ_IMPL=limb): the four
    backend phases on the parent's keys and items; writes the verdicts,
    shares, plaintexts, kernel launches and counters to ``out_path``."""
    import torch

    from hbbft_tpu_torch.ops import fq
    from hbbft_tpu_torch.ops.backend import TorchBackend

    if fq.IMPL != "limb":
        raise AssertionError(f"the limb arm runs with HBBFT_TPU_FQ_IMPL=limb, not {fq.IMPL}")
    with open(in_path) as fh:
        d = json.load(fh)
    backend = TorchBackend()
    u = limb_arm_unpack(d, backend.group)
    n, cts = u["n"], u["cts"]

    secs = {}
    reset_launches()
    t = time.perf_counter()
    ct_ok = backend.verify_ciphertexts(cts)
    secs["verify_ciphertexts"] = time.perf_counter() - t
    t = time.perf_counter()
    gen_items = [(sk, cts[p]) for p in range(n) for sk in u["sk_shares"]]
    shares = backend.decrypt_shares_batch(gen_items)
    secs["decrypt_shares_batch"] = time.perf_counter() - t
    t = time.perf_counter()
    dec_ok = backend.verify_dec_shares(u["items"])
    secs["verify_dec_shares"] = time.perf_counter() - t
    t = time.perf_counter()
    plains = backend.combine_dec_shares_batch(u["pks"], u["combine_items"])
    torch.cuda.synchronize()
    secs["combine_dec_shares_batch"] = time.perf_counter() - t
    fns = kernel_fns()
    c = backend.counters
    out = {
        "ct_ok": ct_ok, "dec_ok": dec_ok, "shares": [sh.to_bytes().hex() for sh in shares],
        "plains": [pt.hex() for pt in plains], "seconds": secs,
        "launches": {k: fn.launches for k, fn in fns.items()},
        "lanes": {k: fn.lanes for k, fn in fns.items()},
        "fq_limb_mul_broadcast_launches": fns["fq_limb_mul"].broadcast_launches,
        "counters": {k: getattr(c, k) for k in (
            "device_dispatches", "pairing_checks", "rlc_groups", "fused_tower_calls",
            "stacked_chain_pallas_calls")},
    }
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    log(f"limb arm (child): launches {json.dumps(out['launches'])}")
    return 0


def phase_limb_arm(state, n_items: int, card: str) -> dict:
    """The threshold-decryption path with HBBFT_TPU_FQ_IMPL=limb in a child
    process (the facade binds the field at import), on phase 3's keys and
    items: its ciphertext and share verdicts, shares and plaintexts must
    equal the RNS arm's, the limb kernels must have launched and the RNS
    and fused kernels must not have."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "limb_arm_in.json")
    out_path = os.path.join(out_dir, "limb_arm_out.json")
    with open(in_path, "w") as fh:
        json.dump(limb_arm_payload(state, n_items), fh)
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--limb-arm", in_path, out_path]
    t = time.perf_counter()
    proc = subprocess.run(cmd, env=dict(os.environ, HBBFT_TPU_FQ_IMPL="limb"), timeout=900)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"the limb arm's child exited {proc.returncode}")
    with open(out_path) as fh:
        res = json.load(fh)
    if res["ct_ok"] != state["ct_ok"]:
        raise AssertionError("the limb arm's ciphertext verdicts differ from the RNS arm's")
    if res["dec_ok"] != state["want"][:n_items]:
        raise AssertionError("the limb arm's share verdicts differ from the RNS arm's")
    if res["shares"] != [sh.to_bytes().hex() for sh in state["gen"]]:
        raise AssertionError("the limb arm's decryption shares differ from the RNS arm's")
    if res["plains"] != [pt.hex() for pt in state["plains"]]:
        raise AssertionError("the limb arm's plaintexts differ from the RNS arm's")
    c = res["counters"]
    if c["fused_tower_calls"] or not c["stacked_chain_pallas_calls"]:
        raise AssertionError("the limb arm did not take the stacked chain")
    launched = res["launches"]
    if not all(launched[k] > 0 for k in LIMB_KERNELS):
        raise AssertionError(f"the limb kernels did not launch: {launched}")
    if any(launched[k] for k in EPOCH_KERNELS):
        raise AssertionError(f"RNS or fused kernels launched in the limb arm: {launched}")
    log(f"limb arm [{card}]: {len(res['ct_ok'])} ciphertext verdicts, {len(res['shares'])} "
        f"shares, {len(res['dec_ok'])} share verdicts ({res['dec_ok'].count(False)} forged) "
        f"and {len(res['plains'])} plaintexts equal the RNS arm's; child wall {wall:.3f} s, "
        f"seconds {json.dumps(res['seconds'])}")
    log(f"limb arm: fq_limb_mul read a one-row operand at lane stride 0 in "
        f"{res['fq_limb_mul_broadcast_launches']} of {launched['fq_limb_mul']} launches")
    return {**{k: res[k] for k in ("seconds", "launches", "lanes", "counters",
                                   "fq_limb_mul_broadcast_launches")},
            "wall_seconds": wall, "items": n_items}


def phase_epoch(backend, seed: int, n: int, epochs: int, card: str, coin_rounds: int = 0) -> dict:
    """Whole N-node epochs through the port's engine: every node must output
    the same Batch, holding every node's contribution.  With
    ``coin_rounds``, each epoch must also report the coin's counts and the
    native hash-to-G2 must have been built."""
    import torch

    from hbbft_tpu_torch import native
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet

    t = time.perf_counter()
    net = ArrayHoneyBadgerNet(range(n), backend=backend, seed=seed, coin_rounds=coin_rounds)
    setup = time.perf_counter() - t
    log(f"epoch setup (N={n} key generation on the host): {setup:.2f} s")
    out = {"setup_seconds": setup, "epochs": []}
    for _ in range(epochs):
        contribs = {nid: net.rng.getrandbits(8 * PAYLOAD).to_bytes(PAYLOAD, "big")
                    for nid in net.ids}
        t = time.perf_counter()
        batches = net.run_epoch(contribs)
        if backend.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        first = batches[net.ids[0]]
        if sorted(batches) != net.ids or any(b != first for b in batches.values()):
            raise AssertionError("the nodes output different Batches")
        if first.contributions != contribs:
            raise AssertionError("the Batch does not hold every contribution")
        rep = dataclasses.asdict(net.reports[-1])
        out["epochs"].append({"seconds": secs, "report": rep})
        log(f"epoch {first.epoch} N={n} coin_rounds={coin_rounds} [{card}]: {secs:.3f} s, all "
            f"{n} nodes output the same Batch of {len(first.contributions)} contributions")
        log(f"  EpochReport: {json.dumps(rep)}")
        # the reference engine's accounting of a coin round: every node
        # signs every instance's document (n²), every receiver checks every
        # other sender's share (n²(n−1)) and combines once per instance (n²)
        coin = tuple(rep[k] for k in ("coin_rounds", "coin_signs", "sig_shares_verified",
                                      "sig_combines"))
        want = (coin_rounds, coin_rounds * n * n, coin_rounds * n * n * (n - 1),
                coin_rounds * n * n)
        if coin != want:
            raise AssertionError(f"the coin's counts are {coin}, not {want}")
    # the RS/Merkle plane ran on the port's native C kernels, not hashlib,
    # and the coin's documents on the native hash-to-G2
    if not (native.available() and native.sha256_available()):
        raise AssertionError("the native host kernels (gf256, sha256) were not built")
    if coin_rounds and not native.hashg2_available():
        raise AssertionError("the native hash-to-G2 kernel was not built")
    c = backend.counters.snapshot()
    out["device_dispatches"] = c["device_dispatches"]
    out["device_seconds"] = {k[len("device_seconds_"):]: v for k, v in c.items()
                             if k.startswith("device_seconds_") and v}
    out["host_buckets"] = {k[len("host_bucket_"):]: v for k, v in c.items()
                           if k.startswith("host_bucket_") and v}
    out["counters"] = {k: c[k] for k in (
        "device_seconds", "host_seconds", "pairing_checks", "rlc_groups", "fused_tower_calls",
        "fused_chain_pallas_calls", "fused_chain_field_muls", "dec_shares_verified",
        "ciphertexts_verified", "dec_shares_combined", "sig_shares_verified",
        "sig_shares_combined", "hash_g2_seconds")}
    log(f"epoch device_dispatches={c['device_dispatches']} [{card}]")
    log(f"epoch device seconds by kind [{card}]: {json.dumps(out['device_seconds'])}")
    log(f"epoch host buckets [{card}]: {json.dumps(out['host_buckets'])}")
    log(f"epoch counters [{card}]: {json.dumps(out['counters'])}")
    return out


def same(name: str, got, want) -> float:
    """max |kernel - plain|; raises unless the two are equal value for value
    (whether every bit agrees too, the signs of zeros included, is logged)."""
    import torch

    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    bits = torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))
    log(f"{name}: {got.shape[-2]} lanes, max |kernel - plain| = {e}, same bits: {bits}")
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version")
    return e


def check_coin_widths(dev, rng, errs: dict, launches: dict, lanes: dict, widest: dict) -> dict:
    """``fq_rns_mul`` and ``fq_rns_pow`` against their plain versions at the
    coin epoch's mean and widest launch widths (rows beyond 65,536 repeat
    65,536 distinct lazy rows); returns the widths checked."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K

    def rows(n):
        base = torch.as_tensor(lazy_rows(rng, min(n, 1 << 16), R)[0], device=dev)
        return base.repeat((-(-n // base.shape[0]), 1))[:n].contiguous()

    checked = {}
    for name in ("fq_rns_mul", "fq_rns_pow"):
        mean = max(1, lanes[name] // max(1, launches[name]))
        checked[name] = sorted({mean, widest[name]})
        for n in checked[name]:
            a = rows(n)
            if name == "fq_rns_mul":
                b = torch.flip(a, dims=(0,)).contiguous()
                got, want = K.mul(a, b), K.mul_plain(a, b)
            else:
                got, want = K.pow_fixed(a, Q - 2), K.pow_plain(a, Q - 2)
            errs[name] = max(errs[name], same(f"{name} (coin epoch, {n} lanes)", got, want))
            del a, got, want
            torch.cuda.empty_cache()
    return checked


def kernel_rows(dev, rng, errs: dict, launches: dict, lanes: dict, n_pow: int) -> list:
    """Hold each kernel against its plain version at the main path's
    widths (one lane and its mean launch width; for fq_rns_pow, whose
    launches are 1 to ~4k lanes wide and none at the mean, POW_WIDTHS and
    the widest launch), then time both there beside the bound."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K

    rows = []
    e = Q - 2
    n_mul = max(1, lanes["fq_rns_mul"] // max(1, launches["fq_rns_mul"]))
    for n in (*MUL_WIDTHS, n_mul):
        a = torch.as_tensor(lazy_rows(rng, n, R)[0], device=dev)
        b = torch.flip(a, dims=(0,)).contiguous()
        for reduced in (False, True):
            x, y = (K.mul_plain(a, a), K.mul_plain(b, b)) if reduced else (a, b)
            # a one-row operand on either side is read at lane stride 0
            for tag, u, v in (("", x, y), (" (79,) x rows", x[n // 2], y),
                              (" rows x (1, 79)", x, y[n // 3 : n // 3 + 1])):
                errs["fq_rns_mul"] = max(errs["fq_rns_mul"], same(
                    f"fq_rns_mul reduced={reduced}{tag}", K.mul(u, v, reduced=reduced),
                    K.mul_plain(u, v, reduced=reduced)))
    pows = {}
    for n in (*POW_WIDTHS, n_pow):
        x = pows[n] = torch.as_tensor(lazy_rows(rng, n, R)[0], device=dev)
        errs["fq_rns_pow"] = max(errs["fq_rns_pow"], same(
            "fq_rns_pow e=Q-2", K.pow_fixed(x, e), K.pow_plain(x, e)))
    x1, x = pows[1], pows[n_pow]

    ms = time_ms(lambda: K.mul(a, b))
    plain_ms = time_ms(lambda: K.mul_plain(a, b))
    bound_ms, bound_by = bound(n_mul, 1, MUL_EW_OPS, 3)
    rows.append({
        "name": "fq_rns_mul", "route": "cuda", "source": "hbbft_tpu_torch/csrc/fq_rns.cu",
        "replaces": "hbbft_tpu/ops/fq_rns_pallas.py:259",
        "launches": launches["fq_rns_mul"], "max_abs_err": errs["fq_rns_mul"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "path": "epoch", "lanes": n_mul,
    })

    ms_1 = time_ms(lambda: K.pow_fixed(x1, e), reps=5)
    ms = time_ms(lambda: K.pow_fixed(x, e), reps=5)
    plain_ms = time_ms(lambda: K.pow_plain(x, e), reps=3)
    log(f"fq_rns_pow e=Q-2: {ms_1:.4f} ms at 1 lane, {ms:.4f} ms at {n_pow} lanes "
        f"(the epoch's widest launch), one call each")
    products = (e.bit_length() - 1) + (bin(e).count("1") - 1)
    bound_ms, bound_by = bound(n_pow, products, products * MUL_EW_OPS_REDUCED + 79 * 4, 2)
    rows.append({
        "name": "fq_rns_pow", "route": "cuda", "source": "hbbft_tpu_torch/csrc/fq_rns.cu",
        "replaces": "hbbft_tpu/ops/fq_rns_pallas.py:276",
        "launches": launches["fq_rns_pow"], "max_abs_err": errs["fq_rns_pow"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "path": "epoch", "lanes": n_pow, "ms_1_lane": ms_1,
    })
    return rows


def tower_kernel_rows(dev, rng, errs: dict, launches: dict, lanes: dict) -> list:
    """The fused tower kernels at the main path's mean launch width: held
    to their plain versions there, then timed beside the bound.  The op
    kernel runs the kind the main path runs, fq12_mul (the cross-pair
    merge).  The bound counts the Fq products (``bound``'s per-product
    work); the recombination adds between them are left out, so it is a
    little low."""
    from hbbft_tpu_torch.ops import pairing_chain as PC, tower_fused as TF
    from hbbft_tpu_torch.ops import tower_fused_cuda as TK

    width = {k: max(1, lanes[k] // max(1, launches[k])) for k in ("tower_op", "miller_dbl",
                                                                   "hard_exp")}
    src, ref = "hbbft_tpu_torch/csrc/tower_fused.cu", "hbbft_tpu/ops/tower_fused.py"
    rows = []

    def row(name, replaces, n, products, rows_moved, fn, plain, got, want, reps=7):
        errs[name] = max(errs.get(name, 0.0), *(same(f"{name} (mean width)", g, w)
                                       for g, w in zip(got, want)))
        ms = time_ms(fn, reps=reps)
        plain_ms = time_ms(plain, reps=min(reps, 3))
        bound_ms, bound_by = bound(n, products, products * MUL_EW_OPS, rows_moved)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": f"{ref}:{replaces}",
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": "epoch", "lanes": n,
        })

    n = width["tower_op"]
    a, b = tower_inputs(dev, rng, 12, n), tower_inputs(dev, rng, 12, n)
    k = TF.OP_KINDS.index("fq12_mul")
    row("tower_op", 420, n, 54, 36, lambda: TK.tower_op(k, a, b),
        lambda: TF.op_plain("fq12_mul", a, b),
        [TK.tower_op(k, a, b)], [TF.op_plain("fq12_mul", a, b)])

    n = width["miller_dbl"]
    check_dbl_widths(dev, rng, n, errs)
    f, r, p = (tower_inputs(dev, rng, c, n) for c in (12, 6, 2))
    row("miller_dbl", 515, n, PC.DBL_FIELD_MULS, 38, lambda: TK.miller_dbl(f, r, p),
        lambda: TF.dbl_plain(f, r, p), TK.miller_dbl(f, r, p), TF.dbl_plain(f, r, p))

    n = width["hard_exp"]
    check_hard_widths(dev, rng, errs)
    m = tower_inputs(dev, rng, 12, n)
    row("hard_exp", 619, n, TF.analytic_hard_field_muls(), 24, lambda: TK.hard_exp(m),
        lambda: TF.hard_plain(m), [TK.hard_exp(m)], [TF.hard_plain(m)], reps=5)
    return rows


def limb_kernel_rows(dev, rng, errs: dict, launches: dict, lanes: dict) -> list:
    """The limb kernels at the limb arm's mean launch widths: held to their
    plain versions there, then timed beside the bound."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_limb as L, fq_limb_cuda as LK

    e = Q - 2
    n_mul = max(1, lanes["fq_limb_mul"] // max(1, launches["fq_limb_mul"]))
    n_pow = max(1, lanes["fq_limb_pow"] // max(1, launches["fq_limb_pow"]))
    a = torch.as_tensor(lazy_rows(rng, n_mul, L)[0], device=dev)
    b = torch.flip(a, dims=(0,)).contiguous()
    x = torch.as_tensor(lazy_rows(rng, n_pow, L)[0], device=dev)
    errs["fq_limb_mul"] = max(errs["fq_limb_mul"], same(
        "fq_limb_mul (limb arm's mean width)", LK.mul(a, b), LK.mul_plain(a, b)))
    errs["fq_limb_pow"] = max(errs["fq_limb_pow"], same(
        "fq_limb_pow e=Q-2 (limb arm's mean width)", LK.pow_fixed(x, e), LK.pow_plain(x, e)))
    products = (e.bit_length() - 1) + (bin(e).count("1") - 1)
    common = {"route": "cuda", "source": "hbbft_tpu_torch/csrc/fq_limb.cu",
              "library_ms": None, "path": "limb arm"}
    rows = []
    bound_ms, bound_by = roofline(n_mul * 3 * LIMB_ROW_BYTES, n_mul * LIMB_MUL_OPS,
                                  n_mul * LIMB_CORE_TC_OPS)
    rows.append({
        "name": "fq_limb_mul", **common, "replaces": "hbbft_tpu/ops/fq_pallas.py:182",
        "launches": launches["fq_limb_mul"], "max_abs_err": errs["fq_limb_mul"],
        "ms": time_ms(lambda: LK.mul(a, b)), "plain_ms": time_ms(lambda: LK.mul_plain(a, b)),
        "bound_ms": bound_ms, "bound_by": bound_by, "lanes": n_mul,
    })
    # a throughput bound: the products of a lane are serial, which it does
    # not count
    bound_ms, bound_by = roofline(n_pow * 2 * LIMB_ROW_BYTES,
                                  n_pow * (products * LIMB_CORE_OPS + LIMB_CARRY3_50),
                                  n_pow * products * LIMB_CORE_TC_OPS)
    rows.append({
        "name": "fq_limb_pow", **common, "replaces": "hbbft_tpu/ops/fq_pallas.py:255",
        "launches": launches["fq_limb_pow"], "max_abs_err": errs["fq_limb_pow"],
        "ms": time_ms(lambda: LK.pow_fixed(x, e), reps=5),
        "plain_ms": time_ms(lambda: LK.pow_plain(x, e), reps=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "lanes": n_pow,
        "serial_products": products,
    })
    log(f"fq_limb_pow e=Q-2: {products} serial products a lane at {n_pow} lanes")
    return rows


def bench_kernel_rows(dev, rng, seed: int, errs: dict, launches: dict, lanes: dict,
                      bench: dict) -> list:
    """The RNS chain and the FMA probe at the kernel bench's mean launch
    widths (the chain at the bench's products per launch, the probe at its
    steps): held to their plain versions there, then timed beside the
    bound."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K, probe_cuda as PK

    rows = []
    chain = bench["chain"]
    n = max(1, lanes["fq_rns_chain"] // max(1, launches["fq_rns_chain"]))
    a = torch.as_tensor(lazy_rows(rng, n, R)[0], device=dev)
    b = torch.flip(a, dims=(0,)).contiguous()
    errs["fq_rns_chain"] = max(errs["fq_rns_chain"], same(
        f"fq_rns_chain n={chain} (bench's mean width)", K.mul_chain(a, b, chain),
        K.mul_chain_plain(a, b, chain)))
    bound_ms, bound_by = bound(n, chain, chain * MUL_EW_OPS_REDUCED + 79 * 2 * 4, 3)
    rows.append({
        "name": "fq_rns_chain", "route": "cuda", "source": "hbbft_tpu_torch/csrc/fq_rns.cu",
        "replaces": "hbbft_tpu/ops/fq_rns_pallas.py:263", "launches": launches["fq_rns_chain"],
        "max_abs_err": errs["fq_rns_chain"],
        "ms": time_ms(lambda: K.mul_chain(a, b, chain), reps=5),
        "plain_ms": time_ms(lambda: K.mul_chain_plain(a, b, chain), reps=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "path": "bench",
        "lanes": n,
    })

    shape, iters = tuple(bench["probe"]["shape"]), bench["probe"]["iters"]
    check_probe(dev, seed, shape, iters, errs)
    x = torch.as_tensor(np.random.default_rng(seed).random(shape, dtype=np.float32), device=dev)
    numel = x.numel()
    # the chains' starting products and the seven sums beside the steps
    bound_ms, bound_by = roofline(8 * numel, PK.flops(numel, iters) + 15 * numel)
    rows.append({
        "name": "fma_probe", "route": "cuda", "source": "hbbft_tpu_torch/csrc/probe.cu",
        "replaces": "tools/kernel_bench.py:160", "launches": launches["fma_probe"],
        "max_abs_err": errs["fma_probe"], "ms": time_ms(lambda: PK.fma_probe(x, iters), reps=5),
        "plain_ms": time_ms(lambda: PK.probe_plain(x, iters), reps=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "path": "bench",
        "lanes": numel,
    })
    return rows


def kernel_fns() -> dict:
    """Every kernel's wrapper (each counts its launches), by kernel name."""
    from hbbft_tpu_torch.ops import fq_limb_cuda as LK, fq_rns_cuda as K, probe_cuda as PK
    from hbbft_tpu_torch.ops import tower_fused_cuda as TK

    return {"fq_rns_mul": K.mul, "fq_rns_pow": K.pow_fixed, "tower_op": TK.tower_op,
            "miller_dbl": TK.miller_dbl, "hard_exp": TK.hard_exp,
            "fq_limb_mul": LK.mul, "fq_limb_pow": LK.pow_fixed,
            "fq_rns_chain": K.mul_chain, "fma_probe": PK.fma_probe}


def reset_launches() -> None:
    from hbbft_tpu_torch.ops import fq_limb_cuda as LK, fq_rns_cuda as K, probe_cuda as PK
    from hbbft_tpu_torch.ops import tower_fused_cuda as TK

    for mod in (K, TK, LK, PK):
        mod.reset_launches()


def read_launches(what: str, names) -> tuple:
    """(launches, lanes) of the kernels ``names`` since the last reset;
    raises unless each of them launched."""
    fns = kernel_fns()
    launches = {k: fns[k].launches for k in names}
    lanes = {k: fns[k].lanes for k in names}
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on {what}")
    log(f"launches on {what}: {json.dumps(launches)}; lanes: {json.dumps(lanes)}")
    return launches, lanes


#: name prefixes of the hand-written kernels in a profiler trace
OUR_KERNELS = ("fq_rns_mul", "fq_rns_pow", "tower_op", "miller_dbl", "hard_exp")


@contextmanager
def profiled(name: str, card: str, stats: dict):
    """Run the body under torch.profiler (device activity only: recording
    every host op would slow the eager path far more than it costs to
    run) and put into ``stats[name]`` the wall time, the device's kernel
    time and busy share, the hand-written kernels' share, and the kernels
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e6
    ours = sum(e.self_device_time_total for e in kernels
               if e.key.startswith(OUR_KERNELS)) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    by_kernel = {k: sum(e.self_device_time_total for e in kernels if e.key.startswith(k)) / 1e6
                 for k in OUR_KERNELS}
    stats[name] = {
        "wall_s": wall, "kernel_s": total, "busy_share": total / wall,
        "our_kernel_s": ours, "our_kernel_s_by_name": by_kernel,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [(e.key[:100], e.count, e.self_device_time_total / 1e6) for e in top],
    }
    log(f"profile {name} [{card}]: wall {wall:.3f} s, kernels {total:.3f} s "
        f"(busy {total / wall:.1%}), hand-written kernels {ours:.3f} s "
        f"({json.dumps(by_kernel)}), {stats[name]['kernel_launches']} kernel launches")


def profile_main(rng, seed: int, card: str, out_path: str) -> dict:
    """Phases 3 and 4 once more under torch.profiler: each backend phase of
    the threshold-decryption path, then one whole N=100 epoch."""
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet
    from hbbft_tpu_torch.ops.backend import TorchBackend

    stats: dict = {}

    def traced(name):
        return nullcontext() if name == "host_setup" else profiled(name, card, stats)

    phase_main(TorchBackend(), rng, N, (N - 1) // 3, VERIFY_ITEMS, COMBINES, FORGED,
               wrap=traced)
    net = ArrayHoneyBadgerNet(range(N), backend=TorchBackend(), seed=seed)
    contribs = {nid: net.rng.getrandbits(8 * PAYLOAD).to_bytes(PAYLOAD, "big")
                for nid in net.ids}
    with profiled("epoch", card, stats):
        batches = net.run_epoch(contribs)
    if any(b.contributions != contribs for b in batches.values()):
        raise AssertionError("the profiled epoch's Batches are wrong")
    with open(out_path, "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="run phases 3 and 4 again under torch.profiler")
    # the limb arm's child process (phase_limb_arm starts it)
    ap.add_argument("--limb-arm", nargs=2, metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if args.limb_arm:
        sys.path.insert(0, ROOT)
        try:
            return limb_arm_child(*args.limb_arm)
        except Exception:
            traceback.print_exc()
            return 1
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script needs the card")
        return 2
    if not os.path.isdir(os.path.join(ROOT, "hbbft_tpu_torch")):
        log("chip_smoke: the hbbft_tpu_torch package is not beside this script")
        return 2
    sys.path.insert(0, ROOT)

    from hbbft_tpu_torch.ops import fq_limb_cuda as LK, fq_rns_cuda as K, probe_cuda as PK
    from hbbft_tpu_torch.ops import tower_fused_cuda as TK
    from hbbft_tpu_torch.ops.backend import TorchBackend
    from hbbft_tpu_torch.tools import kernel_bench
    from hbbft_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    card = kernel_bench.card_line(dev)
    rng = random.Random(args.seed)
    secs = {}
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    try:
        t = time.perf_counter()
        sources = ["fq_rns", "tower_fused", "fq_limb", "probe"]
        built = cuda_build.build(sources)  # one nvcc each, all started together
        for mod in (K, TK, LK, PK):
            mod.build()
        secs["build"] = time.perf_counter() - t
        log(f"build: {built} ({secs['build']:.2f} s)")
        result["build"] = kernel_bench.build_report(dev, log, sources)

        t = time.perf_counter()
        errs = phase_kernels(dev, rng, MUL_LANES, POW_LANES)
        check_tower_kernels(dev, rng, TOWER_WIDTHS, errs)
        check_limb_kernels(dev, rng, LIMB_WIDTHS, errs)
        check_chain_kernel(dev, rng, CHAIN_WIDTHS, errs)
        check_probe(dev, args.seed, PK.REF_SHAPE, PK.REF_ITERS, errs)
        secs["kernels"] = time.perf_counter() - t

        backend = TorchBackend()
        reset_launches()
        t = time.perf_counter()
        state: dict = {}
        path_res = phase_main(backend, rng, N, (N - 1) // 3, VERIFY_ITEMS, COMBINES, FORGED,
                              keep=state)
        torch.cuda.synchronize()
        secs["path"] = time.perf_counter() - t
        path_launches, _ = read_launches("the threshold-decryption path", EPOCH_KERNELS)

        t = time.perf_counter()
        stacked_res = phase_stacked_arm(state, 2 * N * (N - 1))
        secs["stacked_arm"] = time.perf_counter() - t

        t = time.perf_counter()
        limb_res = phase_limb_arm(state, LIMB_ARM_ITEMS, card)
        secs["limb_arm"] = time.perf_counter() - t

        sig_backend = TorchBackend()
        reset_launches()
        t = time.perf_counter()
        sig_res = phase_sig(sig_backend, rng, state, VERIFY_ITEMS, FORGED, card)
        torch.cuda.synchronize()
        secs["sig_path"] = time.perf_counter() - t
        sig_res["launches"], sig_res["lanes"] = read_launches("the sig path", EPOCH_KERNELS)
        del state

        epoch_backend = TorchBackend()
        reset_launches()
        t = time.perf_counter()
        epoch_res = phase_epoch(epoch_backend, args.seed, N, EPOCHS, card)
        torch.cuda.synchronize()
        secs["epoch_phase"] = time.perf_counter() - t
        launches, lanes = read_launches("the main path (whole N=100 epochs)", EPOCH_KERNELS)
        widths = {"fq_rns_mul": dict(sorted(K.mul.widths.items())),
                  "fq_rns_pow": dict(sorted(K.pow_fixed.widths.items()))}
        widest_pow = K.pow_fixed.widest
        log(f"epoch fq_rns_mul launch widths (key b: [2^(b-1), 2^b) lanes -> launches): "
            f"{json.dumps(widths['fq_rns_mul'])}; one-row operands at lane stride 0 in "
            f"{K.mul.broadcast_launches} of {K.mul.launches} launches; fq_rns_pow's "
            f"widest launch {widest_pow} lanes")
        result["fq_rns_mul_broadcast_launches"] = K.mul.broadcast_launches

        peak_before_coin = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        coin_backend = TorchBackend()
        reset_launches()
        t = time.perf_counter()
        coin_res = phase_epoch(coin_backend, args.seed + 2, N, 1, card, coin_rounds=COIN_ROUNDS)
        torch.cuda.synchronize()
        secs["coin_epoch"] = time.perf_counter() - t
        coin_launches, coin_lanes = read_launches(
            f"the coin epoch (N={N}, coin_rounds={COIN_ROUNDS})", EPOCH_KERNELS)
        coin_widest = {"fq_rns_mul": K.mul.widest, "fq_rns_pow": K.pow_fixed.widest}
        coin_res.update(
            launches=coin_launches, lanes=coin_lanes, widest=coin_widest,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
            launch_widths_log2={"fq_rns_mul": dict(sorted(K.mul.widths.items())),
                                "fq_rns_pow": dict(sorted(K.pow_fixed.widths.items()))})
        log(f"coin epoch [{card}]: phase seconds "
            f"{json.dumps(coin_res['epochs'][0]['report']['phase_seconds'])}; peak device "
            f"memory {coin_res['peak_memory_bytes']} bytes; widest launches "
            f"{json.dumps(coin_widest)}; launch widths (key b: [2^(b-1), 2^b) lanes -> "
            f"launches) {json.dumps(coin_res['launch_widths_log2'])}")
        t = time.perf_counter()
        coin_res["checked_widths"] = check_coin_widths(dev, rng, errs, coin_launches,
                                                       coin_lanes, coin_widest)
        secs["coin_widths"] = time.perf_counter() - t

        reset_launches()
        t = time.perf_counter()
        bench_res = kernel_bench.run(dev, log=log)
        torch.cuda.synchronize()
        secs["bench"] = time.perf_counter() - t
        bench_launches, bench_lanes = read_launches("the kernel bench", BENCH_KERNELS)

        t = time.perf_counter()
        rows = kernel_rows(dev, rng, errs, launches, lanes, widest_pow)
        rows += tower_kernel_rows(dev, rng, errs, launches, lanes)
        for r in rows:  # the coin epoch's launches beside the two epochs'
            r["coin_launches"] = coin_launches[r["name"]]
        rows += limb_kernel_rows(dev, rng, errs, limb_res["launches"], limb_res["lanes"])
        rows += bench_kernel_rows(dev, rng, args.seed, errs, bench_launches, bench_lanes,
                                  bench_res)
        secs["timing"] = time.perf_counter() - t
        prof = None
        if args.profile:
            t = time.perf_counter()
            prof = profile_main(rng, args.seed + 1, card,
                                os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.json"))
            secs["profile"] = time.perf_counter() - t
    except Exception:
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1

    c = backend.counters
    result.update({
        "n": N, "f": (N - 1) // 3, "path": path_res, "path_launches": path_launches,
        "stacked_arm": stacked_res, "limb_arm": limb_res, "sig_path": sig_res,
        "epoch": epoch_res, "coin_epoch": coin_res,
        "bench": bench_res, "phase_seconds": secs,
        "path_device_dispatches": c.device_dispatches, "path_pairing_checks": c.pairing_checks,
        "path_rlc_groups": c.rlc_groups, "kernels": rows, "launch_widths_log2": widths,
        "peak_memory_bytes": max(peak_before_coin, torch.cuda.max_memory_allocated(dev)),
        "profile": prof,
    })
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log(f"threshold-decryption path N={N}, f={(N - 1) // 3} [{card}]: seconds "
        f"{json.dumps(path_res['seconds'])}")
    log(f"seconds per N={N} epoch [{card}]: "
        f"{json.dumps([e['seconds'] for e in epoch_res['epochs']])}")
    log(f"limb arm N={N}, f={(N - 1) // 3} [{card}]: seconds "
        f"{json.dumps(limb_res['seconds'])}")
    log(f"sig path N={N} [{card}]: seconds {json.dumps(sig_res['seconds'])}; launches "
        f"{json.dumps(sig_res['launches'])}")
    log(f"coin epoch N={N}, coin_rounds={COIN_ROUNDS} [{card}]: "
        f"{coin_res['epochs'][0]['seconds']:.3f} s, phase seconds "
        f"{json.dumps(coin_res['epochs'][0]['report']['phase_seconds'])}, device seconds "
        f"{json.dumps(coin_res['device_seconds'])}, launches {json.dumps(coin_launches)}, "
        f"lanes {json.dumps(coin_lanes)}, peak memory {coin_res['peak_memory_bytes']} bytes")
    log(f"phase seconds [{card}]: {json.dumps(secs)}")
    log(f"path device_dispatches={c.device_dispatches} pairing_checks={c.pairing_checks} "
        f"rlc_groups={c.rlc_groups} peak_memory_bytes={result['peak_memory_bytes']} [{card}]")
    log(f"launch widths (key b: [2^(b-1), 2^b) lanes -> launches): {json.dumps(widths)}")
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "lanes"} for r in rows]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
