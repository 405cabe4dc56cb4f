#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # one H100; builds the kernels at first use

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every kernel source of hbbft_tpu_torch/csrc/ in
             parallel, one process each (fq_rns.cu: the RNS field multiply,
             power and chain; tower_fused.cu: the fused tower op, Miller
             doubling and final-exponentiation hard part; fq_limb.cu: the
             limb field multiply and power; probe.cu: the FMA probe;
             sha256.cu: the tagged SHA-256 and the Merkle proof walk;
             gf256.cu: the GF(2^8) bit product).
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
             The erasure/hash plane's kernels bit for bit against their
             plain versions, with samples against hashlib and the host
             GF(2^8) product: ``sha256_tagged`` at one message, 1,001 node
             pairs and the leaf lengths SHA_LENGTHS; ``gf256_matmul`` at one
             column, ragged blocks and the epoch's codec (its encode matrix
             and the decode matrix of a random erasure pattern).
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
             must output the same Batch holding every contribution, the
             RS/Merkle plane must have run on the device (``sha256_tagged``,
             ``sha256_proofs`` and ``gf256_matmul`` launched, device seconds
             of kinds ``rs_enc`` and ``merkle``), and the native host kernels
             (round 3's re-commit) must have been built.
   kill switch — one N=100 epoch on a fresh net with the same seed under
             HBBFT_TPU_NO_DEVICE_RS=1: the plane arm's first Batch and
             EpochReport counts, no plane kernel launched, 3 + N dispatches
             fewer; both arms' ``host_bucket_rs_merkle`` and
             ``device_dispatches`` per epoch are logged.
   coin epoch — one N=100 epoch with ``coin_rounds=1`` (binary agreement
             on split inputs: one real threshold-sign coin round per
             instance): the same Batch checks, the coin's counts in the
             ``EpochReport`` (10,000 signs, 990,000 share verifies, 10,000
             combines), the native hash-to-G2 built; then ``fq_rns_mul`` and
             ``fq_rns_pow`` against their plain versions at the coin path's
             mean and widest launches.
   era     — the era machinery at ERA_N=32 (``--era-n``): on its own
             ``TorchBackend()``, ``ArrayHoneyBadgerNet(range(N), ...,
             dynamic=True)`` runs the sequence of ``run_epochs(2,
             churn_at=[1])`` (an epoch, the vote → batched DKG → era
             turnover, an epoch under the new keys), split at the turnover
             so the era change is read on its own: the same Batch checks,
             era 1 with a new master key, the churn report's N², N³, N²+N³
             and N·(N−1) counts, the DKG's device seconds, all five epoch
             kernels launched during the era change; then checkpoint →
             restore onto a fresh backend (byte-equal re-encoding, the same
             next epoch), ``fq_rns_mul``/``fq_rns_pow`` against their plain
             versions at the era change's mean and widest launches, and the
             device MSM ``g1_lincomb`` against a host fold (64 terms) and
             the seam's default (2·``device_lane_cap``+5 terms: two device
             chunks and a host tail).  ``--era-only`` builds and runs this
             phase alone.
   object  — the object runtime: HoneyBadger over the port's VirtualNet
             (``NetBuilder(range(N)).num_faulty(f).defer_mode("round")``,
             every epoch encrypted, net seed OBJECT_SEED, OBJECT_TXNS
             transactions of OBJECT_TX_BYTES bytes a node from ``--seed``)
             at OBJECT_SHAPES (N=32, f=10, one epoch; N=4, f=1, ten
             epochs) on ``TorchBackend()``, then on the port's
             ``MockBackend``: the same Batches (every correct node's
             transactions in them), ``messages_delivered`` and ``cranks``
             epoch for epoch and the same work counts (N² ciphertext checks
             and N²(f+1) combined shares an epoch when every proposal is
             in); per epoch the seconds, dispatches, device seconds by kind
             and the host split (``HostSplit``); all five epoch kernels
             launched; then each of the five against its plain version
             at the phase's mean and widest launches.
             ``--object-only`` builds and runs this phase alone.
   bench   — the port's kernel bench (``hbbft_tpu_torch.tools.kernel_bench``)
             at its default widths: M muls/s of both field arms and the RNS
             chain, TFLOP/s of the FMA probe.
             Kernel launch counts are zeroed just before each of phases 3,
             limb arm (in the child), sig path, 4, coin epoch, the era
             change, object and bench, and read just after; every kernel of
             the path must have launched.
5. a ``{"kernels": [...]}`` line, one row per kernel: launches on its own
   path (epoch, limb arm or bench; the epoch kernels also carry their
   launches on the coin epoch, ``coin_launches``, and during the era
   change, ``era_launches``; every row its launches on the object phase,
   ``object_launches``, and each epoch kernel that phase's mean and widest
   launch, ``object_mean_lanes`` and ``object_widest_lanes``; the plane's
   kernels are held at the epoch's
   own shapes first: a whole tree build, the N² proof walk with corrupted
   roots and leaf), largest difference from the plain
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
import hashlib
import json
import os
import random
import subprocess
import sys
import threading
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
#: 32-bit integer operations outside the tensor cores: an SM issues 64 a
#: clock, half its 128 float32 lanes, so a quarter of the float32 rate
#: (which counts an FMA as two): ~16.7 T ops/s at the same clock
INT32_OPS = FP32_FLOPS / 4

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
#: the era phase's N: 32 (f=10), the reference's n32_churn window step.
#: Cut from the repo's N=100, whose era change is ~30x the work: 3,306 s on
#: an H100 80GB HBM3 at 700 W, 2,636 s of it host hash-to-G2 (PERF.md §5),
#: far more than the smoke's time limit; ``--era-n`` sets it.
ERA_N = 32
#: g1_lincomb's terms held against a pure host fold of g1_mul
LINCOMB_SAMPLE = 64
#: the object runtime's shapes (N, f, epochs), both cut from BASELINE's N=100,
#: whose object-runtime epoch is 6.94M deliveries of host Python (the array
#: engine carries N=100): N=32 is the widest the object runtime routes
#: through every device method (an instance combines f+1 = 11 shares, at
#: least ``device_combine_threshold``); N=4 is BASELINE config 1
#: (examples/simulation.rs: 4 nodes, f=1, 100 transactions a batch).
OBJECT_SHAPES = ((32, 10, 1), (4, 1, 10))
#: the object runtime's net seed (key generation, the faulty set, the
#: random scheduler's draws); the transactions come from ``--seed``
OBJECT_SEED = 11
OBJECT_TXNS = 25  # transactions a node proposes an epoch
OBJECT_TX_BYTES = 10

#: the erasure/hash plane at the epoch's N: k = N - 2f data and m = 2f
#: parity shards; 128-byte contributions frame to ~283 bytes, shards of 9
#: bytes (the checks before the epoch; after it the widths are read from
#: its launches)
RS_K, RS_M = N - 2 * ((N - 1) // 3), 2 * ((N - 1) // 3)
SHARD_LEN = 9
#: leaf lengths the tagged hash is checked at: tag + 54 data bytes + 9 pad
#: bytes fill one block, 55 need two; 118 two, 119 three
SHA_LENGTHS = (0, 9, 54, 55, 118, 119, 200)
#: 32-bit integer instructions of one SHA-256 compression on sm_90a, the
#: least csrc/sha256.cu's arithmetic needs: a rotate or shift is one SHF,
#: any boolean function of three words one LOP3, a sum of three words one
#: IADD3.  48 schedule words x 10 (each sigma 2 SHF + SHR + LOP3; w + s0 +
#: w7 + s1 two adds), 64 rounds x 14 (each Sigma 3 SHF + LOP3; ch and maj
#: one LOP3 each; t1 = h + S1 + ch + K + w two IADD3, e = d + t1 one, a =
#: t1 + S0 + maj one), 8 final adds
SHA_OPS = 48 * 10 + 64 * 14 + 8


def gf_ops(k: int) -> int:
    """32-bit integer instructions of one output bit of ``gf256_matmul``
    with k input bytes (csrc/gf256.cu): one LOP3 (acc ^ (row & col)) per
    packed word, then the popcount, the & 1 and the OR into the output
    byte."""
    return -(-k // 4) + 3


#: the kernels, by the path whose launches each row reports
EPOCH_KERNELS = ("fq_rns_mul", "fq_rns_pow", "tower_op", "miller_dbl", "hard_exp")
RS_KERNELS = ("sha256_tagged", "sha256_proofs", "gf256_matmul")
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


def roofline(nbytes: float, fp32_ops: float, tc_ops: float = 0.0,
             int_ops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the largest of the time to move ``nbytes``,
    the time of the int8 tensor-core operations, the time of the float32
    operations and the time of the 32-bit integer operations, each at its
    peak (the tensor cores and the two pipes run at once, so the operations
    take the longest of the three)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tc_ops / INT8_TC_OPS, fp32_ops / FP32_FLOPS, int_ops / INT32_OPS)
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


def same_bytes(name: str, got, want) -> float:
    """max |kernel - plain| over byte or boolean results; raises unless the
    two are equal element for element."""
    import torch

    if got.is_cuda:
        torch.cuda.synchronize()
    eq = torch.equal(got, want)
    e = float((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0.0
    log(f"{name}: {tuple(got.shape)}, max |kernel - plain| = {e}, same bits: {eq}")
    if not eq:
        raise AssertionError(f"{name} differs from its plain version")
    return e


def _hashlib_rows(name: str, msgs, tag: int, got) -> None:
    """The first, middle and last rows of a tagged hash against hashlib."""
    m, g = msgs.cpu().numpy(), got.cpu().numpy()
    for i in {0, len(m) // 2, len(m) - 1}:
        if g[i].tobytes() != hashlib.sha256(bytes([tag]) + m[i].tobytes()).digest():
            raise AssertionError(f"{name}: row {i} differs from hashlib")


def check_tagged(dev, rng, errs: dict, n: int, length: int, tag: int, what: str) -> None:
    """``sha256_tagged`` against its plain version and hashlib on n random
    messages of ``length`` bytes."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import sha256 as S

    msgs = torch.as_tensor(np.random.default_rng(rng.getrandbits(32)).integers(
        0, 256, size=(n, length), dtype=np.uint8), device=dev)
    got = S.sha256_tagged(msgs, tag)
    errs["sha256_tagged"] = max(errs.get("sha256_tagged", 0.0), same_bytes(
        f"sha256_tagged tag={tag} {what}", got, S.sha256_tagged_plain(msgs, tag)))
    _hashlib_rows(f"sha256_tagged {what}", msgs, tag, got)


def check_gf(dev, errs: dict, m, x_np, what: str) -> None:
    """``gf256_matmul`` of the GF matrix ``m`` on the bytes ``x_np`` against
    its plain version and the host codec's product."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.crypto.erasure import gf256
    from hbbft_tpu_torch.ops import gf256 as G

    words = torch.as_tensor(G.pack_gf_matrix(m), device=dev)
    x = torch.as_tensor(x_np, device=dev)
    got = G.gf256_matmul(words, x)
    errs["gf256_matmul"] = max(errs.get("gf256_matmul", 0.0), same_bytes(
        f"gf256_matmul {what}", got, G.gf256_matmul_plain(words, x)))
    if not np.array_equal(got.cpu().numpy(), gf256().matmul(m, x_np)):
        raise AssertionError(f"gf256_matmul {what} differs from the host GF(2^8) product")


def check_rs_plane_kernels(dev, rng, errs: dict) -> None:
    """The erasure/hash plane's kernels at their edges: the tagged hash at
    one message, a batch that is not a multiple of its 64-thread blocks and
    the leaf lengths around the block-count steps; the GF product at one
    column, a ragged column block, few rows, and the epoch's codec (encode
    matrix and the decode matrix of a random erasure pattern).  The epoch's
    own shapes are checked after the epoch (``rs_plane_rows``)."""
    import numpy as np

    from hbbft_tpu_torch.crypto.erasure import RSCodec, gf256

    check_tagged(dev, rng, errs, 1, 9, 0, "(1 message)")
    check_tagged(dev, rng, errs, 1001, 64, 1, "(1,001 node pairs)")
    for length in SHA_LENGTHS:
        check_tagged(dev, rng, errs, 67, length, 0, f"({length}-byte leaves)")
    nrs = np.random.default_rng(rng.getrandbits(32))
    for r, k, cols in ((1, 1, 1), (3, 5, 129), (9, 250, 257)):
        check_gf(dev, errs, nrs.integers(0, 256, size=(r, k), dtype=np.uint8),
                 nrs.integers(0, 256, size=(k, cols), dtype=np.uint8), f"{r}x{k} . {k}x{cols}")
    codec = RSCodec(RS_K, RS_M)
    x = nrs.integers(0, 256, size=(RS_K, N * SHARD_LEN), dtype=np.uint8)
    check_gf(dev, errs, codec.encode_matrix, x, f"(the epoch's {RS_M}x{RS_K} encode matrix)")
    missing = sorted(rng.sample(range(codec.n), RS_M))
    xs = [j for j in range(codec.n) if j not in missing][:RS_K]
    check_gf(dev, errs, gf256().lagrange_matrix(xs, missing), x,
             f"(a decode matrix, {RS_M} random erasures)")


def rs_plane_rows(dev, rng, errs: dict, launches: dict, lanes: dict, n: int = N) -> list:
    """The plane's kernels at the epoch's shapes, read from its launches:
    the GF product at its mean width (n encodes of one shard length: the
    columns are n · shard length), a whole tree build (every tagged-hash
    shape of the epoch) and the proof walk over the epoch's N² proofs with
    corrupted roots and a corrupted leaf (against the plain version and the
    host's native walk); then each timed at the path's mean width beside
    the plain version and the bound (``roofline``'s integer term:
    SHA_OPS a compression, ``gf_ops`` an output bit)."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.crypto.erasure import RSCodec
    from hbbft_tpu_torch.crypto.merkle import MerkleTree, PackedProofs, _depth
    from hbbft_tpu_torch.ops import gf256 as G, sha256 as S

    nrs = np.random.default_rng(rng.getrandbits(32))
    mean = {k: max(1, lanes[k] // max(1, launches[k])) for k in RS_KERNELS}
    cols = mean["gf256_matmul"]
    shard_len = max(1, cols // n)
    f = (n - 1) // 3
    k, m = n - 2 * f, 2 * f
    rows = []

    def row(name, source, replaces, fn, plain, width, nbytes, int_ops):
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=3)
        bound_ms, bound_by = roofline(nbytes, 0.0, int_ops=int_ops)
        rows.append({
            "name": name, "route": "cuda", "source": f"hbbft_tpu_torch/csrc/{source}",
            "replaces": f"none (jnp graph: hbbft_tpu/ops/{replaces})",
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": "epoch", "lanes": width,
        })

    codec = RSCodec(k, m)
    x_np = nrs.integers(0, 256, size=(k, cols), dtype=np.uint8)
    check_gf(dev, errs, codec.encode_matrix, x_np, f"(the epoch's mean width, {cols} columns)")
    words = torch.as_tensor(G.pack_gf_matrix(codec.encode_matrix), device=dev)
    x = torch.as_tensor(x_np, device=dev)
    # bytes: the m x k GF matrix, the input and the output (the packed bit
    # rows are the kernel's form of the matrix, not the function's input)
    row("gf256_matmul", "gf256.cu", "gf256.py:76 gf256_matmul",
        lambda: G.gf256_matmul(words, x), lambda: G.gf256_matmul_plain(words, x),
        cols, m * k + x.numel() + m * cols, 8 * m * cols * gf_ops(k))

    leaves = torch.as_tensor(nrs.integers(0, 256, size=(n, n, shard_len), dtype=np.uint8),
                             device=dev)
    check_tagged(dev, rng, errs, n * n, shard_len, 0, f"(the epoch's {n * n} leaves)")
    host_trees = [MerkleTree([bytes(v) for v in t]) for t in leaves.cpu().numpy()]
    for d, lvl in enumerate(S.tree_levels(leaves)):
        got = lvl.cpu().numpy()
        if any(got[t].tobytes() != b"".join(host_trees[t].levels[d]) for t in range(n)):
            raise AssertionError(f"tree level {d} differs from the host MerkleTree")
    log(f"tree_levels: {n} trees of {n} {shard_len}-byte leaves, every level equal to the "
        f"host MerkleTree's")
    n_tag = mean["sha256_tagged"]
    check_tagged(dev, rng, errs, n_tag, 64, 1, f"(the epoch's mean width, {n_tag} node pairs)")
    pairs = torch.as_tensor(nrs.integers(0, 256, size=(n_tag, 64), dtype=np.uint8), device=dev)
    row("sha256_tagged", "sha256.cu", "sha256.py:179 tree_levels",
        lambda: S.sha256_tagged(pairs, 1), lambda: S.sha256_tagged_plain(pairs, 1),
        n_tag, n_tag * (64 + 32), n_tag * S.compressions(64) * SHA_OPS)

    packed = PackedProofs.from_trees(host_trees, n, device=True)
    roots = np.array(packed.roots, copy=True)
    bad = sorted(rng.sample(range(len(packed)), 5))
    for i in bad[:4]:
        roots[i, rng.randrange(32)] ^= 1 << rng.randrange(8)
    leaves_p = np.array(packed.leaves, copy=True)
    leaves_p[bad[4], 0] ^= 0x80
    args = [torch.as_tensor(a, device=dev) for a in (leaves_p, packed.paths, packed.indices,
                                                     roots)]
    got = S.verify_proofs(*args)
    errs["sha256_proofs"] = max(errs.get("sha256_proofs", 0.0), same_bytes(
        f"sha256_proofs ({len(packed)} proofs, depth {packed.paths.shape[1]})", got,
        S.sha256_proofs_plain(*args)))
    host = PackedProofs(leaves_p, packed.paths, packed.indices, roots, n).validate(1)
    if got.cpu().tolist() != host or host != [i not in bad for i in range(len(packed))]:
        raise AssertionError("sha256_proofs disagrees with the host proof walk")
    log(f"sha256_proofs: {len(packed)} verdicts equal the host's native walk; the {len(bad)} "
        f"corrupted proofs (4 roots, 1 leaf) rejected")
    p, depth = len(packed), _depth(n)
    row("sha256_proofs", "sha256.cu", "sha256.py:213 verify_proofs",
        lambda: S.sha256_proofs(*args), lambda: S.sha256_proofs_plain(*args),
        p, p * (shard_len + 32 * depth + 4 + 32 + 1),
        p * (S.compressions(shard_len) + 2 * depth) * SHA_OPS)
    return rows


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


def draw_contributions(net) -> dict:
    """One epoch's contributions from the engine's RNG, as ``run_epochs``
    draws them."""
    return {nid: net.rng.getrandbits(8 * PAYLOAD).to_bytes(PAYLOAD, "big") for nid in net.ids}


def check_batches(batches: dict, ids, contribs: dict, what: str) -> None:
    """Every node output the same Batch, holding every contribution."""
    first = batches[ids[0]]
    if sorted(batches) != list(ids) or any(b != first for b in batches.values()):
        raise AssertionError(f"the nodes output different Batches ({what})")
    if first.contributions != contribs:
        raise AssertionError(f"the Batch does not hold every contribution ({what})")


def phase_epoch(backend, seed: int, n: int, epochs: int, card: str, coin_rounds: int = 0) -> dict:
    """Whole N-node epochs through the port's engine: every node must output
    the same Batch, holding every node's contribution.  With
    ``coin_rounds``, each epoch must also report the coin's counts and the
    native hash-to-G2 must have been built."""
    import torch

    from hbbft_tpu_torch import native
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet

    # build and load the host's native GF(2^8) and SHA-256 kernels first,
    # so that no timed epoch pays for them (round 3's re-commit on the
    # plane, the whole plane on the kill switch): both arms start warm
    t = time.perf_counter()
    if not (native.available() and native.sha256_available()):
        raise AssertionError("the native host kernels (gf256, sha256) were not built")
    log(f"native host kernels (gf256, sha256) built and loaded: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    net = ArrayHoneyBadgerNet(range(n), backend=backend, seed=seed, coin_rounds=coin_rounds)
    setup = time.perf_counter() - t
    log(f"epoch setup (N={n} key generation on the host): {setup:.2f} s")
    out = {"setup_seconds": setup, "epochs": []}
    for _ in range(epochs):
        contribs = draw_contributions(net)
        before = backend.counters.snapshot()
        t = time.perf_counter()
        batches = net.run_epoch(contribs)
        if backend.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        check_batches(batches, net.ids, contribs, f"epoch {net.epoch - 1}")
        first = batches[net.ids[0]]
        rep = dataclasses.asdict(net.reports[-1])
        after = backend.counters.snapshot()
        # the epoch's own share of the plane's counters, and its Batch as a
        # digest another arm's Batch is held to
        own = {k: after[k] - before[k] for k in (
            "device_dispatches", "host_bucket_rs_merkle", "device_seconds_rs_enc",
            "device_seconds_rs_dec", "device_seconds_merkle")}
        batch = hashlib.sha256(repr((first.epoch, sorted(first.contributions.items())))
                               .encode()).hexdigest()
        out["epochs"].append({"seconds": secs, "report": rep, "counters": own, "batch": batch})
        log(f"epoch {first.epoch} N={n} coin_rounds={coin_rounds} [{card}]: {secs:.3f} s, all "
            f"{n} nodes output the same Batch of {len(first.contributions)} contributions")
        log(f"  EpochReport: {json.dumps(rep)}")
        log(f"  the epoch's plane counters: {json.dumps(own)}")
        # the reference engine's accounting of a coin round: every node
        # signs every instance's document (n²), every receiver checks every
        # other sender's share (n²(n−1)) and combines once per instance (n²)
        coin = tuple(rep[k] for k in ("coin_rounds", "coin_signs", "sig_shares_verified",
                                      "sig_combines"))
        want = (coin_rounds, coin_rounds * n * n, coin_rounds * n * n * (n - 1),
                coin_rounds * n * n)
        if coin != want:
            raise AssertionError(f"the coin's counts are {coin}, not {want}")
    # the coin's documents were hashed on the native hash-to-G2
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


def phase_rs_kill_switch(seed: int, n: int, plane: dict, card: str, device=None) -> dict:
    """One epoch on a fresh net with the plane arm's seed under
    HBBFT_TPU_NO_DEVICE_RS=1: the plane arm's first Batch and the same
    EpochReport counts, none of the plane's kernels launched, and the plane
    arm's first epoch billing the reference's plane dispatches more (one
    encode, one tree build, one proof walk in round 1 and n in round 2)."""
    from hbbft_tpu_torch.ops.backend import TorchBackend

    os.environ["HBBFT_TPU_NO_DEVICE_RS"] = "1"
    try:
        reset_launches()
        res = phase_epoch(TorchBackend(device=device), seed, n, 1, card)
        launched = {k: kernel_fns()[k].launches for k in RS_KERNELS}
    finally:
        del os.environ["HBBFT_TPU_NO_DEVICE_RS"]
    (off,), on = res["epochs"], plane["epochs"][0]
    if off["batch"] != on["batch"]:
        raise AssertionError("the kill-switch epoch's Batch differs from the plane arm's")
    counts = [{k: v for k, v in e["report"].items() if k != "phase_seconds"} for e in (off, on)]
    if counts[0] != counts[1]:
        raise AssertionError(f"the kill-switch epoch's counts differ: {counts}")
    if any(launched.values()) or off["counters"]["device_seconds_merkle"]:
        raise AssertionError(f"the plane ran under HBBFT_TPU_NO_DEVICE_RS=1: {launched}")
    plane_dispatches = on["counters"]["device_dispatches"] - off["counters"]["device_dispatches"]
    if plane_dispatches != 3 + n:
        raise AssertionError(f"the plane billed {plane_dispatches} dispatches, not {3 + n}")
    res["plane_dispatches"] = plane_dispatches
    log(f"kill-switch epoch N={n} [{card}]: the plane arm's Batch and counts; host_bucket_"
        f"rs_merkle {off['counters']['host_bucket_rs_merkle']:.3f} s (plane arm's first epoch "
        f"{on['counters']['host_bucket_rs_merkle']:.3f} s), device_dispatches "
        f"{off['counters']['device_dispatches']} ({on['counters']['device_dispatches']}: "
        f"{plane_dispatches} of the plane), epoch {off['seconds']:.3f} s ({on['seconds']:.3f} s)")
    return res


def _counter_delta(before: dict, after: dict, prefix: str) -> dict:
    return {k[len(prefix):]: after[k] - before[k] for k in after
            if k.startswith(prefix) and after[k] != before[k]}


def _launch_counts(names) -> dict:
    fns = kernel_fns()
    return {k: fns[k].launches for k in names}


class HostSampler:
    """Where the host's time goes, by sampling: while active, a thread reads
    the calling thread's stack every ``interval`` seconds and counts the
    deepest frame inside the port's package (``file:function``; inside the
    DKG's own function, ``file:function:line``, which names its pure-Python
    field loops).  A sample outside the package counts as ``other``.  Its
    cost is one stack walk per interval."""

    def __init__(self, interval: float = 0.005) -> None:
        self.interval = interval
        self.counts: dict = {}
        self._stop = threading.Event()
        self._tid = threading.get_ident()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        pkg = f"{os.sep}hbbft_tpu_torch{os.sep}"
        while not self._stop.wait(self.interval):
            f = sys._current_frames().get(self._tid)
            key = "other"
            while f is not None:
                code = f.f_code
                if pkg in code.co_filename:
                    key = f"{os.path.basename(code.co_filename)}:{code.co_name}"
                    if code.co_name == "batched_era_dkg":
                        key += f":{f.f_lineno}"
                    break
                f = f.f_back
            self.counts[key] = self.counts.get(key, 0) + 1

    def __enter__(self) -> "HostSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def top(self, k: int = 25) -> list:
        """The k largest (frame, seconds) pairs, seconds = samples x interval."""
        items = sorted(self.counts.items(), key=lambda kv: -kv[1])[:k]
        return [(key, cnt * self.interval) for key, cnt in items]


def phase_era(seed: int, n: int, card: str, device=None) -> dict:
    """The era machinery through the port's engine: ``ArrayHoneyBadgerNet(
    range(n), TorchBackend(), seed, dynamic=True)`` runs the sequence of
    ``run_epochs(2, churn_at=[1])`` (one epoch under the dealer's keys, the
    vote → DKG → era turnover, one epoch under the DKG's keys) as its
    steps (``run_epoch`` on contributions drawn as ``run_epochs`` draws
    them, ``era_change``), so that the era change's own seconds, host
    buckets, device seconds, dispatches, peak memory and kernel launches
    are read; then ``checkpoint()`` onto a fresh backend and one more
    epoch on each.

    Raises unless every node outputs the same Batch holding every
    contribution in each epoch, ``era == 1`` with a new master key, the
    churn report counts N² parts, N³ acks, N²+N³ ciphertexts and N·(N−1)
    votes, the DKG's device time is positive, the restored engine
    re-encodes byte-equal and its next epoch equals the original's, and
    (on the card) all five epoch kernels launched during the era change."""
    import torch

    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet
    from hbbft_tpu_torch.ops.backend import TorchBackend
    from hbbft_tpu_torch.ops import fq_rns_cuda as K

    backend = TorchBackend(device)
    on_card = backend.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out: dict = {"n": n, "f": (n - 1) // 3}
    t = time.perf_counter()
    net = ArrayHoneyBadgerNet(range(n), backend=backend, seed=seed, dynamic=True)
    out["setup_seconds"] = time.perf_counter() - t
    master0 = net.pk_master
    if on_card:
        reset_launches()

    def epoch(what):
        contribs = draw_contributions(net)
        t = time.perf_counter()
        batches = net.run_epoch(contribs)
        sync()
        secs = time.perf_counter() - t
        check_batches(batches, net.ids, contribs, what)
        log(f"era phase N={n} {what} [{card}]: {secs:.3f} s, all {n} nodes output the same "
            f"Batch of {n} contributions")
        return secs

    out["epoch_seconds"] = [epoch("epoch 0, era 0")]
    launches = _launch_counts(EPOCH_KERNELS)

    # -- the era change, read on its own --------------------------------
    c0 = backend.counters.snapshot()
    if on_card:
        reset_launches()
        torch.cuda.reset_peak_memory_stats(backend.device)
    t = time.perf_counter()
    with HostSampler() as sampler:
        rep = net.era_change()
        sync()
    era_s = time.perf_counter() - t
    c1 = backend.counters.snapshot()
    era: dict = {"seconds": era_s, "report": dataclasses.asdict(rep)}
    if on_card:
        era["launches"], era["lanes"] = read_launches(f"the era change (N={n})", EPOCH_KERNELS)
        era["widest"] = {"fq_rns_mul": K.mul.widest, "fq_rns_pow": K.pow_fixed.widest}
        era["peak_memory_bytes"] = torch.cuda.max_memory_allocated(backend.device)
        launches = {k: launches[k] + era["launches"][k] for k in EPOCH_KERNELS}
        reset_launches()
    era["device_seconds"] = _counter_delta(c0, c1, "device_seconds_")
    era["host_buckets"] = _counter_delta(c0, c1, "host_bucket_")
    for k in ("device_dispatches", "hash_g2_seconds", "host_seconds", "pairing_checks",
              "signatures_verified", "ciphertexts_verified"):
        era[k] = c1[k] - c0[k]
    era["device_seconds_total"] = c1["device_seconds"] - c0["device_seconds"]
    era["host_samples"] = sampler.top()
    want = (n * n, n ** 3, n * n + n ** 3, n * (n - 1))
    got = (rep.kg_parts_handled, rep.kg_acks_handled, rep.ciphertexts_verified,
           rep.votes_verified)
    if got != want:
        raise AssertionError(f"the churn report counts {got}, not {want}")
    if net.era != 1 or net.pk_master == master0 or net.churn_reports != [rep]:
        raise AssertionError("the era did not turn over to a new master key")
    if not era["device_seconds"].get("dkg", 0) > 0:
        raise AssertionError("the DKG's ladders and MSMs did not run on the device")
    out["era_change"] = era
    log(f"era change N={n}, f={(n - 1) // 3} [{card}]: {era_s:.3f} s; churn report "
        f"{json.dumps(era['report'])}; host buckets {json.dumps(era['host_buckets'])}; "
        f"hash_g2_seconds {era['hash_g2_seconds']:.3f}; device seconds by kind "
        f"{json.dumps(era['device_seconds'])}; device_dispatches {era['device_dispatches']}; "
        f"peak device memory {era.get('peak_memory_bytes')} bytes; launches "
        f"{json.dumps(era.get('launches'))}; widest {json.dumps(era.get('widest'))}")
    log(f"era change N={n}, where the host's time went (sampled, seconds) [{card}]: "
        f"{json.dumps(era['host_samples'])}")

    out["epoch_seconds"].append(epoch("epoch 1, era 1"))
    if on_card:
        launches = {k: launches[k] + v for k, v in _launch_counts(EPOCH_KERNELS).items()}
    out["launches"] = launches

    # -- checkpoint/restore on the same device --------------------------
    t = time.perf_counter()
    blob = net.checkpoint()
    restored = ArrayHoneyBadgerNet.restore(blob, TorchBackend(device))
    if restored.checkpoint() != blob:
        raise AssertionError("the restored engine does not re-encode byte-equal")
    contribs = draw_contributions(net)
    if draw_contributions(restored) != contribs:
        raise AssertionError("the restored engine's RNG differs from the original's")
    after_restore = restored.run_epoch(contribs)
    after_original = net.run_epoch(contribs)
    sync()
    check_batches(after_restore, net.ids, contribs, "restored engine's next epoch")
    if after_restore[net.ids[0]] != after_original[net.ids[0]]:
        raise AssertionError("the restored engine's next epoch differs from the original's")
    out["checkpoint"] = {"bytes": len(blob), "seconds": time.perf_counter() - t}
    log(f"era phase checkpoint [{card}]: {len(blob)} bytes; restored on a fresh backend, "
        f"re-encodes byte-equal; its next epoch equals the original's "
        f"({out['checkpoint']['seconds']:.3f} s with both epochs)")
    return out


def check_lincomb(seed: int, card: str, device=None, lane_cap=None) -> dict:
    """``TorchBackend.g1_lincomb`` (the DKG's device MSM) against a pure
    host fold of ``g1_mul`` on a LINCOMB_SAMPLE-term sample (one device
    chunk on the card), and against the seam's default ``CryptoBackend.g1_lincomb`` at
    2·``device_lane_cap``+5 terms (two device chunks and a host tail), with
    one dispatch per device chunk."""
    from hbbft_tpu_torch.crypto.backend import CryptoBackend
    from hbbft_tpu_torch.ops.backend import TorchBackend

    be = TorchBackend(device)
    if lane_cap is not None:
        be.device_lane_cap = lane_cap
    g = be.group
    rng = random.Random(seed)
    pts = [g.g1_mul(rng.randrange(1, g.r), g.g1()) for _ in range(LINCOMB_SAMPLE)]
    scalars = [rng.randrange(g.r) for _ in range(LINCOMB_SAMPLE)]
    d0 = be.counters.device_dispatches
    got = be.g1_lincomb(scalars, pts)
    want = None
    for s, p in zip(scalars, pts):
        want = g.g1_add(want, g.g1_mul(s, p))
    chunks = -(-LINCOMB_SAMPLE // be.device_lane_cap)  # each at least the threshold
    if got != want or be.counters.device_dispatches - d0 != chunks:
        raise AssertionError("g1_lincomb differs from the host fold on the sample")
    terms = 2 * be.device_lane_cap + 5
    pts = be.g1_mul_batch([rng.randrange(1, g.r) for _ in range(terms)], [g.g1()] * terms)
    scalars = [rng.randrange(g.r) for _ in range(terms)]
    t = time.perf_counter()
    d0 = be.counters.device_dispatches
    got = be.g1_lincomb(scalars, pts)
    secs = time.perf_counter() - t
    dispatches = be.counters.device_dispatches - d0
    t = time.perf_counter()
    want = CryptoBackend.g1_lincomb(be, scalars, pts)
    default_secs = time.perf_counter() - t
    if got != want or dispatches != 2:
        raise AssertionError(f"g1_lincomb at {terms} terms differs from the seam's default "
                             f"(or took {dispatches} dispatches, not 2)")
    log(f"g1_lincomb [{card}]: equals the host fold at {LINCOMB_SAMPLE} terms and the "
        f"seam's default at {terms} terms (2 device chunks + a 5-term host tail, "
        f"{dispatches} dispatches): {secs:.3f} s, the default {default_secs:.3f} s")
    return {"sample_terms": LINCOMB_SAMPLE, "terms": terms, "seconds": secs,
            "default_seconds": default_secs, "dispatches": dispatches}


def object_contributions(rng, n: int, epochs: int) -> list:
    """Each epoch's proposals, node -> OBJECT_TXNS transactions of
    OBJECT_TX_BYTES random bytes, no transaction drawn twice in the run."""
    seen: set = set()
    out = []
    for _ in range(epochs):
        epoch = {}
        for nid in range(n):
            txs = []
            while len(txs) < OBJECT_TXNS:
                tx = rng.getrandbits(8 * OBJECT_TX_BYTES).to_bytes(OBJECT_TX_BYTES, "big")
                if tx not in seen:
                    seen.add(tx)
                    txs.append(tx)
            epoch[nid] = txs
        out.append(epoch)
    return out


#: the backend methods the object runtime calls: VirtualNet's round barrier
#: (one call per kind a round) and the protocols' combines
OBJECT_BACKEND_CALLS = ("verify_ciphertexts", "verify_dec_shares", "verify_sig_shares",
                        "verify_signatures", "combine_decryption_shares", "combine_signatures")
#: the backend counters both arms of the object phase must agree on
OBJECT_COUNTS = ("ciphertexts_verified", "dec_shares_verified", "dec_shares_combined",
                 "sig_shares_verified", "signatures_verified")


class HostSplit:
    """Host seconds of the object runtime by what ran: the proposers'
    threshold encryptions (``PublicKeySet.encrypt``), the decryption shares
    (``SecretKeyShare.decrypt_share_unchecked``), the public key shares the
    protocols evaluate from the master commitment for each share they check
    (``PublicKeySet.public_key_share``), and each backend call of
    OBJECT_BACKEND_CALLS (timed to its return, so on the card a call
    includes the device work it waits for).  Inside the ``with`` those
    functions are wrapped by timers; only the outermost timed call counts,
    so no second is counted twice.  ``rest(wall)`` is the remainder: the
    protocol cranks, message routing and the round barrier's bookkeeping."""

    HOST = (("PublicKeySet", "encrypt", "encrypt"),
            ("SecretKeyShare", "decrypt_share_unchecked", "dec_share"),
            ("PublicKeySet", "public_key_share", "key_share"))

    def __init__(self, backend) -> None:
        self.backend = backend
        names = [what for _, _, what in self.HOST] + list(OBJECT_BACKEND_CALLS)
        self.seconds = {k: 0.0 for k in names}
        self.calls = {k: 0 for k in names}
        self._depth = 0
        self._saved: list = []

    def _timed(self, fn, what):
        def run(*a, **kw):
            self._depth += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds[what] += time.perf_counter() - t
                    self.calls[what] += 1
        return run

    def __enter__(self) -> "HostSplit":
        from hbbft_tpu_torch.crypto import keys

        for cls_name, name, what in self.HOST:
            cls = getattr(keys, cls_name)
            fn = cls.__dict__[name]
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._timed(fn, what))
        for name in OBJECT_BACKEND_CALLS:
            setattr(self.backend, name, self._timed(getattr(self.backend, name), name))
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        for name in OBJECT_BACKEND_CALLS:
            delattr(self.backend, name)

    def split(self, wall: float) -> dict:
        """Seconds by part (the backend's calls also summed as ``backend``,
        zero parts left out) and the ``rest``."""
        out = {k: v for k, v in self.seconds.items() if v}
        out["backend"] = sum(self.seconds[k] for k in OBJECT_BACKEND_CALLS)
        out["rest"] = wall - sum(self.seconds.values())
        return out


def run_object_net(backend, n: int, f: int, contribs: list, what: str) -> dict:
    """HoneyBadger over the port's VirtualNet: ``NetBuilder(range(n))
    .num_faulty(f).defer_mode("round").backend(backend)``, every epoch
    encrypted, the net built from OBJECT_SEED.  Each epoch every node
    proposes its transactions and the net cranks round by round until it is
    quiet.  Raises unless every correct node output that epoch's Batch,
    the same on all of them, holding every correct node's transactions.
    Per epoch: its Batch digest, the running ``messages_delivered`` and
    ``cranks``, seconds, dispatches, device seconds by kind and the host
    split (HostSplit)."""
    import torch

    from hbbft_tpu_torch.net.virtual_net import NetBuilder
    from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule, HoneyBadger

    def sync():
        if getattr(backend, "device", None) is not None and backend.device.type == "cuda":
            torch.cuda.synchronize()

    t = time.perf_counter()
    net = (NetBuilder(range(n)).num_faulty(f).defer_mode("round").backend(backend)
           .using(lambda ni, be: HoneyBadger(ni, be, session_id=b"chip-smoke",
                                             encryption_schedule=EncryptionSchedule.always()))
           .build(seed=OBJECT_SEED))
    out = {"setup_seconds": time.perf_counter() - t,
           "faulty": sorted(node.id for node in net.faulty_nodes()), "epochs": []}
    correct = [node.id for node in net.correct_nodes()]
    for e, proposals in enumerate(contribs):
        c0 = backend.counters.snapshot()
        split = HostSplit(backend)
        t = time.perf_counter()
        with split:
            for nid in sorted(net.nodes):
                net.send_input(nid, proposals[nid])
            while net.queue or net._pending_work:
                net.crank_round()
            sync()
        secs = time.perf_counter() - t
        c1 = backend.counters.snapshot()
        outs = [net.nodes[nid].outputs for nid in correct]
        if any(len(o) != e + 1 for o in outs):
            raise AssertionError(f"{what}: a correct node has no Batch for epoch {e}")
        first = outs[0][e]
        if any(o[e] != first for o in outs) or first.epoch != e:
            raise AssertionError(f"{what}: the correct nodes output different Batches")
        if any(first.contributions.get(p) != proposals[p] for p in correct):
            raise AssertionError(f"{what}: the Batch lacks a correct node's transactions")
        out["epochs"].append({
            "batch": hashlib.sha256(repr((first.epoch, sorted(first.contributions.items())))
                                    .encode()).hexdigest(),
            "proposals": len(first.contributions),
            "messages_delivered": net.messages_delivered, "cranks": net.cranks,
            "seconds": secs, "device_dispatches": c1["device_dispatches"] - c0["device_dispatches"],
            "device_seconds": _counter_delta(c0, c1, "device_seconds_"),
            "host_seconds": split.split(secs),
            "host_calls": {k: v for k, v in split.calls.items() if v},
        })
    c = backend.counters.snapshot()
    out["counters"] = {k: c[k] for k in OBJECT_COUNTS}
    out["device_dispatches"] = c["device_dispatches"]
    return out


def phase_object(seed: int, card: str, device=None, shapes=OBJECT_SHAPES) -> dict:
    """The object runtime's main path: real-crypto HoneyBadger over the
    port's VirtualNet on ``TorchBackend(device)`` at each of ``shapes``,
    held against the same net on the port's ``MockBackend`` (the same seed
    and transactions): the same Batches, ``messages_delivered`` and
    ``cranks`` epoch for epoch and the same work counts.  With every
    proposal in every Batch, N² ciphertext checks and N²(f+1) combined
    shares an epoch; the share verifies are at most N²(N−1) an epoch (a
    share that reaches an instance after it combined is dropped unchecked)."""
    from hbbft_tpu_torch.crypto.backend import MockBackend
    from hbbft_tpu_torch.ops.backend import TorchBackend

    rng = random.Random(seed)
    res: dict = {"shapes": []}
    for n, f, epochs in shapes:
        contribs = object_contributions(rng, n, epochs)
        what = f"object runtime N={n}, f={f}"
        real = run_object_net(TorchBackend(device), n, f, contribs, what)
        mock = run_object_net(MockBackend(), n, f, contribs, what + " (mock)")
        for key in ("batch", "proposals", "messages_delivered", "cranks"):
            a, b = ([ep[key] for ep in arm["epochs"]] for arm in (real, mock))
            if a != b:
                raise AssertionError(f"{what}: {key} {a} on TorchBackend, {b} on MockBackend")
        if real["counters"] != mock["counters"] or real["faulty"] != mock["faulty"]:
            raise AssertionError(f"{what}: counts {real['counters']} on TorchBackend, "
                                 f"{mock['counters']} on MockBackend")
        cnt = real["counters"]
        if all(ep["proposals"] == n for ep in real["epochs"]):
            want = (epochs * n * n, epochs * n * n * (f + 1))
            if (cnt["ciphertexts_verified"], cnt["dec_shares_combined"]) != want:
                raise AssertionError(f"{what}: ciphertext checks and combined shares "
                                     f"{cnt}, not {want}")
        if not 0 < cnt["dec_shares_verified"] <= epochs * n * n * (n - 1):
            raise AssertionError(f"{what}: {cnt['dec_shares_verified']} share verifies")
        res["shapes"].append({"n": n, "f": f, "epochs": epochs, "torch": real, "mock": mock})
        eps = real["epochs"]
        log(f"{what}, {epochs} epoch(s) [{card}]: TorchBackend equals MockBackend epoch for "
            f"epoch (Batches of {[ep['proposals'] for ep in eps]} proposals, "
            f"messages_delivered {[ep['messages_delivered'] for ep in eps]}, cranks "
            f"{[ep['cranks'] for ep in eps]}, faulty {real['faulty']}); counts "
            f"{json.dumps(cnt)}")
        log(f"{what} [{card}]: seconds per epoch {json.dumps([ep['seconds'] for ep in eps])} "
            f"(MockBackend {json.dumps([ep['seconds'] for ep in mock['epochs']])}); "
            f"device_dispatches per epoch {json.dumps([ep['device_dispatches'] for ep in eps])}")
        for e, ep in enumerate(eps):
            log(f"{what} epoch {e} [{card}]: device seconds by kind "
                f"{json.dumps(ep['device_seconds'])}; host seconds {json.dumps(ep['host_seconds'])}"
                f" over calls {json.dumps(ep['host_calls'])}")
    return res


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


def check_path_widths(dev, rng, errs: dict, launches: dict, lanes: dict, widest: dict,
                      what: str, names=("fq_rns_mul", "fq_rns_pow")) -> dict:
    """The kernels ``names`` (``fq_rns_mul``, ``fq_rns_pow``,
    ``miller_dbl``, ``hard_exp``, ``tower_op``: each of its seven kinds)
    against their plain versions at a path's mean and widest launch
    widths (the coin epoch's, the era change's, the object runtime's;
    rows beyond 65,536 repeat 65,536 distinct lazy rows); returns the
    widths checked."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K
    from hbbft_tpu_torch.ops import tower_fused as TF, tower_fused_cuda as TK

    def rows(n):
        base = torch.as_tensor(lazy_rows(rng, min(n, 1 << 16), R)[0], device=dev)
        return base.repeat((-(-n // base.shape[0]), 1))[:n].contiguous()

    checked = {}
    for name in names:
        mean = max(1, lanes[name] // max(1, launches[name]))
        checked[name] = sorted({mean, widest[name]})
        for n in checked[name]:
            if name == "miller_dbl":
                f, r, p = (tower_inputs(dev, rng, c, n) for c in (12, 6, 2))
                (got_f, got_r), (want_f, want_r) = TK.miller_dbl(f, r, p), TF.dbl_plain(f, r, p)
                errs[name] = max(errs.get(name, 0.0),
                                 same(f"{name} f ({what}, {n} lanes)", got_f, want_f),
                                 same(f"{name} R ({what}, {n} lanes)", got_r, want_r))
                continue
            if name == "hard_exp":
                m = tower_inputs(dev, rng, 12, n)
                errs[name] = max(errs.get(name, 0.0), same(
                    f"{name} ({what}, {n} lanes)", TK.hard_exp(m), TF.hard_plain(m)))
                continue
            if name == "tower_op":
                for idx, kind in enumerate(TF.OP_KINDS):
                    c = TF._OP_BODY[kind][1]
                    a, b = tower_inputs(dev, rng, c, n), tower_inputs(dev, rng, c, n)
                    errs[name] = max(errs.get(name, 0.0), same(
                        f"{name} {kind} ({what}, {n} lanes)", TK.tower_op(idx, a, b),
                        TF.op_plain(kind, a, b)))
                continue
            a = rows(n)
            if name == "fq_rns_mul":
                b = torch.flip(a, dims=(0,)).contiguous()
                got, want = K.mul(a, b), K.mul_plain(a, b)
            else:
                got, want = K.pow_fixed(a, Q - 2), K.pow_plain(a, Q - 2)
            errs[name] = max(errs[name], same(f"{name} ({what}, {n} lanes)", got, want))
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
    from hbbft_tpu_torch.ops import gf256 as G, sha256 as S, tower_fused_cuda as TK

    return {"fq_rns_mul": K.mul, "fq_rns_pow": K.pow_fixed, "tower_op": TK.tower_op,
            "miller_dbl": TK.miller_dbl, "hard_exp": TK.hard_exp,
            "fq_limb_mul": LK.mul, "fq_limb_pow": LK.pow_fixed,
            "fq_rns_chain": K.mul_chain, "fma_probe": PK.fma_probe,
            "sha256_tagged": S.sha256_tagged, "sha256_proofs": S.sha256_proofs,
            "gf256_matmul": G.gf256_matmul}


def reset_launches() -> None:
    from hbbft_tpu_torch.ops import fq_limb_cuda as LK, fq_rns_cuda as K, probe_cuda as PK
    from hbbft_tpu_torch.ops import gf256 as G, sha256 as S, tower_fused_cuda as TK

    for mod in (K, TK, LK, PK, S, G):
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
OUR_KERNELS = ("fq_rns_mul", "fq_rns_pow", "tower_op", "miller_dbl", "hard_exp",
               "sha256_tagged", "sha256_proofs", "gf256_matmul")


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


def run_era(args, dev, rng, errs: dict, card: str, secs: dict) -> dict:
    """The era phase at ``args.era_n`` on its own backend, then its kernel
    widths and the device MSM's checks."""
    import torch

    t = time.perf_counter()
    era_res = phase_era(args.seed + 3, args.era_n, card)
    torch.cuda.synchronize()
    secs["era_phase"] = time.perf_counter() - t
    era = era_res["era_change"]
    t = time.perf_counter()
    era_res["checked_widths"] = check_path_widths(
        dev, rng, errs, era["launches"], era["lanes"], era["widest"],
        f"era change, N={args.era_n}")
    era_res["lincomb"] = check_lincomb(args.seed + 4, card)
    secs["era_checks"] = time.perf_counter() - t
    return era_res


def run_object(args, dev, rng, errs: dict, card: str, secs: dict) -> dict:
    """The object runtime's phase on the card with the kernel launch counts
    zeroed just before it and read just after (its five epoch kernels must
    have launched), then each of the five against its plain version at the
    phase's mean and widest launch widths."""
    import torch

    from hbbft_tpu_torch.ops import fq_rns_cuda as K, tower_fused_cuda as TK

    reset_launches()
    t = time.perf_counter()
    res = phase_object(args.seed + 5, card)
    torch.cuda.synchronize()
    secs["object_phase"] = time.perf_counter() - t
    res["all_launches"] = _launch_counts(kernel_fns())
    res["launches"], res["lanes"] = read_launches(
        "the object runtime (HoneyBadger over VirtualNet)", EPOCH_KERNELS)
    res["widest"] = {"fq_rns_mul": K.mul.widest, "fq_rns_pow": K.pow_fixed.widest,
                     "miller_dbl": TK.miller_dbl.widest, "hard_exp": TK.hard_exp.widest,
                     "tower_op": TK.tower_op.widest}
    res["launch_widths_log2"] = {"fq_rns_mul": dict(sorted(K.mul.widths.items()))}
    log(f"object runtime [{card}]: widest launches {json.dumps(res['widest'])}; fq_rns_mul "
        f"launch widths (key b: [2^(b-1), 2^b) lanes -> launches) "
        f"{json.dumps(res['launch_widths_log2']['fq_rns_mul'])}")
    t = time.perf_counter()
    res["checked_widths"] = check_path_widths(
        dev, rng, errs, res["launches"], res["lanes"], res["widest"], "object runtime",
        names=tuple(res["widest"]))
    secs["object_checks"] = time.perf_counter() - t
    return res


def log_object(res: dict, card: str) -> None:
    for sh in res["shapes"]:
        eps = sh["torch"]["epochs"]
        log(f"object runtime N={sh['n']}, f={sh['f']} [{card}]: seconds per epoch "
            f"{json.dumps([ep['seconds'] for ep in eps])}, device_dispatches per epoch "
            f"{json.dumps([ep['device_dispatches'] for ep in eps])}, counts "
            f"{json.dumps(sh['torch']['counters'])}")
    log(f"object runtime launches [{card}]: {json.dumps(res['launches'])}; lanes "
        f"{json.dumps(res['lanes'])}; widest {json.dumps(res['widest'])}")


def log_era(era_res: dict, card: str) -> None:
    era = era_res["era_change"]
    log(f"era change N={era_res['n']}, f={era_res['f']} [{card}]: {era['seconds']:.3f} s, "
        f"host buckets {json.dumps(era['host_buckets'])}, hash_g2_seconds "
        f"{era['hash_g2_seconds']:.3f}, device seconds {json.dumps(era['device_seconds'])}, "
        f"device_dispatches {era['device_dispatches']}, peak memory "
        f"{era['peak_memory_bytes']} bytes, launches {json.dumps(era['launches'])}; epochs "
        f"{json.dumps(era_res['epoch_seconds'])} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="run phases 3 and 4 again under torch.profiler")
    ap.add_argument("--era-n", type=int, default=ERA_N,
                    help=f"N of the era phase (default {ERA_N})")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--era-only", action="store_true",
                      help="build the kernels, then run the era phase and its checks alone")
    only.add_argument("--object-only", action="store_true",
                      help="build the kernels, then run the object runtime's phase and its "
                           "checks alone")
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
    from hbbft_tpu_torch.ops import gf256 as G, sha256 as S, tower_fused_cuda as TK
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
        sources = ["fq_rns", "tower_fused", "fq_limb", "probe", "sha256", "gf256"]
        built = cuda_build.build(sources)  # one nvcc each, all started together
        for mod in (K, TK, LK, PK, S, G):
            mod.build()
        secs["build"] = time.perf_counter() - t
        log(f"build: {built} ({secs['build']:.2f} s)")
        result["build"] = kernel_bench.build_report(dev, log, sources)
        alone = [(name, run, log_fn) for flag, name, run, log_fn in (
            (args.era_only, "era", run_era, log_era),
            (args.object_only, "object_runtime", run_object, log_object)) if flag]
        if alone:  # one phase and its checks, after the build
            (name, run, log_fn), = alone
            res = run(args, dev, rng, {"fq_rns_mul": 0.0, "fq_rns_pow": 0.0}, card, secs)
            result.update({name: res, "phase_seconds": secs})
            with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as fh:
                json.dump(result, fh, indent=1)
            log_fn(res, card)
            log(f"phase seconds [{card}]: {json.dumps(secs)}")
            log(card)
            log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                   "kind": torch.cuda.get_device_name(0),
                                                   "count": torch.cuda.device_count()}}))
            return 0

        t = time.perf_counter()
        errs = phase_kernels(dev, rng, MUL_LANES, POW_LANES)
        check_tower_kernels(dev, rng, TOWER_WIDTHS, errs)
        check_limb_kernels(dev, rng, LIMB_WIDTHS, errs)
        check_chain_kernel(dev, rng, CHAIN_WIDTHS, errs)
        check_probe(dev, args.seed, PK.REF_SHAPE, PK.REF_ITERS, errs)
        check_rs_plane_kernels(dev, rng, errs)
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
        launches, lanes = read_launches("the main path (whole N=100 epochs)",
                                        EPOCH_KERNELS + RS_KERNELS)
        if not (epoch_res["device_seconds"].get("rs_enc", 0) > 0
                and epoch_res["device_seconds"].get("merkle", 0) > 0):
            raise AssertionError("the epochs did not run on the device erasure/hash plane")
        widths = {"fq_rns_mul": dict(sorted(K.mul.widths.items())),
                  "fq_rns_pow": dict(sorted(K.pow_fixed.widths.items()))}
        widest_pow = K.pow_fixed.widest
        log(f"epoch fq_rns_mul launch widths (key b: [2^(b-1), 2^b) lanes -> launches): "
            f"{json.dumps(widths['fq_rns_mul'])}; one-row operands at lane stride 0 in "
            f"{K.mul.broadcast_launches} of {K.mul.launches} launches; fq_rns_pow's "
            f"widest launch {widest_pow} lanes")
        result["fq_rns_mul_broadcast_launches"] = K.mul.broadcast_launches

        t = time.perf_counter()
        kill_res = phase_rs_kill_switch(args.seed, N, epoch_res, card)
        torch.cuda.synchronize()
        secs["rs_kill_switch_epoch"] = time.perf_counter() - t

        peaks = [torch.cuda.max_memory_allocated(dev)]
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
        coin_res["checked_widths"] = check_path_widths(dev, rng, errs, coin_launches,
                                                       coin_lanes, coin_widest, "coin epoch")
        secs["coin_widths"] = time.perf_counter() - t

        peaks.append(torch.cuda.max_memory_allocated(dev))
        era_res = run_era(args, dev, rng, errs, card, secs)
        object_res = run_object(args, dev, rng, errs, card, secs)

        reset_launches()
        t = time.perf_counter()
        bench_res = kernel_bench.run(dev, log=log)
        torch.cuda.synchronize()
        secs["bench"] = time.perf_counter() - t
        bench_launches, bench_lanes = read_launches("the kernel bench", BENCH_KERNELS)

        t = time.perf_counter()
        rows = kernel_rows(dev, rng, errs, launches, lanes, widest_pow)
        rows += tower_kernel_rows(dev, rng, errs, launches, lanes)
        for r in rows:  # the coin epoch's and the era change's beside the two epochs'
            r["coin_launches"] = coin_launches[r["name"]]
            r["era_launches"] = era_res["era_change"]["launches"][r["name"]]
        rows += rs_plane_rows(dev, rng, errs, launches, lanes)
        rows += limb_kernel_rows(dev, rng, errs, limb_res["launches"], limb_res["lanes"])
        rows += bench_kernel_rows(dev, rng, args.seed, errs, bench_launches, bench_lanes,
                                  bench_res)
        for r in rows:  # every kernel's launches on the object runtime's phase
            r["object_launches"] = object_res["all_launches"][r["name"]]
            if r["name"] in object_res["widest"]:
                r["object_mean_lanes"] = (object_res["lanes"][r["name"]]
                                          / object_res["launches"][r["name"]])
                r["object_widest_lanes"] = object_res["widest"][r["name"]]
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
        "epoch": epoch_res, "rs_kill_switch": kill_res, "coin_epoch": coin_res, "era": era_res,
        "object_runtime": object_res,
        "bench": bench_res, "phase_seconds": secs,
        "path_device_dispatches": c.device_dispatches, "path_pairing_checks": c.pairing_checks,
        "path_rlc_groups": c.rlc_groups, "kernels": rows, "launch_widths_log2": widths,
        "peak_memory_bytes": max(*peaks, torch.cuda.max_memory_allocated(dev)),
        "profile": prof,
    })
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log(f"threshold-decryption path N={N}, f={(N - 1) // 3} [{card}]: seconds "
        f"{json.dumps(path_res['seconds'])}")
    log(f"seconds per N={N} epoch [{card}]: "
        f"{json.dumps([e['seconds'] for e in epoch_res['epochs']])}")
    arms = {"plane": epoch_res["epochs"], "HBBFT_TPU_NO_DEVICE_RS=1": kill_res["epochs"]}
    log(f"erasure/hash plane, per N={N} epoch [{card}]: " + json.dumps({
        arm: {"seconds": [e["seconds"] for e in eps],
              "host_bucket_rs_merkle": [e["counters"]["host_bucket_rs_merkle"] for e in eps],
              "device_dispatches": [e["counters"]["device_dispatches"] for e in eps]}
        for arm, eps in arms.items()}))
    log(f"limb arm N={N}, f={(N - 1) // 3} [{card}]: seconds "
        f"{json.dumps(limb_res['seconds'])}")
    log(f"sig path N={N} [{card}]: seconds {json.dumps(sig_res['seconds'])}; launches "
        f"{json.dumps(sig_res['launches'])}")
    log(f"coin epoch N={N}, coin_rounds={COIN_ROUNDS} [{card}]: "
        f"{coin_res['epochs'][0]['seconds']:.3f} s, phase seconds "
        f"{json.dumps(coin_res['epochs'][0]['report']['phase_seconds'])}, device seconds "
        f"{json.dumps(coin_res['device_seconds'])}, launches {json.dumps(coin_launches)}, "
        f"lanes {json.dumps(coin_lanes)}, peak memory {coin_res['peak_memory_bytes']} bytes")
    log_era(era_res, card)
    log_object(object_res, card)
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
