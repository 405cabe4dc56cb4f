#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # one H100; builds the kernels at first use

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every kernel source of hbbft_tpu_torch/csrc/ in
             parallel (fq_rns.cu: the field multiply and power;
             tower_fused.cu: the fused tower op, Miller doubling and
             final-exponentiation hard part).
2. kernels — each kernel against its plain PyTorch version on the card,
             bit for bit (tolerance 0: the arithmetic is exact integer
             float32), plus a field sample against Python-int arithmetic
             mod Q.
3. path    — the threshold-decryption crypto path of one N=100, f=33
             HoneyBadger epoch through ``TorchBackend()`` (the first slice's
             path, now on the fused chain): ciphertext checks (one
             tampered), the epoch's 10k decryption-share generations, one
             2^17-item engine chunk of share verifies with planted forgeries,
             and 10k Lagrange combines (k=34); verdicts and plaintexts are
             checked exactly.  Then a short pass with
             HBBFT_TPU_NO_FUSED_TOWER=1 (the stacked arm) must give the fused
             arm's verdicts.
4. epoch   — the main path: whole N=100 HoneyBadger epochs through the
             port's ``ArrayHoneyBadgerNet`` on ``TorchBackend()``; every node
             must output the same Batch holding every contribution, and the
             native host kernels of the RS/Merkle plane must have been built.
             Kernel launch counts are zeroed just before each of phases 3
             and 4 and read just after; every kernel must have launched.
5. a ``{"kernels": [...]}`` line: launches on the main path, largest
   difference from the plain version (phase 2's widths and the main path's,
   one lane and partial blocks included), median kernel time at the main
   path's mean launch width, the plain version's time and the bound (the
   least time the card could take: see ``bound``).
6. per-phase seconds, device_dispatches, and the card's name and power
   limit; the last line is ``{"ok": true, "device": {...}}``.

``--profile`` runs phase 3 (each backend phase) and one epoch of phase 4 a
second time under torch.profiler (kernel time by name, device busy
share).  The whole result
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
# bandwidth, bf16 tensor cores, float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12

# The least work one Montgomery product needs per lane (the bound below):
# * the two base extensions as bf16 tensor-core products — the 6-bit/5-bit
#   planes are exact in bf16, as the TPU kernel runs them: 2 extensions x
#   4 plane products x (40 x 40) multiply-adds x 2 flops;
# * the stage-wise reductions as float32 work, counted from the stages of
#   fq_rns_pallas._mul_core (one op per mul, add, floor or compare; a
#   loose reduction is 4, an exact one 10): lane product and offset 79x6,
#   sigma 39x11, two plane splits 39x4 each, extension-1 recombination
#   40x29, r2r 40x7, xi 39x11, extension-2 recombination 40x23, delta 12,
#   r1 39x6; the input renormalisation adds 79x2x4 when not `reduced`;
# * the bytes: each operand row read once, the result row written once.
MUL_TC_FLOPS = 2 * 4 * 40 * 40 * 2
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
#: mean: one lane, and 1001 lanes (three lanes per block, the last partial)
TOWER_WIDTHS = (1, 1001)


def bound(lanes: int, products: int, ew_ops: int, rows_moved: int) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes time and the
    operations time of ``products`` Montgomery products on each of
    ``lanes`` lanes that move ``rows_moved`` residue rows per lane."""
    t_bytes = lanes * rows_moved * ROW_BYTES / HBM_BYTES_PER_S
    t_ops = lanes * (products * MUL_TC_FLOPS / BF16_TC_FLOPS + ew_ops / FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


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
        keep.update(cts=cts + [tampered], ct_ok=ok, items=items, want=want)
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


def phase_epoch(backend, seed: int, n: int, epochs: int, card: str) -> dict:
    """Whole N-node epochs through the port's engine: every node must output
    the same Batch, holding every node's contribution."""
    import torch

    from hbbft_tpu_torch import native
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet

    t = time.perf_counter()
    net = ArrayHoneyBadgerNet(range(n), backend=backend, seed=seed)
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
        log(f"epoch {first.epoch} N={n} [{card}]: {secs:.3f} s, all {n} nodes output the "
            f"same Batch of {len(first.contributions)} contributions")
        log(f"  EpochReport: {json.dumps(rep)}")
    # the RS/Merkle plane ran on the port's native C kernels, not hashlib
    if not (native.available() and native.sha256_available()):
        raise AssertionError("the native host kernels (gf256, sha256) were not built")
    c = backend.counters.snapshot()
    out["device_dispatches"] = c["device_dispatches"]
    out["device_seconds"] = {k[len("device_seconds_"):]: v for k, v in c.items()
                             if k.startswith("device_seconds_") and v}
    out["host_buckets"] = {k[len("host_bucket_"):]: v for k, v in c.items()
                           if k.startswith("host_bucket_") and v}
    out["counters"] = {k: c[k] for k in (
        "device_seconds", "host_seconds", "pairing_checks", "rlc_groups", "fused_tower_calls",
        "fused_chain_pallas_calls", "fused_chain_field_muls", "dec_shares_verified",
        "ciphertexts_verified", "dec_shares_combined")}
    log(f"epoch device_dispatches={c['device_dispatches']} [{card}]")
    log(f"epoch device seconds by kind [{card}]: {json.dumps(out['device_seconds'])}")
    log(f"epoch host buckets [{card}]: {json.dumps(out['host_buckets'])}")
    log(f"epoch counters [{card}]: {json.dumps(out['counters'])}")
    return out


def same(name: str, got, want) -> float:
    """max |kernel - plain|; raises unless the two are bit-equal."""
    import torch

    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    log(f"{name}: {got.shape[-2]} lanes, max |kernel - plain| = {e}")
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version")
    return e


def kernel_rows(dev, rng, errs: dict, launches: dict, lanes: dict) -> list:
    """Hold each kernel against its plain version at the main path's
    widths (one lane and its mean launch width: main-path launches end
    in a partial 128-lane block), then time both at the mean width
    beside the bound."""
    import torch

    from hbbft_tpu_torch.crypto.field import Q
    from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K

    rows = []
    e = Q - 2
    n_mul = max(1, lanes["fq_rns_mul"] // max(1, launches["fq_rns_mul"]))
    n_pow = max(1, lanes["fq_rns_pow"] // max(1, launches["fq_rns_pow"]))
    for n in (1, n_mul):
        a = torch.as_tensor(lazy_rows(rng, n, R)[0], device=dev)
        b = torch.flip(a, dims=(0,)).contiguous()
        for reduced in (False, True):
            x, y = (K.mul_plain(a, a), K.mul_plain(b, b)) if reduced else (a, b)
            errs["fq_rns_mul"] = max(errs["fq_rns_mul"], same(
                f"fq_rns_mul reduced={reduced}", K.mul(x, y, reduced=reduced),
                K.mul_plain(x, y, reduced=reduced)))
    for n in (1, n_pow):
        x = torch.as_tensor(lazy_rows(rng, n, R)[0], device=dev)
        errs["fq_rns_pow"] = max(errs["fq_rns_pow"], same(
            "fq_rns_pow e=Q-2", K.pow_fixed(x, e), K.pow_plain(x, e)))

    ms = time_ms(lambda: K.mul(a, b))
    plain_ms = time_ms(lambda: K.mul_plain(a, b))
    bound_ms, bound_by = bound(n_mul, 1, MUL_EW_OPS, 3)
    rows.append({
        "name": "fq_rns_mul", "route": "cuda", "source": "hbbft_tpu_torch/csrc/fq_rns.cu",
        "replaces": "hbbft_tpu/ops/fq_rns_pallas.py:259",
        "launches": launches["fq_rns_mul"], "max_abs_err": errs["fq_rns_mul"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "lanes": n_mul,
    })

    ms = time_ms(lambda: K.pow_fixed(x, e), reps=5)
    plain_ms = time_ms(lambda: K.pow_plain(x, e), reps=3)
    products = (e.bit_length() - 1) + (bin(e).count("1") - 1)
    bound_ms, bound_by = bound(n_pow, products, products * MUL_EW_OPS_REDUCED + 79 * 4, 2)
    rows.append({
        "name": "fq_rns_pow", "route": "cuda", "source": "hbbft_tpu_torch/csrc/fq_rns.cu",
        "replaces": "hbbft_tpu/ops/fq_rns_pallas.py:276",
        "launches": launches["fq_rns_pow"], "max_abs_err": errs["fq_rns_pow"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "lanes": n_pow,
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
            "library_ms": None, "lanes": n,
        })

    n = width["tower_op"]
    a, b = tower_inputs(dev, rng, 12, n), tower_inputs(dev, rng, 12, n)
    k = TF.OP_KINDS.index("fq12_mul")
    row("tower_op", 420, n, 54, 36, lambda: TK.tower_op(k, a, b),
        lambda: TF.op_plain("fq12_mul", a, b),
        [TK.tower_op(k, a, b)], [TF.op_plain("fq12_mul", a, b)])

    n = width["miller_dbl"]
    f, r, p = (tower_inputs(dev, rng, c, n) for c in (12, 6, 2))
    row("miller_dbl", 515, n, PC.DBL_FIELD_MULS, 38, lambda: TK.miller_dbl(f, r, p),
        lambda: TF.dbl_plain(f, r, p), TK.miller_dbl(f, r, p), TF.dbl_plain(f, r, p))

    n = width["hard_exp"]
    m = tower_inputs(dev, rng, 12, n)
    row("hard_exp", 619, n, TF.analytic_hard_field_muls(), 24, lambda: TK.hard_exp(m),
        lambda: TF.hard_plain(m), [TK.hard_exp(m)], [TF.hard_plain(m)], reps=5)
    return rows


def reset_launches() -> None:
    from hbbft_tpu_torch.ops import fq_rns_cuda as K, tower_fused_cuda as TK

    K.reset_launches()
    TK.reset_launches()


def read_launches(what: str) -> tuple:
    """(launches, lanes) per kernel since the last reset; raises unless
    every kernel launched."""
    from hbbft_tpu_torch.ops import fq_rns_cuda as K, tower_fused_cuda as TK

    fns = {"fq_rns_mul": K.mul, "fq_rns_pow": K.pow_fixed, "tower_op": TK.tower_op,
           "miller_dbl": TK.miller_dbl, "hard_exp": TK.hard_exp}
    launches = {k: f.launches for k, f in fns.items()}
    lanes = {k: f.lanes for k, f in fns.items()}
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
    stats[name] = {
        "wall_s": wall, "kernel_s": total, "busy_share": total / wall,
        "our_kernel_s": ours, "kernel_launches": sum(e.count for e in kernels),
        "top": [(e.key[:100], e.count, e.self_device_time_total / 1e6) for e in top],
    }
    log(f"profile {name} [{card}]: wall {wall:.3f} s, kernels {total:.3f} s "
        f"(busy {total / wall:.1%}), hand-written kernels {ours:.3f} s, "
        f"{stats[name]['kernel_launches']} kernel launches")


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
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script needs the card")
        return 2
    if not os.path.isdir(os.path.join(ROOT, "hbbft_tpu_torch")):
        log("chip_smoke: the hbbft_tpu_torch package is not beside this script")
        return 2
    sys.path.insert(0, ROOT)

    from hbbft_tpu_torch.ops import fq_rns_cuda as K, tower_fused_cuda as TK
    from hbbft_tpu_torch.ops.backend import TorchBackend
    from hbbft_tpu_torch.utils import cuda_build

    card = card_line()
    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)
    secs = {}
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    try:
        t = time.perf_counter()
        built = cuda_build.build(["fq_rns", "tower_fused"])  # one nvcc each, in parallel
        K.build()
        TK.build()
        secs["build"] = time.perf_counter() - t
        log(f"build: {built} ({secs['build']:.2f} s)")
        for name in ("fq_rns", "tower_fused"):
            for line in cuda_build.build_log(name).splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  ptxas {name}:", line.strip())

        t = time.perf_counter()
        errs = phase_kernels(dev, rng, MUL_LANES, POW_LANES)
        check_tower_kernels(dev, rng, TOWER_WIDTHS, errs)
        secs["kernels"] = time.perf_counter() - t

        backend = TorchBackend()
        reset_launches()
        t = time.perf_counter()
        state: dict = {}
        path_res = phase_main(backend, rng, N, (N - 1) // 3, VERIFY_ITEMS, COMBINES, FORGED,
                              keep=state)
        torch.cuda.synchronize()
        secs["path"] = time.perf_counter() - t
        path_launches, _ = read_launches("the threshold-decryption path")

        t = time.perf_counter()
        stacked_res = phase_stacked_arm(state, 2 * N * (N - 1))
        secs["stacked_arm"] = time.perf_counter() - t
        del state

        epoch_backend = TorchBackend()
        reset_launches()
        t = time.perf_counter()
        epoch_res = phase_epoch(epoch_backend, args.seed, N, EPOCHS, card)
        torch.cuda.synchronize()
        secs["epoch_phase"] = time.perf_counter() - t
        launches, lanes = read_launches("the main path (whole N=100 epochs)")
        widths = {"fq_rns_mul": dict(sorted(K.mul.widths.items())),
                  "fq_rns_pow": dict(sorted(K.pow_fixed.widths.items()))}

        t = time.perf_counter()
        rows = kernel_rows(dev, rng, errs, launches, lanes)
        rows += tower_kernel_rows(dev, rng, errs, launches, lanes)
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
        "stacked_arm": stacked_res, "epoch": epoch_res, "phase_seconds": secs,
        "path_device_dispatches": c.device_dispatches, "path_pairing_checks": c.pairing_checks,
        "path_rlc_groups": c.rlc_groups, "kernels": rows, "launch_widths_log2": widths,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev), "profile": prof,
    })
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log(f"threshold-decryption path N={N}, f={(N - 1) // 3} [{card}]: seconds "
        f"{json.dumps(path_res['seconds'])}")
    log(f"seconds per N={N} epoch [{card}]: "
        f"{json.dumps([e['seconds'] for e in epoch_res['epochs']])}")
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
