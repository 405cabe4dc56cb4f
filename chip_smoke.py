#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # one H100; builds the kernels at first use

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every kernel of the path from hbbft_tpu_torch/csrc/.
2. kernels — each kernel against its plain PyTorch version on the card,
             bit for bit (tolerance 0: the arithmetic is exact integer
             float32), plus a sample against Python-int arithmetic mod Q.
3. main    — the threshold-decryption crypto path of one N=100, f=33
             HoneyBadger epoch through ``TorchBackend()``: ciphertext
             checks (one tampered), the epoch's 10k decryption-share
             generations, one 2^17-item engine chunk of share verifies with
             planted forgeries, and 10k Lagrange combines (k=34); verdicts
             and plaintexts are checked exactly.  Kernel launch counts are
             zeroed just before and read just after.
4. a ``{"kernels": [...]}`` line: launches on the main path, largest
   difference from the plain version (phase 2's widths and the main
   path's, partial blocks included), median kernel time at the main
   path's mean launch width, the plain version's time and the bound (the
   least time the card could take: see ``bound``).
5. per-phase seconds, device_dispatches, and the card's name and power
   limit; the last line is ``{"ok": true, "device": {...}}``.

``--profile`` runs the main path a second time with each backend phase
under torch.profiler (kernel time by name, device busy share).  The
whole result is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
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


def phase_main(backend, rng, n: int, f: int, verify_items: int, combines: int,
               forged: int, wrap=None) -> dict:
    """The threshold-decryption path of one epoch through the backend.
    ``wrap(phase)``, when given, is a context manager around each phase."""
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
    return {"seconds": secs, "verify_items": len(items), "forged_items": want.count(False),
            "combines": len(plains)}


def same(name: str, got, want) -> float:
    """max |kernel - plain|; raises unless the two are bit-equal."""
    import torch

    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    log(f"{name}: {got.shape[0]} lanes, max |kernel - plain| = {e}")
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


def profile_main(backend, rng, card: str, out_path: str) -> dict:
    """The main path once more, each backend phase under torch.profiler:
    the wall time, the device's kernel time and busy share, the share of
    the fq_rns kernels, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stats = {}

    @contextmanager
    def traced(name):
        if name == "host_setup":
            yield
            return
        torch.cuda.synchronize()
        # device activity only: recording every host op would slow the
        # eager path far more than it costs to run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels) / 1e6
        ours = sum(e.self_device_time_total for e in kernels
                   if e.key.startswith("fq_rns_")) / 1e6
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        stats[name] = {
            "wall_s": wall, "kernel_s": total, "busy_share": total / wall,
            "fq_rns_kernel_s": ours, "kernel_launches": sum(e.count for e in kernels),
            "top": [(e.key[:100], e.count, e.self_device_time_total / 1e6) for e in top],
        }
        log(f"profile {name} [{card}]: wall {wall:.3f} s, kernels {total:.3f} s "
            f"(busy {total / wall:.1%}), fq_rns kernels {ours:.3f} s, "
            f"{stats[name]['kernel_launches']} kernel launches")

    phase_main(backend, rng, N, (N - 1) // 3, VERIFY_ITEMS, COMBINES, FORGED, wrap=traced)
    with open(out_path, "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="run the main path again with each phase under torch.profiler")
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

    from hbbft_tpu_torch.ops import fq_rns_cuda as K
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
        built = K.build()
        secs["build"] = time.perf_counter() - t
        log(f"build: {built} ({secs['build']:.2f} s)")
        for line in cuda_build.build_log("fq_rns").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("  ptxas:", line.strip())

        t = time.perf_counter()
        errs = phase_kernels(dev, rng, MUL_LANES, POW_LANES)
        secs["kernels"] = time.perf_counter() - t

        backend = TorchBackend()
        K.reset_launches()
        t = time.perf_counter()
        main_res = phase_main(backend, rng, N, (N - 1) // 3, VERIFY_ITEMS, COMBINES, FORGED)
        torch.cuda.synchronize()
        secs["main"] = time.perf_counter() - t
        launches = {"fq_rns_mul": K.mul.launches, "fq_rns_pow": K.pow_fixed.launches}
        lanes = {"fq_rns_mul": K.mul.lanes, "fq_rns_pow": K.pow_fixed.lanes}
        widths = {"fq_rns_mul": dict(sorted(K.mul.widths.items())),
                  "fq_rns_pow": dict(sorted(K.pow_fixed.widths.items()))}
        for name, cnt in launches.items():
            if cnt <= 0:
                raise AssertionError(f"{name} was not launched on the main path")

        t = time.perf_counter()
        rows = kernel_rows(dev, rng, errs, launches, lanes)
        secs["timing"] = time.perf_counter() - t
        prof = None
        if args.profile:
            t = time.perf_counter()
            prof = profile_main(TorchBackend(), rng, card,
                                os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.json"))
            secs["profile"] = time.perf_counter() - t
    except Exception:
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1

    c = backend.counters
    result.update({
        "n": N, "f": (N - 1) // 3, "main": main_res, "phase_seconds": secs,
        "device_dispatches": c.device_dispatches, "pairing_checks": c.pairing_checks,
        "rlc_groups": c.rlc_groups, "kernels": rows, "launch_widths_log2": widths,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev), "profile": prof,
    })
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log(f"main path N={N}, f={(N - 1) // 3} [{card}]: seconds "
        f"{json.dumps(main_res['seconds'])}")
    log(f"phase seconds [{card}]: {json.dumps(secs)}")
    log(f"device_dispatches={c.device_dispatches} pairing_checks={c.pairing_checks} "
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
