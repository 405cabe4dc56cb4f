"""The crypto micro rows: the grouped RLC share checks, the pairing check,
the G2 sign ladder, the coin end to end, the adversarial verifies and
the two A/B rows (GLV against the w2 ladder, the fused tower chain
against the stacked one), each on ``TorchBackend``'s graphs and kernels
on :func:`common.device`, with the JAX bench's knobs, defaults,
host-golden spot checks and output fields.
"""

from __future__ import annotations

import os
import random
import time

from hbbft_tpu_torch.tools.bench.common import (
    CPU_BASELINE_CHECKS_PER_SEC,
    _env_int,
    _time_fn,
    device,
)


def _bits(rows):
    """Per-group RLC coefficient rows → a (G, k, RLC_BITS) bit tensor on
    the bench's device."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import curve
    from hbbft_tpu_torch.ops.backend import TorchBackend

    width = TorchBackend._rlc_bits()
    return torch.as_tensor(np.stack([curve.scalars_to_bits(r, width) for r in rows]),
                           device=device())


def _group(tree, g: int, k: int):
    from hbbft_tpu_torch.utils.tree import tree_map

    return tree_map(lambda c: c.reshape((g, k) + tuple(c.shape[1:])), tree)


def _example_verify_batch(n_items: int, seed: int = 0, distinct: int = 8):
    """Host-built batch of valid checks e(−G1, a·G2)·e(a·G1, G2) == 1 (the
    JAX package's ``pairing.example_verify_batch``), on the bench's
    device."""
    from hbbft_tpu_torch.crypto import bls381 as gold
    from hbbft_tpu_torch.crypto.field import R
    from hbbft_tpu_torch.ops import pairing

    rng = random.Random(seed)
    scalars = [rng.randrange(1, R) for _ in range(max(1, distinct))]
    pts = [
        (gold.ec_neg(gold.FQ, gold.G1_GEN), gold.ec_mul(gold.FQ2, a, gold.G2_GEN),
         gold.ec_mul(gold.FQ, a, gold.G1_GEN), gold.G2_GEN)
        for a in scalars
    ]
    quads = [pts[i % len(pts)] for i in range(n_items)]
    dev = device()
    return (
        pairing.g1_affine_to_device([q[0] for q in quads], device=dev),
        pairing.g2_affine_to_device([q[1] for q in quads], device=dev),
        pairing.g1_affine_to_device([q[2] for q in quads], device=dev),
        pairing.g2_affine_to_device([q[3] for q in quads], device=dev),
    )


def bench_share_verify() -> dict:
    from hbbft_tpu_torch.ops import pairing

    batch = _env_int("BENCH_BATCH", 256)
    iters = _env_int("BENCH_ITERS", 3)
    args = _example_verify_batch(batch)
    fn = pairing.product2_fast
    dt = _time_fn(fn, args, iters)

    # spot-check the benched computation
    assert pairing.is_one_host(fn(*args), 0), "benched verification is wrong"

    checks_per_sec = batch / dt
    return {
        "metric": "share_verify_throughput",
        "value": round(checks_per_sec, 2),
        "unit": "checks/s",
        "vs_baseline": round(checks_per_sec / CPU_BASELINE_CHECKS_PER_SEC, 3),
        "baseline": "estimated",
        "batch": batch,
    }


def _signed_ladders(base, scalars, g2: bool):
    """±(s_i · base_i) on the device ladders (``safe_scalar`` form)."""
    import numpy as np

    from hbbft_tpu_torch.ops import curve

    safe = [curve.safe_scalar(s) for s in scalars]
    bits = curve.scalars_to_bits([s for s, _ in safe])
    negs = np.array([neg for _, neg in safe])
    mul = curve.g2_scalar_mul_signed if g2 else curve.g1_scalar_mul_signed
    return mul(base, bits, negs)


def _synthetic_share_groups(g: int, k: int, seed: int = 7):
    """Valid (σ_i, PK_i) groups without host goldens: σ_i = s_i·H, PK_i =
    s_i·G1 for random s_i, so e(G1, Σrσ_i) == e(ΣrPK_i, H) holds exactly.
    Built with the device ladders themselves."""
    from hbbft_tpu_torch.crypto import bls381 as gold
    from hbbft_tpu_torch.crypto.field import R
    from hbbft_tpu_torch.ops import curve, pairing

    rng = random.Random(seed)
    n = g * k
    scalars = [rng.randrange(1, R) for _ in range(n)]
    dev = device()
    pk = _signed_ladders(curve.g1_to_device([gold.G1_GEN] * n, device=dev), scalars, g2=False)
    sig = _signed_ladders(curve.g2_to_device([gold.G2_GEN] * n, device=dev), scalars, g2=True)
    neg_g1 = pairing.g1_affine_to_device([gold.ec_neg(gold.FQ, gold.G1_GEN)] * g, device=dev)
    H_aff = pairing.g2_affine_to_device([gold.G2_GEN] * g, device=dev)
    return _group(sig, g, k), _group(pk, g, k), neg_g1, H_aff


def bench_rlc_sig() -> dict:
    """Grouped coin-share verification: the common-coin hot loop shape."""
    from hbbft_tpu_torch.ops import pairing
    from hbbft_tpu_torch.ops.backend import _rlc_sig

    g = _env_int("BENCH_RLC_GROUPS", 64)
    k = _env_int("BENCH_RLC_K", 32)
    iters = _env_int("BENCH_ITERS", 3)
    S, PK, negG1, H = _synthetic_share_groups(g, k)
    # fixed nonzero coefficients (timing, not security)
    rbits = _bits([[1 + i * 7919 + j for j in range(k)] for i in range(g)])
    args = (S, PK, negG1, H, rbits)
    dt = _time_fn(_rlc_sig, args, iters)

    assert pairing.is_one_host(_rlc_sig(*args), 0), "rlc sig group check is wrong"

    items = g * k
    return {
        "metric": "rlc_sig_verify_throughput",
        "value": round(items / dt, 2),
        "unit": "shares/s",
        "vs_baseline": round(items / dt / CPU_BASELINE_CHECKS_PER_SEC, 3),
        "baseline": "estimated",
        "batch": items,
        "groups": g,
    }


def bench_rlc_dec() -> dict:
    """Grouped dec-share verification at the 1k-ciphertext batch shape."""
    from hbbft_tpu_torch.crypto import bls381 as gold
    from hbbft_tpu_torch.crypto.field import R
    from hbbft_tpu_torch.ops import curve, pairing
    from hbbft_tpu_torch.ops.backend import _rlc_dec

    g = _env_int("BENCH_DEC_GROUPS", 64)  # ciphertext groups
    k = _env_int("BENCH_DEC_K", 16)  # shares each (config 1: N=16)
    iters = _env_int("BENCH_ITERS", 3)

    # valid shape: D_i = s_i·G1, PK_i = s_i·G1, H = W → e(D,H)==e(PK,W)
    rng = random.Random(11)
    n = g * k
    scalars = [rng.randrange(1, R) for _ in range(n)]
    dev = device()
    D = _group(_signed_ladders(curve.g1_to_device([gold.G1_GEN] * n, device=dev), scalars,
                               g2=False), g, k)
    H = pairing.g2_affine_to_device([gold.G2_GEN] * g, device=dev)
    rbits = _bits([[1 + i * 104729 + j for j in range(k)] for i in range(g)])
    args = (D, D, H, H, rbits)
    dt = _time_fn(_rlc_dec, args, iters)

    assert pairing.is_one_host(_rlc_dec(*args), 0), "rlc dec group check is wrong"

    items = g * k
    return {
        "metric": "rlc_dec_verify_throughput",
        "value": round(items / dt, 2),
        "unit": "shares/s",
        "vs_baseline": round(items / dt / CPU_BASELINE_CHECKS_PER_SEC, 3),
        "baseline": "estimated",
        "batch": items,
        "groups": g,
    }


def bench_coin_e2e() -> dict:
    """BASELINE config 2 end to end: the common coin as one pipeline —
    batched G2 sign → grouped-RLC share verify → batched G2 Lagrange
    combine → hash → coin bit — at N=64 f=21.  Work is the dedup'd
    network-wide flow per flip: N signs, N share verifies (one RLC group),
    one combine of f+1 shares, one parity.  Flip 0's bit is asserted
    against the host golden combine.  BENCH_COIN_FLIPS scales (config 2
    names 10k); BENCH_COIN_CHUNK flips go in one dispatch."""
    import numpy as np

    from hbbft_tpu_torch.crypto import bls381 as gold
    from hbbft_tpu_torch.crypto.backend import CpuBackend
    from hbbft_tpu_torch.crypto.field import lagrange_coeffs_at_zero
    from hbbft_tpu_torch.crypto.keys import SecretKeySet, Signature, SignatureShare
    from hbbft_tpu_torch.ops import curve, pairing
    from hbbft_tpu_torch.ops.backend import TorchBackend, _rlc_sig, _squeeze_point
    from hbbft_tpu_torch.utils.tree import tree_map

    n = _env_int("BENCH_COIN_N", 64)
    f = (n - 1) // 3  # 21
    flips = _env_int("BENCH_COIN_FLIPS", 128)
    iters = _env_int("BENCH_COIN_ITERS", 1)
    chunk = min(flips, _env_int("BENCH_COIN_CHUNK", 500))
    n_chunks = -(-flips // chunk)  # ceil: never under-run the request
    flips_total = chunk * n_chunks  # rounded UP to whole chunks; reported

    g = CpuBackend().group
    rng = random.Random(21)
    sk_set = SecretKeySet.random(g, f, rng)
    pk_set = sk_set.public_keys()
    shares_sk = [sk_set.secret_key_share(i) for i in range(n)]
    pk_els = [pk_set.public_key_share(i).el for i in range(n)]
    safe = [curve.safe_scalar(sk.x) for sk in shares_sk]
    sk_bits_1 = curve.scalars_to_bits([s for s, _ in safe])
    sk_negs_1 = np.array([neg for _, neg in safe])

    k = f + 1  # combine width
    lam = lagrange_coeffs_at_zero(list(range(1, k + 1)))
    lsafe = [curve.safe_scalar(v) for v in lam]
    lam_bits = curve.scalars_to_bits([s for s, _ in lsafe])
    lam_negs = np.array([negq for _, negq in lsafe])

    dev = device()
    neg_g1 = pairing.g1_affine_to_device([gold.ec_neg(gold.FQ, gold.G1_GEN)] * chunk,
                                         device=dev)
    PK_jac = _group(curve.g1_to_device(pk_els * chunk, device=dev), chunk, n)

    def flip_chunk(epoch_tag: int):
        # one distinct doc per flip (the real coin's per-instance nonce);
        # host hash-to-G2 is part of the pipeline's cost
        docs = [b"coin:%d:%d" % (epoch_tag, i) for i in range(chunk)]
        H = [g.hash_to_g2(d) for d in docs]
        H_rep = [h for h in H for _ in range(n)]  # sign points, flip-major
        S = curve.g2_scalar_mul_signed(curve.g2_to_device(H_rep, device=dev),
                                       np.tile(sk_bits_1, (chunk, 1)),
                                       np.tile(sk_negs_1, chunk))
        S_g = _group(S, chunk, n)
        # grouped-RLC verify: one group per flip
        rbits = _bits([TorchBackend._rlc_scalars(n) for _ in range(chunk)])
        H_aff = pairing.g2_affine_to_device(H, device=dev)
        ok = pairing.is_one_host_batch(_rlc_sig(S_g, PK_jac, neg_g1, H_aff, rbits), chunk)
        # combine f+1 shares per flip (lowest indices), then parity
        S_k = tree_map(lambda c: c[:, :k], S_g)
        combined = curve.linear_combine_g2(S_k, np.tile(lam_bits, (chunk, 1, 1)),
                                           np.tile(lam_negs, (chunk, 1)))
        els = curve.g2_from_device(_squeeze_point(combined))
        bits_out = []
        for i in range(chunk):
            assert ok[i], "coin share group failed"
            bits_out.append(Signature(g, els[i]).parity())
        return docs, bits_out

    docs, bits_out = flip_chunk(0)  # warm + correctness
    # golden: host combine of flip 0 must yield the same coin bit
    gold_shares = {
        i: SignatureShare(g, g.g2_mul(shares_sk[i].x, g.hash_to_g2(docs[0])))
        for i in range(k)
    }
    assert (
        pk_set.combine_signatures(gold_shares).parity() == bits_out[0]
    ), "coin bit mismatch vs host golden"

    t0 = time.perf_counter()
    for it in range(iters):
        for c in range(n_chunks):
            flip_chunk(1 + it * n_chunks + c)
    dt = (time.perf_counter() - t0) / iters

    # single-core estimate: N G2 signs (~1.5ms) + N pairing verifies
    # (~1ms) + combine ≈ 0.16 s/flip ≈ 6 flips/s.
    fps = flips_total / dt
    return {
        "metric": "coin_flips_per_sec",
        "value": round(fps, 2),
        "unit": "flips/s",
        "vs_baseline": round(fps / 6.0, 3),
        "baseline": "estimated",
        "flips": flips_total,
        "chunk": chunk,
        "n": n,
        "signs_per_flip": n,
        "verifies_per_flip": n,
        "combine_width": k,
    }


def _adv_contaminated_items(backend, gct: int, k: int, frac: float, seed: int = 5,
                            doc: bytes = b"advm-%d", min_bad: int = 0):
    """(items, want) for a dec-share verify batch with ``frac`` of the
    shares (at least one when ``frac`` > 0, else ``min_bad``) swapped for
    another sender's share of the same ciphertext (well-typed, fails the
    pairing) — the rlc_dec_adversarial construction, parameterized over
    the contamination rate; ``doc`` % i is ciphertext i's plaintext."""
    from hbbft_tpu_torch.crypto.keys import SecretKeySet

    g = backend.group
    rng = random.Random(seed)
    sk_set = SecretKeySet.random(g, 5, rng)
    pk_set = sk_set.public_keys()
    sks = [sk_set.secret_key_share(i) for i in range(k)]
    cts = [pk_set.encrypt(doc % i, rng) for i in range(gct)]
    gen = backend.decrypt_shares_batch(
        [(sks[s], cts[ci]) for ci in range(gct) for s in range(k)]
    )
    items, want = [], []
    n_items = gct * k
    n_bad = max(1, int(frac * n_items)) if frac > 0 else min_bad
    bad_at = set(rng.sample(range(n_items), n_bad)) if n_bad else set()
    pos = 0
    for ci in range(gct):
        for s in range(k):
            share = gen[pos]
            good = pos not in bad_at
            if not good:  # forged: another sender's share for the same ct
                share = gen[ci * k + (s + 1) % k]
            items.append((pk_set.public_key_share(s), cts[ci], share))
            want.append(good)
            pos += 1
    return items, want


def bench_rlc_dec_adversarial() -> dict:
    """Grouped dec-share verification with 1-5% forged shares through the
    real backend path (verify_dec_shares): group mismatch → bisection →
    exact leaf pairings.  Measures the adversarial throughput."""
    from hbbft_tpu_torch.ops.backend import TorchBackend

    gct = _env_int("BENCH_ADV_GROUPS", 32)  # ciphertext groups
    k = _env_int("BENCH_ADV_K", 16)  # shares each
    frac = float(os.environ.get("BENCH_ADV_FRAC", "0.03"))

    backend = TorchBackend(device=device())
    items, want = _adv_contaminated_items(backend, gct, k, frac, doc=b"adv-%d", min_bad=1)
    n_items = gct * k
    n_bad = want.count(False)

    # warm (the bisection's first launches) + correctness
    got = backend.verify_dec_shares(items)
    assert got == want, "adversarial attribution wrong"
    iters = _env_int("BENCH_ADV_ITERS", 2)
    t0 = time.perf_counter()
    for _ in range(iters):
        backend.verify_dec_shares(items)
    dt = (time.perf_counter() - t0) / iters
    tput = n_items / dt
    return {
        "metric": "rlc_dec_verify_adversarial",
        "value": round(tput, 2),
        "unit": "shares/s",
        "vs_baseline": round(tput / CPU_BASELINE_CHECKS_PER_SEC, 3),
        "baseline": "estimated",
        "batch": n_items,
        "groups": gct,
        "contaminated": n_bad,
        "contamination_frac": round(n_bad / n_items, 4),
    }


def bench_adv_matrix() -> dict:
    """Contamination sweep {0, 1.6, 5, 15}% through the real grouped-RLC
    verify path, adaptive group sizing vs the HBBFT_TPU_NO_ADAPTIVE_RLC=1
    fixed arm.  ``epochs_per_s_est`` is the derived proxy: measured verify
    throughput / N² distinct dec-share verifies per epoch at the
    north-star N=100 dedup shape (10 000 per epoch)."""
    from hbbft_tpu_torch.ops.backend import TorchBackend

    gct = _env_int("BENCH_ADVM_GROUPS", 8)
    k = _env_int("BENCH_ADVM_K", 32)
    iters = _env_int("BENCH_ADVM_ITERS", 2)
    fracs = [
        float(x)
        for x in os.environ.get("BENCH_ADVM_FRACS", "0,0.016,0.05,0.15").split(",")
    ]
    shares_per_epoch_n100 = 100 * 100

    curve_rows = []
    kill = "HBBFT_TPU_NO_ADAPTIVE_RLC"
    saved = os.environ.get(kill)
    try:
        for frac in fracs:
            per_arm = {}
            for arm in ("adaptive", "fixed"):
                os.environ[kill] = "0" if arm == "adaptive" else "1"
                backend = TorchBackend(device=device())
                items, want = _adv_contaminated_items(backend, gct, k, frac)
                got = backend.verify_dec_shares(items)  # warm + train + check
                assert got == want, f"adv_matrix attribution wrong ({arm}, {frac})"
                lf0 = backend.counters.ladder_field_muls
                d0 = backend.counters.device_dispatches
                s0 = backend.counters.rlc_adaptive_splits
                t0 = time.perf_counter()
                for _ in range(iters):
                    got = backend.verify_dec_shares(items)
                dt = (time.perf_counter() - t0) / iters
                assert got == want, f"adv_matrix attribution wrong ({arm}, {frac})"
                tput = len(items) / dt
                per_arm[arm] = {
                    "shares_per_sec": round(tput, 2),
                    "epochs_per_s_est": round(tput / shares_per_epoch_n100, 4),
                    "ladder_field_muls": (
                        backend.counters.ladder_field_muls - lf0
                    ) // iters,
                    "device_dispatches": (
                        backend.counters.device_dispatches - d0
                    ) // iters,
                    # per iteration like the two deltas above (the warm
                    # training pass is excluded from all three)
                    "adaptive_splits": (
                        backend.counters.rlc_adaptive_splits - s0
                    ) // iters,
                }
            ratio = (
                per_arm["adaptive"]["shares_per_sec"]
                / per_arm["fixed"]["shares_per_sec"]
                if per_arm["fixed"]["shares_per_sec"]
                else None
            )
            curve_rows.append(
                {
                    "contamination_frac": frac,
                    "adaptive": per_arm["adaptive"],
                    "fixed": per_arm["fixed"],
                    "adaptive_over_fixed": round(ratio, 3) if ratio else None,
                }
            )
    finally:
        if saved is None:
            os.environ.pop(kill, None)
        else:
            os.environ[kill] = saved

    at5 = next(
        (r["adaptive_over_fixed"] for r in curve_rows
         if abs(r["contamination_frac"] - 0.05) < 1e-9),
        None,
    )
    return {
        "metric": "adv_matrix",
        # headline: adaptive-over-fixed wall ratio at the 5% point
        "value": at5 if at5 is not None else 0.0,
        "unit": "x (adaptive/fixed @5%)",
        "vs_baseline": at5 if at5 is not None else 0.0,
        "baseline": "fixed sizing",
        "batch": gct * k,
        "groups": gct,
        "curve": curve_rows,
        "adaptive_beats_fixed_at_5pct": bool(at5 and at5 > 1.0),
    }


def bench_g2_sign() -> dict:
    """Batched 254-bit G2 ladders — the sign op of batched coin flips."""
    import torch

    from hbbft_tpu_torch.crypto import bls381 as gold
    from hbbft_tpu_torch.crypto.field import R
    from hbbft_tpu_torch.ops import curve
    from hbbft_tpu_torch.utils.tree import tree_map

    batch = _env_int("BENCH_SIGN_BATCH", 1024)
    iters = _env_int("BENCH_ITERS", 3)
    rng = random.Random(3)
    scalars = [curve.safe_scalar(rng.randrange(1, R))[0] for _ in range(batch)]
    dev = device()
    bits = torch.as_tensor(curve.scalars_to_bits(scalars), device=dev)
    H = curve.g2_to_device([gold.G2_GEN] * batch, device=dev)

    def fn(H, bits):
        return curve.scalar_mul(curve._F2, bits, H)

    dt = _time_fn(fn, (H, bits), iters)

    # spot check one lane against the golden ladder
    got = curve.g2_from_device(tree_map(lambda c: c[:1], fn(H, bits)))[0]
    assert got == gold.ec_mul(gold.FQ2, scalars[0], gold.G2_GEN), "g2 ladder wrong"

    # a single-core CPU G2 mult is ~1-2ms (est.): baseline ~700 signs/s
    return {
        "metric": "g2_sign_throughput",
        "value": round(batch / dt, 2),
        "unit": "signs/s",
        "vs_baseline": round(batch / dt / 700.0, 3),
        "baseline": "estimated",
        "batch": batch,
    }


def bench_glv_ladder() -> dict:
    """GLV joint-table vs w2 ladder A/B on the backend's G1 mul path
    (``glv_ladder_ab``): per-ladder field-mul counts read off the
    ladder_field_muls counter plus wall-clock ladders/s for both arms.
    HBBFT_TPU_NO_GLV is read per batch, so the A/B runs in one process.
    Fresh random scalars per timed iteration; each g1_mul_batch call ends
    in a host readback, which is the fence.  Dispatches are kinded
    glv_ab so the row's device seconds never pollute DKG attribution."""
    from hbbft_tpu_torch.crypto.field import R
    from hbbft_tpu_torch.ops.backend import TorchBackend

    # below the combine threshold the backend takes the host-golden path
    # and no ladder is measured at all (the counters would divide by 0)
    batch = max(
        _env_int("BENCH_GLV_BATCH", 256), TorchBackend.device_combine_threshold
    )
    iters = max(1, _env_int("BENCH_GLV_ITERS", 3))

    def arm(no_glv: bool):
        saved = os.environ.pop("HBBFT_TPU_NO_GLV", None)
        # an ambient binary-ladder knob would disable GLV in both arms and
        # publish a vacuous reduction of 1.0
        saved_bin = os.environ.pop("HBBFT_TPU_LADDER_BINARY", None)
        if no_glv:
            os.environ["HBBFT_TPU_NO_GLV"] = "1"
        try:
            rng = random.Random(407)
            be = TorchBackend(device=device())
            g1 = be.group.g1()
            pts = [g1] * batch
            scal = [rng.randrange(R) for _ in range(batch)]
            be.g1_mul_batch(scal, pts, kind="glv_ab")  # warm
            c = be.counters
            muls0, tbl0 = c.ladder_field_muls, c.glv_table_field_muls
            t0 = time.perf_counter()
            for _ in range(iters):
                scal = [rng.randrange(R) for _ in range(batch)]
                out = be.g1_mul_batch(scal, pts, kind="glv_ab")
            dt = time.perf_counter() - t0
            # spot-check the last iteration against the host golden
            i = rng.randrange(batch)
            assert out[i] == be.group.g1_mul(scal[i], g1), "A/B arm is wrong"
            n = iters * batch
            return {
                "muls_per_ladder": (c.ladder_field_muls - muls0) / n,
                "table_muls_per_ladder": (c.glv_table_field_muls - tbl0) / n,
                "ladders_per_sec": n / dt,
                "decompositions": c.glv_decompositions,
            }
        finally:
            if saved is None:
                os.environ.pop("HBBFT_TPU_NO_GLV", None)
            else:
                os.environ["HBBFT_TPU_NO_GLV"] = saved
            if saved_bin is not None:
                os.environ["HBBFT_TPU_LADDER_BINARY"] = saved_bin

    glv = arm(no_glv=False)
    w2 = arm(no_glv=True)
    assert glv["decompositions"] > 0, "GLV arm never decomposed — vacuous A/B"
    assert w2["decompositions"] == 0, "kill switch leaked into the w2 arm"
    return {
        "metric": "glv_ladder_ab",
        "value": round(glv["ladders_per_sec"], 2),
        "unit": "ladders/s",
        "batch": batch,
        "field_muls_per_ladder_glv": round(glv["muls_per_ladder"], 1),
        "field_muls_per_ladder_w2": round(w2["muls_per_ladder"], 1),
        "field_mul_reduction": round(
            w2["muls_per_ladder"] / glv["muls_per_ladder"], 3
        ),
        "table_muls_per_ladder": round(glv["table_muls_per_ladder"], 1),
        "w2_ladders_per_sec": round(w2["ladders_per_sec"], 2),
        "glv_vs_w2": round(
            glv["ladders_per_sec"] / w2["ladders_per_sec"], 3
        ),
    }


def bench_fused_chain_ab() -> dict:
    """Fused tower chain vs stacked kernels (``fused_chain_ab``): the
    grouped rlc_sig verification graph in both compositions
    (``_rlc_sig(fused=True/False)``), timed by ``_time_fn``; bit-identical
    canonical readback between arms asserted, plus the env routing in
    both directions (``HBBFT_TPU_FUSED_TOWER`` keeps the fused chain, the
    kill switch must resolve to the stacked graph).  The analytic
    launch/mul model (pairing_chain) turns the fused wall into
    field-muls/s — the row's value — and gives the per-verification drop
    in kernel launches.  ``mode`` is ``cuda`` on the card (the fused
    kernels) and ``plain`` on the CPU (their plain versions)."""
    from hbbft_tpu_torch.ops import pairing, pairing_chain, tower
    from hbbft_tpu_torch.ops.backend import _rlc_sig
    from hbbft_tpu_torch.ops.tower_fused import fused_tower_mode

    g = _env_int("BENCH_FUSED_GROUPS", 64)
    k = _env_int("BENCH_RLC_K", 32)
    iters = _env_int("BENCH_ITERS", 3)

    fused_mode = "cuda" if device() == "cuda" else "plain"
    saved = {
        v: os.environ.pop(v, None)
        for v in ("HBBFT_TPU_FUSED_TOWER", "HBBFT_TPU_NO_FUSED_TOWER")
    }
    try:
        # env routing, both directions
        os.environ["HBBFT_TPU_FUSED_TOWER"] = "native"
        assert fused_tower_mode() is True
        os.environ["HBBFT_TPU_NO_FUSED_TOWER"] = "1"
        assert fused_tower_mode() is False, "kill switch leaked"
        del os.environ["HBBFT_TPU_NO_FUSED_TOWER"]

        S, PK, negG1, H = _synthetic_share_groups(g, k, seed=11)
        args = (S, PK, negG1, H, _bits([[1 + i * 6007 + j for j in range(k)]
                                         for i in range(g)]))

        def fused_fn(*a):
            return _rlc_sig(*a, fused=True)

        def stacked_fn(*a):
            return _rlc_sig(*a, fused=False)

        dt_fused = _time_fn(fused_fn, args, iters)
        dt_stacked = _time_fn(stacked_fn, args, iters)

        # bit-identical represented values between arms + real verdicts
        out_f = fused_fn(*args)
        out_s = stacked_fn(*args)
        assert tower.fq12_to_ints_batch(out_f, g) == tower.fq12_to_ints_batch(
            out_s, g
        ), "fused arm diverged from stacked graph"
        assert all(pairing.is_one_host_batch(out_f, g)), "verification wrong"

        muls = pairing_chain.analytic_chain_field_muls(g)
        launches_fused = pairing_chain.analytic_pallas_calls(2, fused=True)
        launches_stacked = pairing_chain.analytic_pallas_calls(2, fused=False)
        return {
            "metric": "fused_chain_ab",
            "value": round(muls / dt_fused, 2),
            "unit": "field_muls/s",
            "batch": g * k,
            "groups": g,
            "mode": fused_mode,
            "shares_per_sec": round(g * k / dt_fused, 2),
            "stacked_shares_per_sec": round(g * k / dt_stacked, 2),
            "fused_vs_stacked": round(dt_stacked / dt_fused, 3),
            "launch_drop": round(launches_stacked / launches_fused, 2),
        }
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
