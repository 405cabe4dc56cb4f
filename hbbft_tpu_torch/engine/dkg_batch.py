"""Batched era-change DKG for the lockstep array engine, the port's copy of
the JAX package's ``engine/dkg_batch.py``.

The protocol math of SyncKeyGen among all N nodes, in array form:

* every full-width scalar multiplication (bivariate commitment
  coefficients, ciphertext U/shared/W components, row/value decryption
  ladders) goes through the backend's batched ladder dispatches
  (``g1_mul_batch``/``g2_mul_batch``: thousands of independent 255-bit
  ladders per device call);
* every ciphertext validity check (e(G1, W) == e(U, H2(U‖V))) goes
  through ``backend.verify_ciphertexts``: batched pairing dispatches
  instead of N³ sequential host pairings;
* the commitment cross-checks (row checks f_p(k+1,·)·G == C_p.row(k+1),
  ack checks f_p(a+1,k+1)·G == C_p(a+1,k+1)) collapse under a random
  linear combination: Σ w·(value·G − commit-eval) == O.  The weights fold
  into pure Fr arithmetic on the host, and the commitment points enter one
  aggregated multi-scalar combination, ``backend.g1_lincomb`` (the device
  MSM of ``TorchBackend``).  A forged value survives with probability
  2⁻⁶⁴ per weight.

What stays on the host: hash-to-G2 of each ciphertext (the native kernel
of ``native/hashg2_kernel.c``), pad/XOR symmetric encryption, and the Fr
polynomial arithmetic.

The engine's ``rng`` is drawn in the reference's order (``BivarPoly.random``
per proposer, then each ``batched_encrypt``'s scalars, then the RLC weight
grids), so the port and the JAX package derive the same ``PublicKeySet``
and the same share for every node from the same seed
(tests/test_torch_era.py holds them equal).  ``batched_encrypt`` also
serves the engine's per-epoch contribution encryption.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

from hbbft_tpu_torch.crypto.field import interpolate_at_zero
from hbbft_tpu_torch.crypto.keys import Ciphertext, PublicKeySet, SecretKeyShare
from hbbft_tpu_torch.crypto.poly import BivarPoly, Commitment
from hbbft_tpu_torch.utils import canonical


class DkgStats:
    """Work accounting mirroring the per-node path's report fields."""

    __slots__ = (
        "parts_handled", "acks_handled", "ciphertexts_verified",
        "hashes_g2", "ladder_muls", "msm_terms",
    )

    def __init__(self) -> None:
        self.parts_handled = 0
        self.acks_handled = 0
        self.ciphertexts_verified = 0
        self.hashes_g2 = 0
        self.ladder_muls = 0
        self.msm_terms = 0


def batched_encrypt(
    backend, pk_els, msgs, rng, stats=None, kind: str = "dkg"
) -> List[Ciphertext]:
    """Threshold-encrypt msgs[i] to pk_els[i], ladders batched — the
    public batched counterpart of crypto/keys.Ciphertext.encrypt (same
    stages: U = s·G1, pad = H(s·PK), V = msg ⊕ pad, W = s·H2(U‖V)).
    Used by the DKG phases here and by the array engine's contribution
    encryption.  ``stats`` (a DkgStats) is optional work accounting.

    The returned ciphertexts carry the ENCRYPTOR's cached hash point;
    callers whose receivers must honestly pay their own hash-to-G2
    delete ``_hash_point`` first (as _batched_decrypt and the array
    engine both do)."""
    if stats is None:
        stats = DkgStats()
    g = backend.group
    n = len(msgs)
    ss = [rng.randrange(1, g.r) for _ in range(n)]
    base = [g.g1()] * n
    us = backend.g1_mul_batch(ss, base, kind)
    shareds = backend.g1_mul_batch(ss, list(pk_els), kind)
    stats.ladder_muls += 2 * n
    vs = []
    hs = []
    t0 = time.perf_counter()
    for i in range(n):
        pad = g.hash_bytes(g.g1_to_bytes(shareds[i]), len(msgs[i]))
        v = bytes(a ^ b for a, b in zip(msgs[i], pad))
        vs.append(v)
        hs.append(g.hash_to_g2(g.g1_to_bytes(us[i]) + v))
    # billed directly (not via the backend's hash cache): these docs must
    # NOT enter that cache, or the receiver's honest re-hash inside
    # verify_ciphertexts would become a free cache hit
    backend.counters.hash_g2_seconds += time.perf_counter() - t0
    stats.hashes_g2 += n
    ws = backend.g2_mul_batch(ss, hs, kind)
    stats.ladder_muls += n
    out = []
    for i in range(n):
        ct = Ciphertext(g, us[i], vs[i], ws[i])
        ct._hash_point = hs[i]  # encryptor-side cache (receiver recomputes)
        out.append(ct)
    return out


def _batched_decrypt(backend, cts, sk_xs, stats) -> List[bytes]:
    """Decrypt cts[i] under secret scalar sk_xs[i], ladders + pairings
    batched.  Mirrors SecretKey.decrypt: validity pairing first (receiver
    recomputes H2(U‖V) — the honest per-receiver workload), then
    pad = H(x·U), plaintext = V ⊕ pad."""
    g = backend.group
    n = len(cts)
    for ct in cts:
        # drop the encryptor's cached hash point: the receiving role must
        # pay (and count) its own hash-to-G2
        if hasattr(ct, "_hash_point"):
            del ct._hash_point
    ok = backend.verify_ciphertexts(cts)
    stats.ciphertexts_verified += n
    stats.hashes_g2 += n
    if not all(ok):
        bad = ok.index(False)
        raise ValueError(f"batched DKG: invalid ciphertext at index {bad}")
    shareds = backend.g1_mul_batch(list(sk_xs), [ct.u for ct in cts])
    stats.ladder_muls += n
    out = []
    for i in range(n):
        pad = g.hash_bytes(g.g1_to_bytes(shareds[i]), len(cts[i].v))
        out.append(bytes(a ^ b for a, b in zip(cts[i].v, pad)))
    return out


def _rlc_weight(rng) -> int:
    """64-bit nonzero random weight — the grouped-RLC standard width
    (ops/backend.py rlc discussion; soundness 2⁻⁶⁴ per forged item)."""
    return rng.randrange(1, 1 << 64)


def batched_era_dkg(
    backend,
    ids: Sequence[Any],
    sk_xs: Dict[Any, int],
    pk_els: Dict[Any, Any],
    threshold: int,
    rng,
) -> Tuple[PublicKeySet, Dict[Any, SecretKeyShare], DkgStats]:
    """Full-workload SyncKeyGen among all N nodes, device-batched.

    ``sk_xs``/``pk_els`` are each node's long-term secret scalar / public
    G1 element (the encryption keys the per-node path uses).  Returns the
    master PublicKeySet, per-node SecretKeyShares, and work stats; raises
    on any check failure (the lockstep engine is all-honest — a failure
    is a bug, and callers may re-run the per-node path for attribution).
    """
    g = backend.group
    n = len(ids)
    t = threshold
    stats = DkgStats()

    # -- proposal phase: bivariate polys + commitments (batched muls) -------
    polys: List[BivarPoly] = [BivarPoly.random(g, t, rng) for _ in range(n)]
    flat_scalars: List[int] = []
    for poly in polys:
        for row in poly.coeffs:
            flat_scalars.extend(row)
    m = t + 1
    base = g.g1()
    commit_pts = backend.g1_mul_batch(flat_scalars, [base] * len(flat_scalars))
    stats.ladder_muls += len(flat_scalars)
    # commit_grid[p][i][j] = coeffs[p][i][j]·G1
    commit_grid = [
        [
            commit_pts[p * m * m + i * m : p * m * m + i * m + m]
            for i in range(m)
        ]
        for p in range(n)
    ]

    # -- row distribution: encrypt row^p_k coeffs to node k -----------------
    # row^p_k = f^p(k+1, ·) — what Part.rows carries in the per-node path.
    row_coeffs: List[List[List[int]]] = []  # [p][k][j]
    enc_pk: List[Any] = []
    enc_msgs: List[bytes] = []
    for p in range(n):
        per_k = []
        for k, nid in enumerate(ids):
            coeffs = polys[p].row(k + 1).coeffs
            per_k.append(coeffs)
            enc_pk.append(pk_els[nid])
            enc_msgs.append(canonical.encode(list(coeffs)))
        row_coeffs.append(per_k)
    row_cts = batched_encrypt(backend, enc_pk, enc_msgs, rng, stats)

    # -- part handling: each node decrypts + checks its row -----------------
    dec_xs = [sk_xs[ids[k]] for _ in range(n) for k in range(n)]
    row_plain = _batched_decrypt(backend, row_cts, dec_xs, stats)
    got_rows: List[List[List[int]]] = [[None] * n for _ in range(n)]
    for p in range(n):
        for k in range(n):
            coeffs = canonical.decode(row_plain[p * n + k])
            if not isinstance(coeffs, list) or len(coeffs) != m:
                raise ValueError("batched DKG: malformed row plaintext")
            got_rows[p][k] = [c % g.r for c in coeffs]
    stats.parts_handled += n * n

    # Row commitment RLC check, all (p, k, j) at once:
    #   Σ w_{pkj}·row^p_k[j]·G  ==  Σ_{pij} C^p_ij · (Σ_k w_{pkj}(k+1)^i)
    xpow = [[pow(k + 1, i, g.r) for i in range(m)] for k in range(n)]
    w_row = [
        [[_rlc_weight(rng) for _ in range(m)] for _ in range(n)]
        for _ in range(n)
    ]
    lhs_scalar = 0
    for p in range(n):
        for k in range(n):
            row = got_rows[p][k]
            wk = w_row[p][k]
            for j in range(m):
                lhs_scalar = (lhs_scalar + wk[j] * row[j]) % g.r
    agg_scalars: List[int] = []
    agg_points: List[Any] = []
    for p in range(n):
        for i in range(m):
            for j in range(m):
                s = 0
                for k in range(n):
                    s += w_row[p][k][j] * xpow[k][i]
                agg_scalars.append(s % g.r)
                agg_points.append(commit_grid[p][i][j])
    stats.msm_terms += len(agg_points)
    rhs = backend.g1_lincomb(agg_scalars, agg_points)
    lhs = g.g1_mul(lhs_scalar, base)
    if lhs != rhs:
        raise ValueError("batched DKG: aggregated row-commitment check failed")

    # -- ack phase: every node acks every part to every node ----------------
    # value v^p_{a,k} = row^p_a(k+1); acker a encrypts it to node k.
    ack_vals: List[List[List[int]]] = []  # [p][a][k]
    enc_pk2: List[Any] = []
    enc_msgs2: List[bytes] = []
    for p in range(n):
        per_a = []
        for a in range(n):
            rowpoly = got_rows[p][a]
            per_k = []
            for k, nid in enumerate(ids):
                acc = 0
                for c in reversed(rowpoly):
                    acc = (acc * (k + 1) + c) % g.r
                per_k.append(acc)
                enc_pk2.append(pk_els[nid])
                enc_msgs2.append(canonical.encode(acc))
            per_a.append(per_k)
        ack_vals.append(per_a)
    ack_cts = batched_encrypt(backend, enc_pk2, enc_msgs2, rng, stats)

    dec_xs2 = [
        sk_xs[ids[k]]
        for p in range(n)
        for a in range(n)
        for k in range(n)
    ]
    ack_plain = _batched_decrypt(backend, ack_cts, dec_xs2, stats)
    got_vals: List[List[List[int]]] = [
        [[None] * n for _ in range(n)] for _ in range(n)
    ]
    idx = 0
    for p in range(n):
        for a in range(n):
            for k in range(n):
                v = canonical.decode(ack_plain[idx])
                idx += 1
                if not isinstance(v, int):
                    raise ValueError("batched DKG: malformed ack plaintext")
                got_vals[p][a][k] = v % g.r
    stats.acks_handled += n * n * n

    # Ack RLC check, all (p, a, k) at once:
    #   Σ w·v^p_{a,k}·G == Σ_{pij} C^p_ij · (Σ_a (a+1)^i Σ_k w_{pak}(k+1)^j)
    # (f symmetric: f(a+1, k+1) = Σ_ij c_ij (a+1)^i (k+1)^j.)
    w_ack = [
        [[_rlc_weight(rng) for _ in range(n)] for _ in range(n)]
        for _ in range(n)
    ]
    lhs_scalar2 = 0
    for p in range(n):
        for a in range(n):
            wa = w_ack[p][a]
            va = got_vals[p][a]
            for k in range(n):
                lhs_scalar2 = (lhs_scalar2 + wa[k] * va[k]) % g.r
    agg_scalars2: List[int] = []
    agg_points2: List[Any] = []
    for p in range(n):
        # inner[a][j] = Σ_k w_{pak}(k+1)^j  (separable double sum)
        inner = [
            [sum(w_ack[p][a][k] * xpow[k][j] for k in range(n)) % g.r
             for j in range(m)]
            for a in range(n)
        ]
        for i in range(m):
            for j in range(m):
                s = 0
                for a in range(n):
                    s += xpow[a][i] * inner[a][j]
                agg_scalars2.append(s % g.r)
                agg_points2.append(commit_grid[p][i][j])
    stats.msm_terms += len(agg_points2)
    rhs2 = backend.g1_lincomb(agg_scalars2, agg_points2)
    lhs2 = g.g1_mul(lhs_scalar2, base)
    if lhs2 != rhs2:
        raise ValueError("batched DKG: aggregated ack-value check failed")

    # -- key derivation (mirrors SyncKeyGen.generate exactly) ---------------
    # All parts complete in the honest lockstep run; the deterministic
    # choice is the first t+1 proposer indices.
    complete = list(range(t + 1))
    master: List[Any] = None
    for p in complete:
        row0 = commit_grid[p][0]  # BivarCommitment.row(0) = C^p_{0j}
        if master is None:
            master = list(row0)
        else:
            master = [g.g1_add(x, y) for x, y in zip(master, row0)]
    pk_set = PublicKeySet(Commitment(g, master))

    shares: Dict[Any, SecretKeyShare] = {}
    for k, nid in enumerate(ids):
        share_val = 0
        for p in complete:
            pts = [(a + 1, got_vals[p][a][k]) for a in range(t + 1)]
            share_val = (share_val + interpolate_at_zero(pts, g.r)) % g.r
        shares[nid] = SecretKeyShare(g, share_val)

    # consistency: every share must match the master commitment (batched)
    share_pts = backend.g1_mul_batch(
        [shares[nid].x for nid in ids], [base] * n
    )
    stats.ladder_muls += n
    for k, nid in enumerate(ids):
        if share_pts[k] != pk_set.public_key_share(k).el:
            raise ValueError(f"batched DKG: share {k} disagrees with master")
    return pk_set, shares, stats
