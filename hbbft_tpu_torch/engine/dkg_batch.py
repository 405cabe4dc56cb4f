"""Batched threshold encryption for the array engine (the part of the JAX
package's ``engine/dkg_batch.py`` that the port's epoch runs).

``batched_encrypt`` is the public batched counterpart of
``crypto/keys.Ciphertext.encrypt``: every full-width scalar multiplication
goes through the backend's batched ladder dispatches
(``g1_mul_batch``/``g2_mul_batch``); hash-to-G2 and the pad XOR stay on
the host.  The batched era-change DKG that shares this module in the
reference waits for a later slice of the port.
"""

from __future__ import annotations

import time
from typing import List

from hbbft_tpu_torch.crypto.keys import Ciphertext


class DkgStats:
    """Work accounting of the batched ladders and host hashes (the fields
    of the reference's DkgStats that encryption fills)."""

    __slots__ = ("hashes_g2", "ladder_muls")

    def __init__(self) -> None:
        self.hashes_g2 = 0
        self.ladder_muls = 0


def batched_encrypt(
    backend, pk_els, msgs, rng, stats=None, kind: str = "dkg"
) -> List[Ciphertext]:
    """Threshold-encrypt msgs[i] to pk_els[i], ladders batched (same
    stages as Ciphertext.encrypt: U = s·G1, pad = H(s·PK), V = msg ⊕ pad,
    W = s·H2(U‖V)).  ``stats`` (a DkgStats) is optional work accounting.

    The returned ciphertexts carry the ENCRYPTOR's cached hash point;
    callers whose receivers must honestly pay their own hash-to-G2
    delete ``_hash_point`` first (as the array engine does)."""
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
