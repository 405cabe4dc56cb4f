"""Bounded mempool: admission, backpressure, and eviction over
:class:`~hbbft_tpu_torch.protocols.transaction_queue.TransactionQueue` —
the port's copy of the JAX package's ``traffic/mempool.py``.

The unbounded reference queue grows without limit under overload — at
"millions of users" that is an OOM, not a design.  :class:`BoundedMempool`
puts an admission layer in front:

* **validation first** — ``submit`` is a client-facing path, so every
  byte is attacker-controlled; the transaction is shape- and size-checked
  BEFORE any node state is touched, and a bad transaction is
  an accounting outcome, never an exception;
* **capacity** — at ``capacity`` entries the pool either rejects the
  newcomer (``policy="reject"``, protecting in-flight work) or evicts the
  oldest pending entry (``policy="evict_oldest"``, favoring fresh load);
* **backpressure** — ``backpressure`` trips at ``hi_frac`` of capacity
  and clears at ``lo_frac`` (hysteresis, so the signal doesn't flap at
  the boundary); closed-loop sources honor it, open-loop sources keep
  pushing and the admission accounting shows the shed load.

**Sharding.**  ``shards`` (a power of two, default 1) splits the
dedup/admission index over the transaction-digest keyspace: each tx
routes to the shard named by a sha256-of-canonical prefix (deterministic
across processes — python ``hash()`` is salted and would fork seeded
replays), so at sustained 10⁶-client load no single insertion-ordered
index absorbs every submit and the per-shard tombstone compaction cost
stays bounded by shard size, not pool size.  The capacity bound, the
hysteresis watermarks, and ``status()`` stay GLOBAL — callers see one
pool; per-outcome accounting lives on the shards and sums
(:meth:`shard_status` exposes the split).  Under ``evict_oldest`` the
displaced entry is the oldest of the newcomer's own shard (falling back
to the deepest shard when that one is empty) — FIFO per digest range,
not global FIFO.  ``shards=1`` routes nothing and consumes rng draws
exactly like the pre-shard pool, so existing seeded fingerprints are
unchanged.

Admission outcomes are strings (``accepted`` / ``duplicate`` /
``invalid`` / ``dropped`` / ``evicted_oldest``) consumed by
:class:`~hbbft_tpu_torch.traffic.tracker.TxTracker`.
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Optional

from hbbft_tpu_torch.protocols.transaction_queue import RemovalAccount, TransactionQueue
from hbbft_tpu_torch.utils import canonical

#: admission outcomes (``submit`` return values)
OUTCOMES = ("accepted", "duplicate", "invalid", "dropped", "evicted_oldest")


def default_validate(tx: Any, max_payload: int) -> bool:
    """Shape check for the canonical ``("tx", client, seq, payload)``
    transaction: exact arity, typed fields, bounded payload."""
    if not isinstance(tx, tuple) or len(tx) != 4:
        return False
    tag, client, seq, payload = tx
    if tag != "tx" or not isinstance(client, int) or not isinstance(seq, int):
        return False
    if client < 0 or seq < 0:
        return False
    if not isinstance(payload, bytes) or len(payload) > max_payload:
        return False
    return True


class _Shard:
    """One digest-range slice of the pool: its own queue + accounting."""

    __slots__ = (
        "q", "accepted", "duplicates", "invalid", "dropped", "evicted"
    )

    def __init__(self) -> None:
        self.q = TransactionQueue()
        self.accepted = 0
        self.duplicates = 0
        self.invalid = 0
        self.dropped = 0
        self.evicted = 0

    def status(self) -> dict:
        return {
            "depth": len(self.q),
            "accepted": self.accepted,
            "duplicates": self.duplicates,
            "invalid": self.invalid,
            "dropped": self.dropped,
            "evicted": self.evicted,
        }


class BoundedMempool:
    """Capacity-bounded admission wrapper around TransactionQueue."""

    def __init__(
        self,
        capacity: int,
        policy: str = "reject",
        max_payload: int = 1 << 16,
        hi_frac: float = 0.9,
        lo_frac: float = 0.7,
        validate=None,
        shards: int = 1,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if policy not in ("reject", "evict_oldest"):
            raise ValueError(f"unknown mempool policy {policy!r}")
        if shards < 1 or shards & (shards - 1) or shards > (1 << 16):
            raise ValueError(
                f"shards must be a power of two in [1, 65536], got {shards}"
            )
        self.capacity = capacity
        self.policy = policy
        self.max_payload = max_payload
        self.hi = max(1, int(capacity * hi_frac))
        self.lo = int(capacity * lo_frac)
        self._validate = validate or (
            lambda tx: default_validate(tx, self.max_payload)
        )
        self.shards = shards
        self._mask = shards - 1
        self._shards: List[_Shard] = [_Shard() for _ in range(shards)]
        self._depth = 0  # global live count (incremental: submit is O(1))
        self._backpressure = False
        #: the tx displaced by the most recent ``evicted_oldest`` submit
        #: (None otherwise) — the driver releases its tracker lifecycle
        #: when no other mempool still holds a copy
        self.last_evicted: Optional[Any] = None
        self.peak_depth = 0

    # -- routing -------------------------------------------------------------

    def _route(self, tx: Any, digest: Optional[bytes] = None) -> int:
        """Digest-prefix shard routing: sha256 of the canonical bytes,
        first four bytes masked down to the power-of-two shard count
        (four bytes cover every permitted shard count; two would leave
        shards beyond 2¹⁶ permanently empty).  Stable across processes
        (seeded-replay contract); an unencodable transaction routes to
        shard 0 — it is about to be accounted ``invalid`` anyway, never
        stored.  ``digest`` lets a caller that already hashed the tx
        (the driver hashes once per ARRIVAL and reuses it across all N
        node mempools and the tracker) skip the recompute."""
        if self._mask == 0:
            return 0
        if digest is None:
            try:
                digest = hashlib.sha256(canonical.encode(tx)).digest()
            except Exception:
                return 0
        return int.from_bytes(digest[:4], "big") & self._mask

    # -- admission (client-facing: validate before any state change) ---------

    def submit(self, tx: Any, digest: Optional[bytes] = None) -> str:
        ok = self._validate(tx)
        shard = self._shards[self._route(tx, digest)]
        if not ok:
            shard.invalid += 1
            return "invalid"
        if tx in shard.q:
            shard.duplicates += 1
            return "duplicate"
        outcome = "accepted"
        self.last_evicted = None
        if self._depth >= self.capacity:
            if self.policy == "reject":
                shard.dropped += 1
                return "dropped"
            victim_shard = shard if len(shard.q) else self._fullest()
            self.last_evicted = victim_shard.q.pop_oldest()
            self._depth -= 1
            victim_shard.evicted += 1
            outcome = "evicted_oldest"
        shard.q.push(tx)
        shard.accepted += 1
        self._depth += 1
        if self._depth > self.peak_depth:
            self.peak_depth = self._depth
        self._update_backpressure(self._depth)
        return outcome

    def _fullest(self) -> _Shard:
        """Deepest shard (lowest index on ties) — the evict fallback
        when the newcomer's own shard has nothing to displace."""
        best = self._shards[0]
        for sh in self._shards[1:]:
            if len(sh.q) > len(best.q):
                best = sh
        return best

    def _update_backpressure(self, depth: int) -> None:
        if self._backpressure:
            if depth <= self.lo:
                self._backpressure = False
        elif depth >= self.hi:
            self._backpressure = True

    # -- proposal / commit sides --------------------------------------------

    def choose(self, rng, amount: int) -> List[Any]:
        """Uniform random sample (without replacement) over ALL live
        entries.  Single shard delegates (rng draw order identical to
        the pre-shard pool — seeded fingerprints unchanged); sharded
        pools first split ``amount`` multivariate-hypergeometrically
        across shards (so the composite sample is exactly uniform over
        the union), then sample within each shard."""
        if self._mask == 0:
            return self._shards[0].q.choose(rng, amount)
        total = self._depth
        amount = min(amount, total)
        if amount <= 0:
            return []
        remaining = [len(sh.q) for sh in self._shards]
        counts = [0] * len(self._shards)
        left = total
        for _ in range(amount):
            r = rng.randrange(left)
            for i, rem in enumerate(remaining):
                if r < rem:
                    counts[i] += 1
                    remaining[i] -= 1
                    break
                r -= rem
            left -= 1
        out: List[Any] = []
        for i, k in enumerate(counts):
            if k:
                out.extend(self._shards[i].q.choose(rng, k))
        return out

    def remove_committed(self, txs) -> RemovalAccount:
        if self._mask == 0:
            acct = self._shards[0].q.remove_multiple(txs)
        else:
            buckets: dict = {}  # shard index -> txs routed there
            for tx in txs:
                buckets.setdefault(self._route(tx), []).append(tx)
            acct = RemovalAccount()
            for i in sorted(buckets):
                acct = acct.merged(
                    self._shards[i].q.remove_multiple(buckets[i])
                )
        self._depth -= acct.removed
        self._update_backpressure(self._depth)
        return acct

    # -- introspection -------------------------------------------------------

    @property
    def backpressure(self) -> bool:
        return self._backpressure

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def accepted(self) -> int:
        return sum(sh.accepted for sh in self._shards)

    @property
    def duplicates(self) -> int:
        return sum(sh.duplicates for sh in self._shards)

    @property
    def invalid(self) -> int:
        return sum(sh.invalid for sh in self._shards)

    @property
    def dropped(self) -> int:
        return sum(sh.dropped for sh in self._shards)

    @property
    def evicted(self) -> int:
        return sum(sh.evicted for sh in self._shards)

    def __len__(self) -> int:
        return self._depth

    def __contains__(self, tx: Any) -> bool:
        return tx in self._shards[self._route(tx)].q

    def shard_status(self) -> List[dict]:
        """Per-shard depth + outcome accounting (sums to :meth:`status`)."""
        return [sh.status() for sh in self._shards]

    def status(self) -> dict:
        return {
            "depth": self._depth,
            "capacity": self.capacity,
            "policy": self.policy,
            "backpressure": self._backpressure,
            "accepted": self.accepted,
            "duplicates": self.duplicates,
            "invalid": self.invalid,
            "dropped": self.dropped,
            "evicted": self.evicted,
            "peak_depth": self.peak_depth,
            "shards": self.shards,
        }
