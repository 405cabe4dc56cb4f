"""Transaction queue with random-sample proposals.

Rebuild of `src/transaction_queue.rs` § (SURVEY.md §2.1): a buffer of
pending transactions from which each epoch's proposal is a *random sample* —
randomization decorrelates the N nodes' proposals so the union (the ACS
output) covers more distinct transactions per epoch.

Sampling is O(batch_size)-ish, not O(mempool): alongside the
insertion-ordered dict the queue keeps an append-only index of keys
(``_order``) with lazy tombstones for removed entries.  ``choose`` draws
random *indices* into that list and rejects dead or repeated slots, so a
proposal over a million-entry mempool touches ~``amount`` entries instead
of materializing the whole buffer into a Python list (the pre-traffic
implementation paid O(mempool) per proposal per node per epoch).
Compaction runs when tombstones reach half the index — amortized O(1)
per removal — and the sampled-set distribution stays uniform without
replacement over the live entries (pinned in tests/test_traffic.py).
"""

from __future__ import annotations

from typing import Any, Iterable, List, NamedTuple, Optional

_MISSING = object()  # pop sentinel: a stored None tx is still "present"


class _DeadSlot:
    """Permanently-dead ``_order`` slot (its key relocated to the tail).

    A module-level class rather than a bare ``object()`` so queues
    holding relocated slots stay snapshotable: utils/snapshot.py
    auto-registers this module's classes, and identity is never tested
    against the singleton — dead slots are detected by ``k not in
    _txs``, which holds for any ``_DeadSlot`` instance a decode
    rebuilds."""


_DEAD = _DeadSlot()  # shared sentinel (hash-distinct from every real key)


class RemovalAccount(NamedTuple):
    """Outcome of :meth:`TransactionQueue.remove_multiple`.

    ``removed`` entries were present and dropped; ``absent`` entries were
    not in this queue — for a committed batch that means the transaction
    was committed from *other* nodes' proposals (or was never submitted
    here at all), which the traffic tracker accounts separately from
    local removals instead of the old silent ``pop(..., None)``.
    """

    removed: int = 0
    absent: int = 0

    def merged(self, other) -> "RemovalAccount":
        # ``other`` may be a plain 2-tuple (snapshots decode NamedTuples
        # as tuples — utils/snapshot.py)
        return RemovalAccount(self.removed + other[0], self.absent + other[1])


class TransactionQueue:
    """Default FIFO-set queue (insertion-ordered, deduplicated)."""

    def __init__(self, txs: Iterable[Any] = ()) -> None:
        self._txs: dict = {}  # insertion-ordered set
        self._order: List[Any] = []  # keys in insertion order (+ tombstones)
        self._indexed: dict = {}  # key -> its slot in _order
        self._stale = 0  # dead-slot count inside _order
        self._head = 0  # pop_oldest cursor: everything before it is dead
        for tx in txs:
            self.push(tx)

    def _ensure_index(self) -> None:
        """Rebuild the sampling index when absent — snapshots taken before
        the index existed restore via ``__new__`` + setattr
        (utils/snapshot.py) with only ``_txs`` populated."""
        if "_order" not in self.__dict__:
            self._order = list(self._txs)
            self._indexed = {k: i for i, k in enumerate(self._order)}
            self._stale = 0
            self._head = 0

    def push(self, tx: Any) -> None:
        self._ensure_index()
        k = _key(tx)
        if k not in self._txs:
            self._txs[k] = tx
            slot = self._indexed.get(k)
            if slot is None:
                self._indexed[k] = len(self._order)
                self._order.append(k)
            elif slot >= self._head:
                # a re-pushed tx whose tombstone is ahead of the pop
                # cursor keeps its original slot — a second append would
                # double its sampling weight
                self._stale -= 1
            else:
                # the tombstone sits BEHIND the pop_oldest cursor:
                # reviving it in place would hide a live entry from
                # pop_oldest (the evict_oldest mempool would then exceed
                # its capacity bound on a None pop).  Relocate to the
                # tail — the old slot dies for good (it is already
                # counted stale) and the re-push is FIFO-new.
                self._order[slot] = _DEAD
                self._indexed[k] = len(self._order)
                self._order.append(k)

    def extend(self, txs: Iterable[Any]) -> None:
        for tx in txs:
            self.push(tx)

    def __len__(self) -> int:
        return len(self._txs)

    def __contains__(self, tx: Any) -> bool:
        return _key(tx) in self._txs

    def _compact(self) -> None:
        self._order = [k for k in self._order if k in self._txs]
        self._indexed = {k: i for i, k in enumerate(self._order)}
        self._stale = 0
        self._head = 0

    def choose(self, rng, amount: int) -> List[Any]:
        """Random sample of up to ``amount`` transactions (uniform,
        without replacement, over the live entries)."""
        self._ensure_index()
        n = len(self._txs)
        if n <= amount:
            return list(self._txs.values())
        if self._stale * 2 > len(self._order):
            self._compact()  # amortized against the removals that staled it
        if amount * 3 >= n:
            # dense sample: rejection would thrash; one compacted pass is
            # ~the size of the result set anyway
            self._compact()
            keys = rng.sample(self._order, amount)
            return [self._txs[k] for k in keys]
        order = self._order
        txs = self._txs
        chosen: List[Any] = []
        taken: set = set()
        while len(chosen) < amount:
            i = rng.randrange(len(order))
            if i in taken:
                continue
            k = order[i]
            if k not in txs:
                continue  # tombstone (≤ half the index by construction)
            taken.add(i)
            chosen.append(txs[k])
        return chosen

    def pop_oldest(self) -> Optional[Any]:
        """Remove and return the oldest live transaction (None if empty) —
        the bounded mempool's evict-oldest policy.  Amortized O(1): the
        cursor advances over slots instead of shifting the list; the
        popped slot becomes a tombstone and ordinary compaction reclaims
        the prefix.  No live entry ever sits behind the cursor: a
        re-push whose tombstone is behind it relocates to the tail
        (``push``), so an empty scan really means an empty queue."""
        self._ensure_index()
        order, txs = self._order, self._txs
        while self._head < len(order):
            k = order[self._head]
            self._head += 1
            if k in txs:
                tx = txs.pop(k)
                self._stale += 1  # its slot stays behind the cursor
                if self._stale * 2 > len(order):
                    self._compact()
                return tx
        return None

    def remove_multiple(self, txs: Iterable[Any]) -> RemovalAccount:
        """Drop committed transactions; returns per-call accounting so
        callers can distinguish locally-removed from committed-elsewhere
        (``absent``: the entry was never in this queue)."""
        self._ensure_index()
        removed = absent = 0
        for tx in txs:
            if self._txs.pop(_key(tx), _MISSING) is not _MISSING:
                removed += 1
                self._stale += 1
            else:
                absent += 1
        return RemovalAccount(removed, absent)


def _key(tx: Any):
    """Hashable identity for a transaction (lists/dicts via canonical bytes)."""
    try:
        hash(tx)
        return tx
    except TypeError:
        from hbbft_tpu_torch.utils import canonical

        return canonical.encode(tx)
