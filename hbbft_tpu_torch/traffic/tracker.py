"""Per-transaction lifecycle tracking: submit → queue → sampled → committed
— the port's copy of the JAX package's ``traffic/tracker.py``.

One :class:`TxTracker` observes every transaction the driver pushes at
the network and every Batch the network emits, and turns the stream into
the traffic subsystem's first-class metrics:

* ``tx_commit_latency`` histogram — submit time to commit time, in epoch
  units (p50/p90/p99 ride reports and heartbeats as ``tx_commit_p99``
  etc.; log-bucketed obs/histogram.py, so soak horizons stay O(1) memory
  per sample);
* ``tx_queue_latency`` histogram — submit to first sampled-into-proposal
  (the mempool-dwell component of commit latency);
* sustained committed-tx counter + drop/duplicate/shed accounting, so an
  overload run shows WHERE the offered load went (committed vs dropped at
  admission vs duplicate-submitted vs committed-elsewhere).

Commit dedup is cross-proposer: N decorrelated samples overlap, and a
transaction is committed once no matter how many proposals carried it —
``committed_duplicates`` counts the redundant copies.  A commit for a
transaction the tracker never saw submitted (possible when a driver only
tracks a subset of clients) is ``committed_unseen``, distinguishable from
the mempool's committed-elsewhere removals via
:class:`~hbbft_tpu_torch.protocols.transaction_queue.RemovalAccount`.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterable, Optional

from hbbft_tpu_torch.obs.histogram import Histogram
from hbbft_tpu_torch.utils import canonical


def _commit_digest(tx: Any) -> bytes:
    """Compact identity for the lifetime committed-set: canonical bytes
    hashed to 16 bytes, so dedup costs O(1) memory per committed tx
    regardless of payload size (a soak at thousands of tx/s would
    otherwise retain every payload tuple forever).  sha256, not
    ``hash()`` — Python's randomized hashing would break the
    cross-process seeded-replay fingerprint contract."""
    return hashlib.sha256(canonical.encode(tx)).digest()[:16]


class TxTracker:
    """Lifecycle observer; all times are virtual (epoch units).

    Besides the cumulative histograms, the tracker keeps a bounded
    RECENT window — per-epoch commit-latency bucket counts plus
    submitted/committed tallies for the last ``recent_epochs`` epochs —
    because the adaptive batch controller (hbbft_tpu_torch/control/) steers
    on the *live* operating point: a run-lifetime p99 would still be
    quoting the morning's quiet hours in the middle of a spike.  The
    window is O(recent_epochs × buckets) memory regardless of load and
    is NOT part of :meth:`fingerprint` (it is derived state; the
    cumulative counters already pin replay bit-identity).
    """

    def __init__(self, hist_factory=None, recent_epochs: int = 8) -> None:
        # hist_factory: Tracer.hist-compatible callable so a live tracer
        # owns the histograms (reports pick them up via hist_summary);
        # standalone use gets private Histograms.
        if hist_factory is None:
            self._own: Dict[str, Histogram] = {}

            def hist_factory(name: str) -> Histogram:
                h = self._own.get(name)
                if h is None:
                    h = self._own[name] = Histogram(name)
                return h

        self.hist = hist_factory
        self.recent_epochs = recent_epochs
        #: epoch -> {"submitted", "committed", "lat" bucket dict, "lat_min",
        #: "lat_max"} — trimmed to the last ``recent_epochs`` keys
        self._recent: Dict[int, Dict[str, Any]] = {}
        self._first_epoch: Optional[int] = None
        self._pending: Dict[Any, float] = {}  # tx -> submit time
        self._sampled_at: Dict[Any, float] = {}  # tx -> first proposal time
        self._committed: set = set()  # _commit_digest(tx) — never raw txs
        self.submitted = 0
        self.committed = 0
        self.committed_duplicates = 0  # redundant cross-proposer copies
        self.committed_unseen = 0  # committed but never tracked as submitted
        self.dropped = 0  # rejected at admission (mempool full)
        self.duplicate_submissions = 0  # client re-submitted a known tx
        self.invalid = 0  # failed admission validation
        self.shed = 0  # backpressure-deferred by a closed-loop source

    # -- the recent window ---------------------------------------------------

    def _epoch_slot(self, epoch: int) -> Dict[str, Any]:
        slot = self._recent.get(epoch)
        if slot is None:
            slot = self._recent[epoch] = {
                "submitted": 0,
                "committed": 0,
                "lat": {},
                "lat_min": None,
                "lat_max": None,
            }
            if self._first_epoch is None or epoch < self._first_epoch:
                self._first_epoch = epoch
            cutoff = epoch - self.recent_epochs
            for e in sorted(self._recent):
                if e <= cutoff:
                    del self._recent[e]
        return slot

    def recent_summary(
        self, window: Optional[int] = None, now: Optional[int] = None
    ) -> Dict[str, Any]:
        """Operating point over the last ``window`` epochs (default: the
        tracker's ``recent_epochs``): merged commit-latency p99 (None
        when nothing committed in the window), committed and submitted
        rates per epoch, plus ``submitted_last`` — the newest complete
        epoch's arrivals, the controller's spike-detection signal (a
        window AVERAGE dilutes a 10× swing's first epoch 4:1).

        ``now`` bounds the window to slots strictly BEFORE it AND
        anchors it at ``now - 1``.  Pass the current decision epoch:
        commits are recorded at their commit time (epoch+2), so without
        the bound a freshly-committed batch opens future slots whose
        zero ``submitted`` would dilute the arrival-rate estimate below
        the true offered load (measured: the controller mis-read a
        steady 100/epoch as ~50 and stepped B below demand) — and
        without the anchor a fully-idle tail would freeze the window at
        the last ACTIVE slot and report the pre-idle rates forever
        (pinning B high through the idle phase).  Rates divide by the
        number of epoch SLOTS in the window — silent epochs count as
        zeros, they are real time."""
        w = window or self.recent_epochs
        slots = self._recent
        if now is not None:
            slots = {e: s for e, s in self._recent.items() if e < now}
        if not slots:
            return {
                "epochs": 0,
                "p99": None,
                "committed_per_epoch": 0.0,
                "submitted_per_epoch": 0.0,
                "submitted_last": 0.0,
            }
        latest = (now - 1) if now is not None else max(slots)
        lo = max(latest - w + 1, self._first_epoch or 0)
        span = latest - lo + 1
        merged = Histogram("recent_commit_latency")
        submitted = committed = 0
        for e in range(lo, latest + 1):
            slot = slots.get(e)
            if slot is None:
                continue
            submitted += slot["submitted"]
            committed += slot["committed"]
            for b, c in sorted(slot["lat"].items()):
                merged.counts[b] = merged.counts.get(b, 0) + c
                merged.count += c
            v = slot["lat_min"]
            if v is not None and (merged.min is None or v < merged.min):
                merged.min = v
            v = slot["lat_max"]
            if v is not None and (merged.max is None or v > merged.max):
                merged.max = v
        last = slots.get(latest)
        return {
            "epochs": span,
            "p99": (
                round(merged.percentile(99), 3) if merged.count else None
            ),
            "committed_per_epoch": round(committed / span, 3),
            "submitted_per_epoch": round(submitted / span, 3),
            "submitted_last": float(last["submitted"] if last else 0),
        }

    # -- lifecycle events ----------------------------------------------------

    def on_submit(self, tx: Any, t: float, digest: bytes = None) -> None:
        """``digest`` (optional): the tx's full sha256-of-canonical, when
        the caller already computed it for shard routing — the committed-
        set key is its 16-byte prefix, so one hash serves both."""
        self.submitted += 1
        self._epoch_slot(int(t))["submitted"] += 1
        key = digest[:16] if digest is not None else _commit_digest(tx)
        if tx not in self._pending and key not in self._committed:
            self._pending[tx] = t

    def on_admission(self, outcome: str, tx: Any = None) -> None:
        """Aggregate one admission verdict (mempool.submit return).

        A transaction rejected everywhere (``dropped``/``invalid``) will
        never commit, so its pending entry is released immediately —
        otherwise an overload soak leaks tracker memory linearly in
        offered load and ``pending`` can never drain to the starved
        state.  (``duplicate`` means the tx is already live in a
        mempool, so its original pending entry stays.)"""
        if outcome == "dropped":
            self.dropped += 1
        elif outcome == "duplicate":
            self.duplicate_submissions += 1
        elif outcome == "invalid":
            self.invalid += 1
        if outcome in ("dropped", "invalid") and tx is not None:
            self._pending.pop(tx, None)
            self._sampled_at.pop(tx, None)

    def on_shed(self, n: int = 1) -> None:
        self.shed += n

    def on_evicted(self, tx: Any) -> None:
        """A tx evicted from its last mempool can never commit: release
        its lifecycle entries (the mempool's ``evicted`` counter owns the
        accounting), or evict-policy soaks leak tracker memory."""
        self._pending.pop(tx, None)
        self._sampled_at.pop(tx, None)

    def on_sampled(self, txs: Iterable[Any], t: float) -> None:
        """First inclusion in a proposal: close the queue-dwell interval."""
        qh = self.hist("tx_queue_latency")
        for tx in txs:
            if tx in self._sampled_at:
                continue
            sub = self._pending.get(tx)
            if sub is None:
                continue
            self._sampled_at[tx] = t
            qh.record(t - sub)

    def on_committed(self, txs: Iterable[Any], t: float) -> int:
        """Record a Batch's transactions; returns newly-committed count."""
        ch = self.hist("tx_commit_latency")
        slot = self._epoch_slot(int(t))
        new = 0
        for tx in txs:
            d = _commit_digest(tx)
            if d in self._committed:
                self.committed_duplicates += 1
                continue
            self._committed.add(d)
            new += 1
            sub = self._pending.pop(tx, None)
            self._sampled_at.pop(tx, None)
            if sub is None:
                self.committed_unseen += 1
            else:
                lat = t - sub
                ch.record(lat)
                b = Histogram._bucket(max(lat, 0.0))
                slot["lat"][b] = slot["lat"].get(b, 0) + 1
                if slot["lat_min"] is None or lat < slot["lat_min"]:
                    slot["lat_min"] = lat
                if slot["lat_max"] is None or lat > slot["lat_max"]:
                    slot["lat_max"] = lat
        slot["committed"] += new
        self.committed += new
        return new

    # -- summaries -----------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._pending)

    def latency_summary(self) -> Dict[str, float]:
        return self.hist("tx_commit_latency").summary()

    def commit_p99(self) -> float:
        return self.hist("tx_commit_latency").percentile(99)

    def summary(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted,
            "committed": self.committed,
            "pending": self.pending,
            "dropped": self.dropped,
            "duplicate_submissions": self.duplicate_submissions,
            "invalid": self.invalid,
            "shed": self.shed,
            "committed_duplicates": self.committed_duplicates,
            "committed_unseen": self.committed_unseen,
            "commit_latency": self.latency_summary(),
            "queue_latency": self.hist("tx_queue_latency").summary(),
        }

    def fingerprint(self) -> Dict[str, Any]:
        """Replay-determinism digest: exact counters plus the raw commit-
        latency bucket counts (two same-seed runs must match bit for
        bit)."""
        h = self.hist("tx_commit_latency")
        return {
            "submitted": self.submitted,
            "committed": self.committed,
            "dropped": self.dropped,
            "duplicates": self.duplicate_submissions,
            "latency_buckets": sorted(h.counts.items()),
        }
