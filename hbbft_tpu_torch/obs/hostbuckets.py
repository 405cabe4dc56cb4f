"""Host-bucket attribution: a region stack that itemizes host time.

The round-5 north-star measurement (PERF.md) attributes 55% of the
N=100 epoch to one opaque "host: everything else" bucket.  This module
is the counterpart of the per-kind ``device_seconds_*`` split for the
HOST side: a lightweight stack of timed regions that partitions the
host thread's wall time inside an engine epoch into named buckets
(``utils.metrics.Counters.host_bucket_*``).

Accounting rules (single host thread, so a plain stack suffices):

* A region bills its **exclusive** time: its own wall minus the wall of
  nested child regions minus any stretch the host spent *blocked in a
  device fetch* (``counters.fetch_blocked_seconds``, billed by
  ``ops/pipeline.DispatchPipeline._resolve`` — the single sync seam).
  Blocked time is device wait, not host work; counting it would make
  the host split double-bill ``device_seconds``.
* The outermost region (:meth:`HostBuckets.epoch`) additionally bills
  the epoch's TOTAL host time (wall minus blocked) to
  ``counters.host_seconds`` and its own exclusive residue to the
  ``other`` bucket.  Because every bucket is an exclusive slice of the
  same interval, **the host_bucket_* fields sum to host_seconds
  exactly** — the invariant ``tools/trace_report.py --host-buckets``
  validates from a trace, and the residual ``other`` bucket is the
  unattributed share the <10% acceptance bar tracks.
* With a tracer attached each region also emits a retroactive span on
  the ``host`` track (``host=True``, ``bucket=<name>``) carrying its
  exclusive seconds in ``args.exclusive_s`` — span intervals nest for
  Perfetto, while the exclusive_s args reproduce the counter partition
  from the trace alone (the same by-construction agreement the device
  spans have).

Zero-cost discipline: regions are a few perf_counter calls each and are
placed at *phase* granularity (a handful per round), never per item.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

#: the canonical bucket vocabulary (Counters.host_bucket_* field suffixes)
HOST_BUCKETS = (
    "encode",
    "rs_merkle",
    "assemble",
    "scatter",
    "staging",
    "dispatch",
    "other",
)


class HostBuckets:
    """Exclusive-time region stack billing ``Counters.host_bucket_*``.

    ``tracer_ref`` is a zero-arg callable returning the live tracer (the
    backend's tracer is attached after construction — same contract as
    the DispatchPipeline's).
    """

    __slots__ = ("counters", "_tracer_ref", "_stack", "_in_epoch")

    def __init__(
        self,
        counters,
        tracer_ref: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.counters = counters
        self._tracer_ref = tracer_ref
        # frames: [name, t0, child_inclusive_minus_blocked, blocked_at_t0]
        self._stack: list = []
        self._in_epoch = False

    @contextmanager
    def region(self, name: str):
        """Bill this block's exclusive host time to ``host_bucket_<name>``.

        ``name`` must be one of :data:`HOST_BUCKETS` (the counter field
        must exist; an unknown name raises at exit — loudly, because a
        silently dropped bucket would break the sums-to-total invariant).
        Regions nest arbitrarily; same-name nesting is fine (the child's
        slice simply moves from the parent to itself).

        Outside an :meth:`epoch` frame a region is a NO-OP: backend
        staging blocks run from bench micro-rows or direct backend use
        too, and billing them would break the buckets-sum-to-
        ``host_seconds`` invariant the ``--host-buckets`` gate validates
        (``host_seconds`` only accrues inside epochs).
        """
        if not self._in_epoch:
            yield
            return
        c = self.counters
        frame = [name, time.perf_counter(), 0.0, c.fetch_blocked_seconds]
        self._stack.append(frame)
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._stack.pop()
            inclusive = t1 - frame[1]
            blocked = c.fetch_blocked_seconds - frame[3]
            own = max(0.0, inclusive - frame[2] - blocked)
            field = "host_bucket_" + name
            setattr(c, field, getattr(c, field) + own)
            if self._stack:
                # transfer our NON-BLOCKED inclusive wall to the parent:
                # its own blocked delta already contains ours, so passing
                # the full inclusive would double-subtract the blocked part
                self._stack[-1][2] += inclusive - blocked
            tr = self._tracer_ref() if self._tracer_ref is not None else None
            if tr is not None:
                tr.complete(
                    f"host:{name}", frame[1], t1, cat="host_bucket",
                    track="host", host=True, bucket=name,
                    exclusive_s=own,
                )

    @contextmanager
    def epoch(self):
        """Outermost region of one engine epoch (or era change): bills
        ``counters.host_seconds`` with the total (wall minus fetch-
        blocked) and the residual unattributed slice to ``other``."""
        c = self.counters
        # derive the total from the buckets themselves, not a separate
        # clock pair: the region-exit bookkeeping (setattr/span emission)
        # would otherwise skew host_seconds off the bucket sum by a few
        # microseconds per region, and the sums-to-total invariant is
        # what --host-buckets validates
        before = sum(
            getattr(c, "host_bucket_" + b) for b in HOST_BUCKETS
        )
        was_in_epoch, self._in_epoch = self._in_epoch, True
        try:
            with self.region("other"):
                yield
        finally:
            self._in_epoch = was_in_epoch
            c.host_seconds += (
                sum(getattr(c, "host_bucket_" + b) for b in HOST_BUCKETS)
                - before
            )
