"""Pipelined device dispatch — the deferred-fetch seam (the JAX package's
``ops/pipeline.py``; ``DispatchPipeline`` is carried over unchanged).

PyTorch's CUDA model is asynchronous like JAX's: the kernels of a
dispatch are enqueued on the current stream and the host returns at
once; only copying an output to the host blocks.  A dispatch is therefore
*submitted* (its kernels enqueued) and its fetch *deferred* behind a
bounded in-flight queue, so the host assembles chunk k+1 while chunk k
executes on the card.

Contract (what the backend relies on):

* **Identical outputs.**  Pipelining changes only *when* a result is
  copied to the host, never what was computed; each delivery callback
  writes to slots no other callback touches.  ``HBBFT_TPU_NO_PIPELINE=1``
  forces depth 0 (fetch before ``submit`` returns).
* **Bounded in-flight buffers.**  At most ``depth`` (default 2,
  ``HBBFT_TPU_PIPELINE_DEPTH``) unfetched dispatches are held; submitting
  when full first resolves the oldest entry (FIFO).
* **Attribution.**  Each dispatch bills its dispatch→fetch wall interval
  to ``counters.device_seconds`` (+ the per-kind bucket) and, with a
  tracer attached, emits the identical interval as a ``device=True``
  span; in-flight slots get their own ``device/<slot>`` tracks and
  ``counters.overlap_seconds`` accumulates the host time that hid under
  device execution.

The *only* host sync point is :func:`fetch_to_host` below.
"""

from __future__ import annotations

import heapq
import os
import time
from collections import deque
from typing import Any, Callable, List, Optional

from hbbft_tpu_torch.utils.tree import tree_map


def hostpipe_enabled() -> bool:
    """Kill switch for the HOST half of the epoch: the array engine's
    vectorized assembly/scatter fast paths and its cross-round
    deferred-verify overlap.  ``HBBFT_TPU_NO_HOSTPIPE=1`` restores the
    per-item loops and strictly ordered verification — outputs are
    bit-identical and ``device_dispatches`` unchanged either way.
    Re-read per epoch so in-process A/Bs take effect immediately."""
    return not os.environ.get("HBBFT_TPU_NO_HOSTPIPE")


def device_rs_enabled() -> bool:
    """Kill switch for the device erasure/hash plane: batched RS
    encode/reconstruct as GF(2⁸) bit products and device SHA-256 Merkle
    build/verify routed through the dispatch seam.
    ``HBBFT_TPU_NO_DEVICE_RS=1`` restores the host codec/hashlib path
    bit-for-bit.  Re-read per call so in-process A/Bs take effect
    immediately."""
    return not os.environ.get("HBBFT_TPU_NO_DEVICE_RS")


def pipeline_depth() -> int:
    """Max in-flight dispatches.  Re-read per submit so in-process A/Bs
    (``HBBFT_TPU_NO_PIPELINE=1`` vs. default) take effect immediately."""
    if os.environ.get("HBBFT_TPU_NO_PIPELINE"):
        return 0
    try:
        d = int(os.environ.get("HBBFT_TPU_PIPELINE_DEPTH", "2"))
    except ValueError:
        d = 2
    return max(0, d)


def fetch_to_host(out):
    """THE deferred-fetch seam: copy a dispatch's output tree (nested
    tuples of tensors) to host numpy.  Blocks until the device work that
    produced it completes."""
    return tree_map(lambda t: t.cpu().numpy(), out)


class PendingDispatch:
    """One launched-but-unfetched dispatch.

    ``value`` is populated by :meth:`resolve` (idempotent); ``slot`` is
    the in-flight tracer-track index, or None for a synchronous entry
    (sync entries span the classic ``device`` track)."""

    __slots__ = (
        "t0", "t_issued", "kind", "items", "slot", "_blocked_at_issue",
        "_raw", "_fetch", "_on_result", "_pipe", "done", "value",
    )

    def __init__(self, pipe, raw, fetch, kind, items, slot, on_result, t0, t_issued):
        self._pipe = pipe
        self._raw = raw
        self._fetch = fetch
        self._on_result = on_result
        self.kind = kind
        self.items = items
        self.slot = slot
        self.t0 = t0
        self.t_issued = t_issued
        self._blocked_at_issue = pipe._fetch_blocked
        self.done = False
        self.value: Any = None

    def resolve(self):
        """Fetch + bill + deliver (no-op after the first call)."""
        return self._pipe._resolve(self)


class DispatchPipeline:
    """Bounded FIFO of in-flight dispatches with deferred fetches.

    ``counters`` (a ``utils.metrics.Counters`` or None) receives the
    device-time / overlap attribution; ``tracer_ref`` is a zero-arg
    callable returning the live tracer (the backend's tracer is attached
    *after* construction, so it must be read at resolve time).
    ``depth_fn`` overrides the env-driven depth (tests, MockBackend).
    """

    def __init__(
        self,
        counters=None,
        tracer_ref: Optional[Callable[[], Any]] = None,
        depth_fn: Callable[[], int] = pipeline_depth,
    ) -> None:
        self._counters = counters
        self._tracer_ref = tracer_ref
        self._depth_fn = depth_fn
        #: opt-in happens-before probe (analysis/schedules.RaceTracker):
        #: when attached, every submit/resolve reports an event with a
        #: vector clock, so a schedule divergence is reported as a
        #: concrete racing access pair.  None costs one attribute check.
        self.probe = None
        self._q: deque = deque()
        self._free_slots: List[int] = []
        self._slots_created = 0
        #: cumulative host seconds spent BLOCKED inside fetches.  Each
        #: entry snapshots this at launch so its overlap window can
        #: exclude time the host spent waiting on OTHER entries' fetches
        #: — otherwise overlap_seconds would count fetch-block wall as
        #: "hidden assembly" and overstate the pipeline's win.
        self._fetch_blocked = 0.0

    def __len__(self) -> int:
        return len(self._q)

    def _alloc_slot(self) -> int:
        # lint: allow[seam-race] slot ids are recycled only after their
        # dispatch resolved; reuse order affects tracer track NAMES only,
        # never delivered values (callbacks write disjoint slots)
        if self._free_slots:
            return heapq.heappop(self._free_slots)
        s = self._slots_created
        self._slots_created += 1
        return s

    def submit(
        self,
        launch: Callable[[], Any],
        fetch: Optional[Callable[[Any], Any]] = fetch_to_host,
        kind: str = "",
        items: int = 0,
        on_result: Optional[Callable[[Any], None]] = None,
        sync: bool = False,
    ) -> PendingDispatch:
        """Launch one dispatch; defer its fetch up to the queue depth.

        ``launch()`` issues the (async) device call and returns the raw
        output handle; ``fetch(raw)`` materializes it on host (None =
        identity, for host-computed mock entries).  ``on_result(value)``
        delivers the fetched value — it must write only slots owned by
        this dispatch, so completion order never matters.

        ``sync=True`` (or depth 0 via the kill switch) resolves every
        older entry and then this one before returning — the exact
        pre-pipeline synchronous behavior, used where control flow needs
        the result immediately (RLC bisection rounds, single combines).
        """
        depth = 0 if sync else self._depth_fn()
        t0 = time.perf_counter()
        raw = launch()
        t_issued = time.perf_counter()
        slot = None if depth <= 0 else self._alloc_slot()
        p = PendingDispatch(
            self, raw, fetch, kind, items, slot, on_result, t0, t_issued
        )
        if self.probe is not None:
            self.probe.pipe_submit(p)
        if depth <= 0:
            # Drain FIFO first so delivery order degenerates to program
            # order — byte-compatible with the pre-pipeline seam.
            # lint: allow[seam-race] _q IS the pipeline API: the bounded
            # FIFO handoff itself; entries are opaque PendingDispatch
            # objects and every delivery writes only slots it owns
            while self._q:
                self._q.popleft().resolve()
            self._resolve(p)
            return p
        self._q.append(p)
        # Launch-then-trim: the new dispatch is already on the device
        # stream while the oldest entry's fetch (and its host-side
        # delivery work, e.g. Jacobian→affine conversion) runs.
        while len(self._q) > depth:
            self._q.popleft().resolve()
        return p

    def flush(self, order: Optional[List[int]] = None) -> None:
        """Resolve every pending dispatch (FIFO, or by explicit ``order``
        — a permutation of indices into the current pending list, used by
        MockBackend to exercise out-of-order completion deterministically)."""
        pending = list(self._q)
        self._q.clear()
        if order is not None:
            pending = [pending[i] for i in order]
        for p in pending:
            p.resolve()

    def _track_for(self, p: PendingDispatch) -> str:
        """Tracer track a resolved dispatch's span lands on.  The shard
        pipeline (parallel/shardpipe.py) overrides this so sharded
        entries span their DEVICE's ``device/<n>`` track instead of the
        in-flight slot's."""
        return "device" if p.slot is None else f"device/{p.slot}"

    def _bill_device(self, p: PendingDispatch, dt: float) -> None:
        """Per-device attribution hook (no-op on the single-queue
        pipeline): called once per resolve with the same [t0, t1]
        interval the counters and tracer bill."""

    def _resolve(self, p: PendingDispatch):
        if p.done:
            return p.value
        p.done = True
        if self.probe is not None:
            self.probe.pipe_resolve(p)
        t_req = time.perf_counter()
        # fetch-block seconds other entries accrued inside THIS entry's
        # [t_issued, t_req] window — sampled before our own fetch adds in
        blocked_in_window = self._fetch_blocked - p._blocked_at_issue
        value = p._fetch(p._raw) if p._fetch is not None else p._raw
        t1 = time.perf_counter()
        self._fetch_blocked += t1 - t_req
        p._raw = None  # release the device buffer reference
        dt = t1 - p.t0
        self._bill_device(p, dt)
        c = self._counters
        if c is not None:
            # host-bucket attribution (obs/hostbuckets.py): the fetch
            # itself is device WAIT, not host work — regions subtract it
            c.fetch_blocked_seconds += t1 - t_req
            c.device_seconds += dt
            if p.kind:
                name = "device_seconds_" + p.kind
                setattr(c, name, getattr(c, name) + dt)
            if p.slot is not None:
                # Host time spent doing USEFUL work while this dispatch
                # was in flight: launch return → fetch request, minus
                # the stretches spent blocked in other entries' fetches.
                # This is the assembly (and delivery) work that actually
                # hid under device execution.
                c.overlap_seconds += max(
                    0.0, (t_req - p.t_issued) - blocked_in_window
                )
                c.pipelined_dispatches += 1
        tr = self._tracer_ref() if self._tracer_ref is not None else None
        if tr is not None:
            track = self._track_for(p)
            tr.complete(
                f"dispatch:{p.kind or 'unkinded'}", p.t0, t1,
                cat=p.kind or "unkinded", track=track, items=p.items,
                device=True,
            )
            if p.items:
                tr.hist("dispatch_batch_items").record(p.items)
        if p.slot is not None:
            heapq.heappush(self._free_slots, p.slot)
        p.value = value
        if p._on_result is not None:
            p._on_result(value)
        return value
