"""Per-device pipelined shard dispatch — the mesh scale-out seam (the port's
copy of the JAX package's ``parallel/shardpipe.py``; ``MeshBackend`` and the
explorer's ``ShardedMockBackend`` ride it).

The single-chip pipeline (ops/pipeline.py) keeps ONE device busy by
deferring fetches behind a bounded FIFO.  ``MeshBackend`` used to stretch
that to a mesh by sharding every dispatch's batch axis 8 ways — which
keeps all devices *synchronized*, not *busy*: each small lane-capped
chunk is split into 8 slivers (launch overhead and pad lanes eat the
win), and every chunk still runs as one collective step.

:class:`ShardedDispatchPipeline` instead gives every device its own
bounded in-flight queue and lands WHOLE chunks on distinct devices:
chunk k goes to device d_k while chunk k+1 stages on host and chunk k+2
executes elsewhere.  The dispatch layer stays single-threaded — the
parallelism is the devices' own async streams, exactly as in the single-queue pipeline —
and the single ``fetch_to_host`` sync point is preserved.

Contract (on top of the base pipeline's):

* **Deterministic placement.**  ``reserve_device()`` picks the target
  device BEFORE the launch (placement decides where the launch
  runs) under ``HBBFT_TPU_SHARD_PLACEMENT`` — ``round_robin`` (default)
  or ``least_loaded`` (fewest in-flight entries; ties to the lowest
  index).  Every decision is appended to :attr:`placements`, so a seeded
  replay re-derives the identical placement sequence bit-for-bit.
* **Completion order is a checked property.**  Per-device queues are
  FIFO (a device stream completes in order); CROSS-device order is the
  schedule freedom.  The default drain resolves in global submission
  order — byte-compatible with the single-queue pipeline — and the
  :attr:`choose_shard` hook hands that freedom to the race explorer
  (analysis/schedules.py), which audits that delivery callbacks really
  are slot-disjoint.  ``RaceTracker`` records a per-device-queue
  footprint on every submit/resolve, so same-device entries are ordered
  and cross-device entries surface as the racing pairs they are.
* **Kill switch.**  ``HBBFT_TPU_NO_SHARD_PIPE=1`` makes MeshBackend
  reserve nothing — every dispatch falls back to the single-queue SPMD
  path with bit-identical Batches and conserved ``device_dispatches``
  (asserted by the shard pipeline's tests).
* **Per-device attribution.**  Each sharded dispatch's span lands on the
  ``device/<n>`` tracer track of its device, its [t0, t1] interval bills
  ``dev_seconds[n]`` alongside the global ``counters.device_seconds``,
  and every full drain records a ``shard_imbalance`` histogram sample
  (max/mean of the window's per-device dispatch counts; 1.0 = balanced).
  a trace report can check that the per-device spans sum to
  ``device_seconds`` ±5%.

Import-light like the base module (no torch/numpy at module scope): the
explorer's MockBackend shard target and the tests run this exact class with
host-computed entries — no devices needed beyond the virtual mesh.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, List, Optional

from hbbft_tpu_torch.ops.pipeline import (
    DispatchPipeline,
    PendingDispatch,
    fetch_to_host,
    pipeline_depth,
)


def shardpipe_enabled() -> bool:
    """Kill switch for the per-device shard pipeline.  Re-read per
    placement so in-process A/Bs (``HBBFT_TPU_NO_SHARD_PIPE=1`` vs.
    default) take effect immediately."""
    return not os.environ.get("HBBFT_TPU_NO_SHARD_PIPE")


def placement_policy() -> str:
    """``HBBFT_TPU_SHARD_PLACEMENT``: ``round_robin`` (default) or
    ``least_loaded``.  Unknown values fall back to round_robin rather
    than erroring mid-epoch."""
    p = os.environ.get("HBBFT_TPU_SHARD_PLACEMENT", "round_robin")
    return p if p in ("round_robin", "least_loaded") else "round_robin"


class ShardPendingDispatch(PendingDispatch):
    """A pending dispatch that knows its device and global submit order.

    ``device`` is the reserved device index (None for unreserved entries
    riding the base single queue — sync dispatches and SPMD fallbacks);
    ``seq`` is the global submission sequence number the deterministic
    drain replays program order from."""

    __slots__ = ("device", "seq")


class ShardedDispatchPipeline(DispatchPipeline):
    """One bounded in-flight queue per device + the base single queue.

    ``n_devices`` fixes the queue fan-out.  ``reserve_device()`` must be
    called immediately before a ``submit()`` that should land whole on
    one device (the backend's ``_place`` hook does both in one breath);
    an un-reserved submit rides the base queue exactly as before.
    """

    def __init__(
        self,
        n_devices: int,
        counters=None,
        tracer_ref: Optional[Callable[[], Any]] = None,
        depth_fn: Callable[[], int] = pipeline_depth,
    ) -> None:
        super().__init__(counters, tracer_ref, depth_fn)
        self.n_devices = int(n_devices)
        self._dev_q: List[deque] = [deque() for _ in range(self.n_devices)]
        self._rr_next = 0  # round-robin cursor (submit-path only)
        self._reserved: Optional[int] = None
        self._seq = 0
        #: recorded placement decisions, in submission order — the seeded
        #: replay's bit-identity witness (tests compare A/B runs on it)
        self.placements: List[int] = []
        #: per-device tallies (NOT Counters fields — the slotted dataclass
        #: is fixed-width; these live and die with the pipeline object)
        self.dev_dispatches: List[int] = [0] * self.n_devices
        self.dev_seconds: List[float] = [0.0] * self.n_devices
        #: dispatch counts since the last imbalance sample (full drain)
        self._window_disp: List[int] = [0] * self.n_devices
        #: explorer hook: ``choose_shard(ready_device_ids) -> position``
        #: picks which nonempty device queue resolves its head next.
        #: None = global submission order (the deterministic default).
        self.choose_shard: Optional[Callable[[List[int]], int]] = None

    def __len__(self) -> int:
        return len(self._q) + sum(len(q) for q in self._dev_q)

    # -- placement -----------------------------------------------------------

    def reserve_device(self) -> int:
        """Pick (and record) the device for the NEXT submit.

        Round-robin walks a submit-path-only cursor; least-loaded reads
        the per-device queue depths.  Both are pure functions of the
        deterministic single-threaded program state at this call, so a
        seeded replay reproduces the identical placement sequence —
        :attr:`placements` is the recorded proof."""
        if placement_policy() == "least_loaded":
            # Queue depths mutate only at the deterministic program
            # points where resolves run (flush / depth trim / sync
            # drain), so the load seen here is a pure function of
            # program order; the decision is recorded in `placements`
            # and asserted replay-identical — and placement can only
            # change WHERE a chunk runs, never its slot-written value.
            d = min(range(self.n_devices), key=lambda i: (len(self._dev_q[i]), i))
        else:
            d = self._rr_next
            self._rr_next = (d + 1) % self.n_devices
        self._reserved = d
        self.placements.append(d)
        return d

    # -- submit/resolve ------------------------------------------------------

    def submit(
        self,
        launch: Callable[[], Any],
        fetch: Optional[Callable[[Any], Any]] = fetch_to_host,
        kind: str = "",
        items: int = 0,
        on_result: Optional[Callable[[Any], None]] = None,
        sync: bool = False,
    ) -> PendingDispatch:
        """Base-pipeline semantics, routed per device.

        A reserved submit enqueues on its device's bounded queue (depth
        ``depth_fn()`` per device).  ``sync=True`` / depth 0 first drains
        EVERY queue in deterministic order — the single sync point spans
        the whole mesh, exactly as the one-queue pipeline's did."""
        dev = self._reserved
        self._reserved = None
        depth = 0 if sync else self._depth_fn()
        t0 = time.perf_counter()
        raw = launch()
        t_issued = time.perf_counter()
        slot = None if depth <= 0 else self._alloc_slot()
        p = ShardPendingDispatch(
            self, raw, fetch, kind, items, slot, on_result, t0, t_issued
        )
        p.device = dev
        p.seq = self._seq
        self._seq += 1
        if dev is not None:
            self.dev_dispatches[dev] += 1
            # lint: allow[seam-race] imbalance-window tally: read only by
            # the full-drain sampler (a deterministic program point), and
            # only into a tracer histogram — never into delivered values
            self._window_disp[dev] += 1
        if self.probe is not None:
            self.probe.pipe_submit(p)
        if depth <= 0:
            # Full drain first: delivery order degenerates to program
            # order across ALL queues — byte-compatible with both the
            # pre-pipeline seam and the single-queue sync path.
            self._drain(use_hook=False)
            self._resolve(p)
            return p
        if dev is None:
            # lint: allow[seam-race] _q IS the pipeline API (see base
            # class): the bounded FIFO handoff itself, slot-disjoint
            self._q.append(p)
            while len(self._q) > depth:
                self._q.popleft().resolve()
            return p
        q = self._dev_q[dev]
        # lint: allow[seam-race] _dev_q IS the pipeline API: the base
        # class's bounded-FIFO-handoff allowance, one queue per device;
        # entries are opaque and every delivery writes only its own slots
        q.append(p)
        # Per-DEVICE launch-then-trim: each device holds up to `depth`
        # unfetched chunks, so total in-flight scales with the mesh —
        # that is the point (8 devices each depth-2 busy, not 1).
        while len(q) > depth:
            q.popleft().resolve()
        return p

    def flush(self, order: Optional[List[int]] = None) -> None:
        """Resolve everything pending.  ``order`` (a permutation of the
        base queue's pending list — the MockBackend legacy hook) applies
        to base-queue entries only; device queues then drain under
        :attr:`choose_shard` or global submission order."""
        if order is not None:
            super().flush(order=order)
        self._drain(use_hook=True)
        self._sample_imbalance()

    def _drain(self, use_hook: bool) -> None:
        """Drain all queues to empty.

        Device queues are FIFO internally (a device stream completes in
        order); the cross-device interleaving is the schedule freedom:
        ``choose_shard`` picks among the ready devices when attached,
        otherwise heads resolve in global submission order — which equals
        the single-queue FIFO order, keeping the kill-switch A/B's
        delivery order identical.  Base-queue entries (sync/SPMD) are
        merged by the same submission-order rule and are never handed to
        the hook — their order is already program-determined."""
        while True:
            heads = []
            if self._q:
                heads.append((self._q[0].seq, -1))
            for d in range(self.n_devices):
                if self._dev_q[d]:
                    heads.append((self._dev_q[d][0].seq, d))
            if not heads:
                return
            ready = [d for _, d in heads if d >= 0]
            if (
                use_hook
                and self.choose_shard is not None
                and not self._q
                and len(ready) > 1
            ):
                d = ready[self.choose_shard(list(ready))]
                self._dev_q[d].popleft().resolve()
                continue
            _, d = min(heads)
            (self._q if d < 0 else self._dev_q[d]).popleft().resolve()

    # -- base-class hooks ----------------------------------------------------

    def _track_for(self, p: PendingDispatch) -> str:
        """Sharded entries span their DEVICE's track (``device/<n>``) —
        the per-device observability axis.  Unreserved ASYNC entries
        (base-queue riders, e.g. SPMD fallbacks) get ``device/q<slot>``
        so slot numbers cannot masquerade as device indices; sync
        entries keep the classic ``device`` track."""
        d = getattr(p, "device", None)
        if d is not None:
            return f"device/{d}"
        if p.slot is None:
            return "device"
        return f"device/q{p.slot}"

    def _bill_device(self, p: PendingDispatch, dt: float) -> None:
        d = getattr(p, "device", None)
        if d is not None:
            self.dev_seconds[d] += dt

    # -- observability -------------------------------------------------------

    def _sample_imbalance(self) -> None:
        """One ``shard_imbalance`` histogram sample per full drain whose
        window dispatched anything: max/mean of the window's per-device
        dispatch counts (1.0 = perfectly balanced, n_devices = all work
        on one device)."""
        total = sum(self._window_disp)
        if not total:
            return
        tr = self._tracer_ref() if self._tracer_ref is not None else None
        if tr is not None:
            mean = total / self.n_devices
            tr.hist("shard_imbalance").record(max(self._window_disp) / mean)
        self._window_disp = [0] * self.n_devices

    def imbalance(self) -> float:
        """Cumulative max/mean per-device dispatch ratio (1.0 = balanced;
        0.0 before any sharded dispatch) — the heartbeat field."""
        total = sum(self.dev_dispatches)
        if not total:
            return 0.0
        return max(self.dev_dispatches) / (total / self.n_devices)
