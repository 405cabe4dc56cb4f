"""VirtualNet — deterministic single-process network simulator and runtime.

Rebuild of the reference's `tests/net/` harness (`VirtualNet`, `NetBuilder`,
`CrankError` §, SURVEY.md §2.1/§3.3), promoted from test utility to **the**
framework runtime: on the device, this driver is also the crypto-batch accumulator —
deferred :class:`~hbbft_tpu_torch.core.types.CryptoWork` items emitted by protocol
steps are resolved either immediately (``defer_mode="eager"``, reference
semantics) or accumulated across a whole crank round and resolved in one
batched device call (``defer_mode="round"`` — the SURVEY.md §7 round-barrier
design that makes the N=100 pairing load a single dispatch).

Everything is seeded and deterministic: one `random.Random` threaded through
scheduling, adversaries, and protocol RNG needs.

The port's copy of the JAX package's ``net/virtual_net.py``, with its
crash/restart axis (``net/crash.py``, :meth:`NetBuilder.crashes`), its
critical-path recorder, metrics-log and traffic-driver hooks and its
scenario label, and the schedule explorer's hooks (the ``controlled``
scheduler, ``crank_chooser`` and ``race_probe``, driven by
``analysis/schedules.py``).  Unlike the reference, :meth:`NetBuilder.build`
defaults to ``TorchBackend()`` on the card; the mock is asked for by name.
"""

from __future__ import annotations

import heapq
import random
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.types import CryptoWork, Step, TargetedMessage
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.net.adversary import Adversary, NullAdversary
from hbbft_tpu_torch.net.crash import CrashEvent, CrashManager, CrashSchedule
from hbbft_tpu_torch.obs.tracer import Tracer
from hbbft_tpu_torch.utils.metrics import Counters, EventLog

__all__ = [
    "CrashEvent",
    "CrashSchedule",
    "CrankError",
    "NetBuilder",
    "NetMessage",
    "NetSchedule",
    "Node",
    "Partition",
    "VirtualNet",
]


class CrankError(Exception):
    """Limit exceeded or invariant broken while cranking.

    ``report`` (when raised by :class:`VirtualNet`) carries the
    :func:`hbbft_tpu_torch.obs.health.why_stalled` diagnosis taken at the
    moment of the trip — the starved protocol instances, the active
    adversary/scenario, and the schedule state — so a tripped limit is
    never a bare number without a culprit."""

    def __init__(self, message: str, report: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.report = report


@dataclass
class NetMessage:
    """An in-flight message (reference `NetMessage` §).

    ``not_before`` is the earliest virtual-clock time (``VirtualNet.now``)
    the schedule layer allows this message to be delivered; 0 means
    immediately eligible (the default when no schedule is attached)."""

    sender: Any
    to: Any
    payload: Any
    not_before: int = 0


@dataclass(frozen=True)
class Partition:
    """One partition episode: while ``start <= now < end`` messages
    crossing between different ``groups`` are held (healed at ``end``)
    or dropped.  Nodes absent from every group share an implicit
    "mainland" side."""

    start: int
    end: int
    groups: Tuple[frozenset, ...]

    def side(self, node) -> int:
        for i, g in enumerate(self.groups):
            if node in g:
                return i
        return -1

    def crosses(self, sender, to) -> bool:
        return self.side(sender) != self.side(to)

    def isolated_sets(self) -> List[set]:
        return [set(g) for g in self.groups]


class NetSchedule:
    """Crank-time network conditions, composable with any adversary.

    Applied at SEND time (when a message enters the queue): each message
    gets a delivery delay in cranks — per-link base latency plus seeded
    jitter — may be dropped i.i.d., and, while a partition episode is
    active, traffic crossing the partition boundary is held until the
    heal time (``partition_mode="heal"``) or dropped
    (``partition_mode="drop"``).  All randomness comes from ``net.rng``
    (the run's single seeded stream), so a schedule never breaks replay
    determinism.

    ``link_latency(sender, to) -> int`` overrides the uniform base
    ``latency`` per directed link (a WAN shape: heterogeneous RTTs).
    """

    def __init__(
        self,
        name: str = "custom",
        latency: int = 0,
        jitter: int = 0,
        drop: float = 0.0,
        link_latency: Optional[Callable[[Any, Any], int]] = None,
        partitions: Sequence[Partition] = (),
        partition_mode: str = "heal",
    ) -> None:
        if partition_mode not in ("heal", "drop"):
            raise ValueError(f"bad partition_mode {partition_mode!r}")
        self.name = name
        self.latency = latency
        self.jitter = jitter
        self.drop = drop
        # lint: allow[hook-detachment] shape callables in snapshotted runs
        # are module-level functions (the encoder serializes them by name);
        # env-dropping link_latency would silently flatten WAN latencies on
        # restore, breaking replay determinism the other way
        self.link_latency = link_latency
        self.partitions = tuple(partitions)
        self.partition_mode = partition_mode

    def active_partition(self, now: int) -> Optional[Partition]:
        for p in self.partitions:
            if p.start <= now < p.end:
                return p
        return None

    def on_send(self, net: "VirtualNet", msg: NetMessage) -> Optional[int]:
        """Delay (in cranks) for ``msg`` entering the queue now, or None
        to drop it.  Must not raise on any message shape: a tampered or
        malformed payload still gets a plain link delay."""
        rng = net.rng
        if self.drop and rng.random() < self.drop:
            return None
        delay = (
            self.link_latency(msg.sender, msg.to)
            if self.link_latency is not None
            else self.latency
        )
        if self.jitter:
            delay += rng.randrange(self.jitter + 1)
        part = self.active_partition(net.now)
        if part is not None and part.crosses(msg.sender, msg.to):
            if self.partition_mode == "drop":
                return None
            delay = max(delay, part.end - net.now)
        return delay

    def describe(self, now: int) -> Dict[str, Any]:
        """State snapshot for the why-stalled report."""
        out: Dict[str, Any] = {"name": self.name}
        if self.latency or self.link_latency is not None:
            out["latency"] = "per-link" if self.link_latency else self.latency
        if self.jitter:
            out["jitter"] = self.jitter
        if self.drop:
            out["drop"] = self.drop
        part = self.active_partition(now)
        if part is not None:
            out["partition"] = {
                "isolates": [sorted(g, key=repr) for g in part.isolated_sets()],
                "heals_at": part.end,
                "mode": self.partition_mode,
            }
        return out


@dataclass
class Node:
    """One simulated node: its algorithm instance and captured outputs."""

    id: Any
    algorithm: Any
    faulty: bool = False
    outputs: List[Any] = field(default_factory=list)
    faults_observed: List[Any] = field(default_factory=list)


class VirtualNet:
    """N protocol instances + a message queue + a crank loop."""

    #: attached traffic driver (hbbft_tpu_torch/traffic/driver.py registers
    #: itself here so why_stalled can name a starved/saturated source).
    #: Environment, not state: whole-net snapshots drop it (the driver
    #: holds live callables) and restore falls back to None.
    traffic = None
    #: schedule-explorer hooks (analysis/schedules.py) — environment, not
    #: state.  With ``scheduler="controlled"``, ``crank_chooser(net)``
    #: picks the queue index to deliver next; ``race_probe`` (a
    #: RaceTracker) records crank events with causal enqueue edges.
    crank_chooser = None
    race_probe = None
    #: critical-path recorder (obs/critpath.CritPathRecorder) and
    #: per-epoch series (obs/timeseries.MetricsLog) — environment, not
    #: state: both hold open-ended evidence rings the harness owns, so
    #: whole-net snapshots drop them and restore falls back to None.
    critpath = None
    metrics_log = None
    #: structured per-crank event sink and span tracer (hbbft_tpu_torch/obs) —
    #: environment, not state: both are observer planes holding open-ended
    #: buffers (and the tracer holds live hook callables), so a whole-net
    #: snapshot taken with either attached must drop them rather than die
    #: in the encoder; restore falls back to None (headless net).
    event_log = None
    tracer = None
    _SNAPSHOT_ENV_ATTRS = (
        "traffic",
        "crank_chooser",
        "race_probe",
        "critpath",
        "metrics_log",
        "event_log",
        "tracer",
    )
    #: class fallback so pre-crash-axis whole-net snapshots restore
    #: (decode sets only serialized attrs); instances always assign it
    crash = None

    def __init__(
        self,
        nodes: Dict[Any, Node],
        backend: CryptoBackend,
        adversary: Adversary,
        rng: random.Random,
        message_limit: Optional[int] = None,
        crank_limit: Optional[int] = None,
        defer_mode: str = "eager",
        scheduler: str = "random",
        event_log: Optional["EventLog"] = None,
        tracer: Optional[Tracer] = None,
        schedule: Optional[NetSchedule] = None,
        scenario_name: Optional[str] = None,
        crash_schedule: Optional[CrashSchedule] = None,
    ) -> None:
        self.nodes = nodes
        self.backend = backend
        self.adversary = adversary
        self.rng = rng
        self.queue: List[NetMessage] = []
        self.message_limit = message_limit
        self.crank_limit = crank_limit
        self.defer_mode = defer_mode
        self.scheduler = scheduler
        #: optional network-condition layer (latency/jitter/drop/partition);
        #: None keeps the legacy instant-delivery behavior byte-identical
        self.schedule = schedule
        #: scenario label (net/scenarios.py) surfaced by why_stalled
        self.scenario_name = scenario_name
        #: optional crash/restart axis (net/crash.py); None keeps every
        #: code path byte-identical to the crash-free runtime
        if crash_schedule is not None and defer_mode != "eager":
            # the WAL replay model re-derives the crash-time state by
            # re-handling logged events with eager crypto resolution; the
            # round barrier resolves work BETWEEN cranks against shared
            # net state the WAL cannot capture, so a restart under
            # defer_mode="round" would always read as replay divergence
            raise ValueError(
                "crash schedules require defer_mode='eager' (the WAL "
                "replay cannot reproduce the round-barrier resolution)"
            )
        self.crash = (
            CrashManager(crash_schedule) if crash_schedule is not None else None
        )
        #: virtual clock in cranks; advances 1 per delivery and
        #: fast-forwards when every pending message is future-dated
        self.now = 0
        #: future-dated messages as a (not_before, seq, msg) min-heap;
        #: ``queue`` only ever holds deliverable-now messages, so the
        #: scheduler pick stays O(1) with or without a schedule
        self._future: List[Tuple[int, int, NetMessage]] = []
        self._future_seq = 0
        self.messages_delivered = 0
        self.dropped_messages = 0
        self.cranks = 0
        self._sorted_ids = sorted(nodes)
        self._node_order = {n: i for i, n in enumerate(self._sorted_ids)}
        self._pending_work: List[CryptoWork] = []
        #: net-side operative metrics; crypto-side live on backend.counters
        self.counters = Counters()
        #: opt-in structured per-crank trace (SURVEY.md §5 port note)
        self.event_log = event_log
        #: opt-in span tracer + histogram registry (hbbft_tpu_torch/obs).  When
        #: attached, every crank records its handle_message latency and
        #: the pre-pop queue depth; per-crank SPANS additionally require
        #: ``tracer.crank_spans`` (a span per delivered message is only
        #: worth it on small runs).  Same zero-cost-when-None discipline
        #: as the event log.
        self.tracer = tracer

    def metrics(self) -> Dict[str, int]:
        """Combined net + crypto counters (one dict, SURVEY.md §5).

        cranks/messages_delivered mirror the authoritative limit-check
        attributes (single source of truth; the Counters copies are synced
        here, not incremented separately)."""
        self.counters.cranks = self.cranks
        self.counters.messages_delivered = self.messages_delivered
        return self.counters.merged_with(self.backend.counters)

    # -- introspection -------------------------------------------------------

    def node_order_key(self, node_id) -> int:
        return self._node_order.get(node_id, len(self._node_order))

    def correct_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if not n.faulty]

    def faulty_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.faulty]

    def node(self, node_id) -> Node:
        return self.nodes[node_id]

    def down_node_ids(self) -> frozenset:
        """Nodes currently dead under the crash axis (empty without one)."""
        return self.crash.down_ids() if self.crash is not None else frozenset()

    # -- input ---------------------------------------------------------------

    def send_input(self, node_id, input: Any) -> Step:
        if self.crash is not None and self.crash.on_input(self, node_id, input):
            return Step()  # node is down: input parked until restart
        node = self.nodes[node_id]
        step = node.algorithm.handle_input(input, rng=self.rng)
        self._process_step(node, step)
        return step

    def broadcast_input(self, input: Any) -> None:
        for node_id in sorted(self.nodes):
            self.send_input(node_id, input)

    # -- cranking ------------------------------------------------------------

    def _crank_error(self, message: str) -> CrankError:
        """A CrankError carrying the why-stalled diagnosis: the starved
        instances plus the active adversary/scenario and schedule state,
        so a tripped limit names its culprit instead of a bare number."""
        from hbbft_tpu_torch.obs.health import render_why_stalled, why_stalled

        try:
            report = why_stalled(self)
            rendered = render_why_stalled(report)
        except Exception as e:  # diagnosis must never mask the trip
            report = {"error": repr(e)}
            rendered = f"why-stalled report unavailable: {e!r}"
        return CrankError(f"{message}\n{rendered}", report=report)

    def _release_due(self) -> None:
        """Move future-dated messages whose time has come into the live
        queue (time-then-insertion order: deterministic)."""
        fut = self._future
        while fut and fut[0][0] <= self.now:
            self.queue.append(heapq.heappop(fut)[2])

    def crank(self) -> Optional[Tuple[Any, Step]]:
        """Deliver one message.  Returns (recipient, step) or None if idle."""
        self._release_due()
        if self.crash is not None:
            self.crash.on_crank(self)
        self.adversary.pre_crank(self)
        if not self.queue:
            self._flush_work()
            self._release_due()
            if not self.queue and self._future:
                # everything pending is future-dated: fast-forward the
                # virtual clock to the earliest delivery time (latency
                # never burns cranks; real time IS the crank count)
                self.now = self._future[0][0]
                self._release_due()
            if not self.queue and self.crash is not None:
                # pending crash-axis events (a tick-gated crash/restart,
                # or an epoch-gated restart the drained net starved out)
                # are fast-forwarded like future-dated messages
                if self.crash.on_idle(self):
                    self._release_due()
            if not self.queue:
                return None
        self.cranks += 1
        self.now += 1
        if self.critpath is not None:
            self.critpath.tick(self.cranks, self.now)
        if self.crank_limit is not None and self.cranks > self.crank_limit:
            raise self._crank_error(f"crank limit {self.crank_limit} exceeded")

        scheduler = self.adversary.scheduler_override or self.scheduler
        if scheduler == "controlled" and self.crank_chooser is not None:
            idx = self.crank_chooser(self)
        elif scheduler == "random":
            idx = self.rng.randrange(len(self.queue))
        else:
            idx = 0
        msg = self.queue.pop(idx)
        node = self.nodes.get(msg.to)
        if node is None:
            # Addressed to a node this net doesn't model (e.g. departed
            # validator): count it so lost traffic is diagnosable.
            self.dropped_messages += 1
            return msg.to, Step()
        self.messages_delivered += 1
        if self.message_limit is not None and self.messages_delivered > self.message_limit:
            raise self._crank_error(
                f"message limit {self.message_limit} exceeded"
            )
        if self.crash is not None:
            self.crash.on_deliver(self, msg)
        probe = self.race_probe
        if probe is not None:
            probe.begin_crank(msg)
        tr = self.tracer
        if tr is None:
            step = node.algorithm.handle_message(msg.sender, msg.payload, rng=self.rng)
        else:
            tr.hist("net_queue_depth").record(len(self.queue) + 1)
            t0 = time.perf_counter()
            step = node.algorithm.handle_message(msg.sender, msg.payload, rng=self.rng)
            t1 = time.perf_counter()
            tr.hist("crank_latency_us").record((t1 - t0) * 1e6)
            if tr.crank_spans:
                tr.complete(
                    f"crank:{type(msg.payload).__name__}", t0, t1,
                    cat="crank", track="crank", to=repr(msg.to),
                )
        if self.event_log is not None:
            self.event_log.emit(
                event="crank",
                crank=self.cranks,
                sender=msg.sender,
                to=msg.to,
                msg_type=type(msg.payload).__name__,
                outputs=len(step.output),
                messages_out=len(step.messages),
                faults=len(step.fault_log),
                deferred=len(step.work),
            )
        self._process_step(node, step)
        if probe is not None:
            probe.end_crank()
        if self.crash is not None:
            self.crash.after_crank(self)
        return msg.to, step

    def crank_round(self) -> int:
        """Deliver every currently-queued message, then resolve all deferred
        crypto in one batched backend call (the device round barrier).  Returns
        number of messages delivered."""
        n = len(self.queue)
        delivered = 0
        for _ in range(n):
            if not self.queue:
                break
            if self.crank() is not None:
                delivered += 1
        self._flush_work()
        return delivered

    def crank_until(
        self,
        pred: Callable[["VirtualNet"], bool],
        max_cranks: int = 100_000,
    ) -> None:
        """Crank until ``pred(net)`` or quiescence; CrankError on starvation."""
        for _ in range(max_cranks):
            if pred(self):
                return
            if self.crank() is None:
                self._flush_work()
                if not self.queue and not self._future:
                    if pred(self):
                        return
                    raise self._crank_error(
                        "network quiesced before predicate held"
                    )
        raise self._crank_error(f"predicate not reached in {max_cranks} cranks")

    def crank_to_quiescence(self, max_cranks: int = 1_000_000) -> None:
        for _ in range(max_cranks):
            if self.crank() is None:
                self._flush_work()
                if not self.queue and not self._future:
                    return
        raise self._crank_error(f"not quiescent after {max_cranks} cranks")

    # -- step processing -----------------------------------------------------

    def _process_step(self, node: Node, step: Step) -> None:
        node.outputs.extend(step.output)
        node.faults_observed.extend(step.fault_log)
        if step.fault_log.entries:
            self.counters.faults_recorded += len(step.fault_log.entries)
            if self.event_log is not None:
                for f in step.fault_log.entries:
                    # lint: allow[replay-purity] observer plane: emit is
                    # guarded and records evidence only — events never
                    # feed protocol state, and a restored net replays
                    # headless (event_log falls back to None)
                    self.event_log.emit(
                        event="fault", observer=node.id, node=f.node_id, kind=f.kind
                    )
        for work in step.work:
            if work.owner is None:
                work.owner = node.id
            if self.defer_mode == "eager":
                self._resolve_work([work])
            else:
                self._pending_work.append(work)
        for tm in step.messages:
            self._route(node, tm)

    def _route(self, node: Node, tm: TargetedMessage) -> None:
        recipients = tm.target.recipients(self._sorted_ids, our_id=node.id)
        for to in recipients:
            msg = NetMessage(node.id, to, tm.message)
            if self.crash is not None and self.crash.on_send(self, node, msg):
                continue  # replayed emission already delivered pre-crash
            if node.faulty:
                for m in self.adversary.tamper(self, msg):
                    self._enqueue(m)
            else:
                self._enqueue(msg)

    def _enqueue(self, msg: NetMessage) -> None:
        """Queue one message through the schedule layer (latency/jitter/
        drop/partition); adversary and schedule compose — tampered
        traffic is scheduled exactly like honest traffic.  Future-dated
        messages park on the time-ordered heap and enter ``queue`` only
        once deliverable."""
        if self.crash is not None and self.crash.on_enqueue(self, msg):
            return  # recipient is down: parked until its restart
        if self.race_probe is not None:
            # stable content key + causal edge to the enqueuing crank
            # lint: allow[replay-purity] explorer probe: tags carry
            # observer-only metadata (never read by protocol code), and a
            # restored net replays unprobed (race_probe falls back to None)
            self.race_probe.tag_message(msg)
        if self.schedule is not None:
            delay = self.schedule.on_send(self, msg)
            if delay is None:
                self.counters.schedule_dropped += 1
                return
            if delay > 0:
                msg.not_before = self.now + delay
                self.counters.schedule_delayed += 1
                self._future_seq += 1
                heapq.heappush(
                    self._future, (msg.not_before, self._future_seq, msg)
                )
                return
        self.queue.append(msg)

    # -- deferred crypto -----------------------------------------------------

    def _flush_work(self) -> None:
        while self._pending_work:
            batch, self._pending_work = self._pending_work, []
            self._resolve_work(batch)

    def _resolve_work(self, batch: Sequence[CryptoWork]) -> None:
        """Group work items by kind, hit the backend once per kind, re-enter
        the protocol callbacks, and process any follow-up steps."""
        by_kind: Dict[str, List[CryptoWork]] = defaultdict(list)
        for w in batch:
            by_kind[w.kind].append(w)
        follow_ups: List[Tuple[CryptoWork, Any]] = []
        for kind, items in by_kind.items():
            if kind == "verify_sig_share":
                results = self.backend.verify_sig_shares([w.payload for w in items])
            elif kind == "verify_dec_share":
                results = self.backend.verify_dec_shares([w.payload for w in items])
            elif kind == "verify_signature":
                results = self.backend.verify_signatures([w.payload for w in items])
            elif kind == "verify_ciphertext":
                results = self.backend.verify_ciphertexts([w.payload for w in items])
            else:
                raise CrankError(f"unknown crypto work kind {kind!r}")
            follow_ups.extend(zip(items, results))
        for work, result in follow_ups:
            follow_step = work.on_result(result)
            if follow_step:
                owner = self.nodes.get(work.owner)
                if owner is None:
                    raise CrankError("crypto work item has no owner node")
                self._process_step(owner, follow_step)


class NetBuilder:
    """Fluent builder mirroring the reference `NetBuilder` §.

    Example::

        net = (NetBuilder(range(4))
               .num_faulty(1)
               .backend(MockBackend())
               .using(lambda netinfo, b: ThresholdSign(netinfo, b, doc=b"x"))
               .build(seed=7))
    """

    def __init__(self, node_ids: Sequence[Any]) -> None:
        self._ids = sorted(node_ids)
        self._num_faulty = 0
        self._adversary: Adversary = NullAdversary()
        self._backend: Optional[CryptoBackend] = None
        self._message_limit: Optional[int] = None
        self._crank_limit: Optional[int] = None
        self._defer_mode = "eager"
        self._scheduler = "random"
        self._schedule: Optional[NetSchedule] = None
        self._event_log: Optional[EventLog] = None
        self._tracer: Optional[Tracer] = None
        self._crash_schedule: Optional[CrashSchedule] = None
        self._scenario_name: Optional[str] = None
        self._constructor: Optional[Callable[[NetworkInfo, CryptoBackend], Any]] = None

    def num_faulty(self, f: int) -> "NetBuilder":
        if len(self._ids) <= 3 * f and f > 0:
            raise ValueError(f"N={len(self._ids)} cannot tolerate f={f} (need N>3f)")
        self._num_faulty = f
        return self

    def adversary(self, adv: Adversary) -> "NetBuilder":
        self._adversary = adv
        return self

    def backend(self, backend: CryptoBackend) -> "NetBuilder":
        self._backend = backend
        return self

    def message_limit(self, limit: int) -> "NetBuilder":
        self._message_limit = limit
        return self

    def crank_limit(self, limit: int) -> "NetBuilder":
        self._crank_limit = limit
        return self

    def defer_mode(self, mode: str) -> "NetBuilder":
        assert mode in ("eager", "round")
        self._defer_mode = mode
        return self

    def scheduler(self, mode: str) -> "NetBuilder":
        assert mode in ("random", "first", "controlled")
        self._scheduler = mode
        return self

    def schedule(self, sched: Optional[NetSchedule]) -> "NetBuilder":
        """Attach a network-condition schedule (latency/jitter/drop/
        partition-and-heal); None keeps instant delivery."""
        self._schedule = sched
        return self

    def crashes(self, sched: Optional[CrashSchedule]) -> "NetBuilder":
        """Attach a crash/restart schedule (net/crash.py); None keeps the
        crash-free runtime byte-identical."""
        self._crash_schedule = sched
        return self

    def scenario(self, name: str) -> "NetBuilder":
        """Label the run for fault diagnosis: why_stalled and CrankError
        reports name this scenario."""
        self._scenario_name = name
        return self

    def trace(self, sink: Union[EventLog, Tracer]) -> "NetBuilder":
        """Attach an opt-in observability sink: an :class:`EventLog`
        (structured per-crank events) or an :class:`~hbbft_tpu_torch.obs.tracer
        .Tracer` (spans + histograms; also attached to the backend so
        dispatch spans land on the same timeline).  Call twice to attach
        both."""
        if isinstance(sink, Tracer):
            self._tracer = sink
        else:
            self._event_log = sink
        return self

    def using(
        self, constructor: Callable[[NetworkInfo, CryptoBackend], Any]
    ) -> "NetBuilder":
        """``constructor(netinfo, backend[, rng]) -> protocol instance`` per
        node.  Constructors that accept a third argument receive the net's
        seeded rng (needed by protocols that generate key material, e.g.
        DynamicHoneyBadger's in-band DKG)."""
        # lint: allow[hook-detachment] the builder is pre-run configuration:
        # no live net references it, so it can never appear in a snapshot
        self._constructor = constructor
        return self

    def build(self, seed: int = 0) -> VirtualNet:
        if self._constructor is None:
            raise ValueError("NetBuilder.using(...) not set")
        rng = random.Random(seed)
        backend = self._backend
        if backend is None:
            # the card, as every entry point of the port; the protocol
            # tests pass MockBackend() and the CPU runs TorchBackend("cpu")
            from hbbft_tpu_torch.ops.backend import TorchBackend

            backend = TorchBackend()
        if self._tracer is not None:
            backend.tracer = self._tracer
        netinfos = NetworkInfo.generate_map(self._ids, rng, backend)
        faulty_ids = set(rng.sample(self._ids, self._num_faulty))

        import inspect

        try:
            n_params = len(inspect.signature(self._constructor).parameters)
        except (TypeError, ValueError):
            n_params = 2

        def construct(nid):
            if n_params >= 3:
                return self._constructor(netinfos[nid], backend, rng)
            return self._constructor(netinfos[nid], backend)

        nodes = {
            nid: Node(
                id=nid,
                algorithm=construct(nid),
                faulty=nid in faulty_ids,
            )
            for nid in self._ids
        }
        return VirtualNet(
            nodes=nodes,
            backend=backend,
            adversary=self._adversary,
            rng=rng,
            message_limit=self._message_limit,
            crank_limit=self._crank_limit,
            defer_mode=self._defer_mode,
            scheduler=self._scheduler,
            event_log=self._event_log,
            tracer=self._tracer,
            schedule=self._schedule,
            scenario_name=self._scenario_name,
            crash_schedule=self._crash_schedule,
        )
