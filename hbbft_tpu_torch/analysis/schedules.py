"""Schedule-space race explorer: the dynamic half of the analysis.

HoneyBadgerBFT's safety claim is *scheduler-independence* (Miller et
al., CCS 2016), and this package deliberately executes its own
host/device work asynchronously: the bounded dispatch pipeline resolves
chunks out of order, the deferred-verify seam lets round r+1 assemble
while round r's checks are in flight, and the traffic hooks observe
mempool state between epochs.  Those seams were guarded only by a
couple of seeded orders in tests.  This module makes order-independence
a *checked* property: it drives the MockBackend ``pipeline_chunk``
machinery and the VirtualNet crank loop through every non-equivalent
resolution/crank schedule at small N and asserts the run fingerprint —
Batch sha256, fault log, integer counters, ``device_dispatches`` — is
bit-identical across all of them.

Machinery:

* :class:`ScheduleController` — a replayable decision trace.  Every
  nondeterministic point (which pending chunk resolves next, which
  queued message cranks next) asks ``choose(n)``; a recorded trace
  replays the exact schedule in a fresh process, which is what
  ``python -m hbbft_tpu_torch.tools.race_explorer --replay`` does.
* :class:`RaceTracker` — vector-clock happens-before instrumentation.
  ``DispatchPipeline`` reports submit/resolve events, VirtualNet
  reports crank events with causal (enqueue) edges; footprints are
  object-granular (all chunks of one batch conflict, deliveries to one
  node conflict).  The tracker yields the dependence relation that
  powers both the DPOR reduction and the divergence report.
* :func:`explore` — stateless DFS over decision prefixes with two
  reductions: *canonical-trace dedup* (Foata normal form of the event
  sequence under the dependence relation — two schedules with the same
  normal form are Mazurkiewicz-equivalent and counted once) and a
  *DPOR-style swap prune* (an alternative whose event is independent of
  everything between the taken event and its own execution would yield
  an equivalent trace and is not enqueued).
* On divergence the failing choice trace is ddmin-minimized and written
  as a JSON counterexample that replays deterministically.

Targets live at the bottom (honest pipeline / traffic / virtualnet
runs) next to the seeded mutants from :mod:`analysis.mutations` — the
detector-sensitivity fixtures pinned by the explorer's tests.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.crypto.backend import MockBackend

# ---------------------------------------------------------------------------
# Decision traces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChoicePoint:
    """One recorded decision: its label, arity, and the stable keys of
    the candidates (index-aligned with the choice values)."""

    label: str
    arity: int
    candidates: Tuple[str, ...]
    taken: int


class ScheduleController:
    """A replayable schedule: preset choices consumed in order, 0 (the
    default order) beyond the preset's end.  Arity-1 decisions are not
    recorded — they carry no information and keeping them out makes the
    trace a dense encoding of the *actual* schedule freedom."""

    def __init__(self, choices: Sequence[int] = ()) -> None:
        self.preset = list(choices)
        self.trace: List[int] = []
        self.points: List[ChoicePoint] = []

    def choose(
        self,
        n: int,
        label: str = "",
        candidates: Optional[Sequence[str]] = None,
    ) -> int:
        if n <= 1:
            return 0
        i = len(self.trace)
        c = self.preset[i] % n if i < len(self.preset) else 0
        self.trace.append(c)
        cands = tuple(candidates) if candidates is not None else tuple(
            str(j) for j in range(n)
        )
        self.points.append(ChoicePoint(label, n, cands, c))
        return c

    def permutation(
        self, k: int, label: str = "", keys: Optional[Sequence[str]] = None
    ) -> List[int]:
        """Pick an order of ``k`` items via k-1 shrinking choices
        (selection order); all-zero choices give the identity order."""
        remaining = list(range(k))
        out: List[int] = []
        while remaining:
            cands = [keys[i] if keys else str(i) for i in remaining]
            c = self.choose(len(remaining), label, candidates=cands)
            out.append(remaining.pop(c))
        return out


# ---------------------------------------------------------------------------
# Happens-before instrumentation
# ---------------------------------------------------------------------------


@dataclass
class Event:
    """One scheduled action with its vector clock and footprint."""

    index: int
    key: str
    task: str
    kind: str  # "submit" | "resolve" | "crank"
    writes: FrozenSet[Tuple[str, Any]]
    reads: FrozenSet[Tuple[str, Any]]
    causes: Tuple[int, ...]  # indices of events that enabled this one
    clock: Dict[str, int] = field(default_factory=dict)


def _footprints_conflict(a: Event, b: Event) -> bool:
    return bool(
        (a.writes & (b.writes | b.reads)) or (b.writes & a.reads)
    )


def events_dependent(a: Event, b: Event) -> bool:
    """Dependence for trace equivalence: same task, a causal edge, or an
    object-granular footprint conflict."""
    if a.task == b.task:
        return True
    if a.index in b.causes or b.index in a.causes:
        return True
    return _footprints_conflict(a, b)


def clocks_concurrent(a: Event, b: Event) -> bool:
    """Neither vector clock dominates: the two events are causally
    unordered (a race candidate when their footprints also conflict)."""

    def leq(x: Dict[str, int], y: Dict[str, int]) -> bool:
        return all(y.get(k, 0) >= v for k, v in x.items())

    return not leq(a.clock, b.clock) and not leq(b.clock, a.clock)


class RaceTracker:
    """Event recorder shared by the pipeline probe and the net probe.

    Vector clocks advance per task and join along causal edges (submit→
    resolve, enqueue→crank); footprint conflicts are deliberately NOT
    join points — a conflicting pair with concurrent clocks is exactly
    the schedule-sensitive state the explorer exists to audit."""

    def __init__(self) -> None:
        self.events: List[Event] = []
        self._task_clocks: Dict[str, Dict[str, int]] = {}
        # pipeline bookkeeping
        self._pending: Dict[int, int] = {}  # id(PendingDispatch) -> event idx
        # net bookkeeping
        self._msg_seq: Dict[Tuple[Any, Any, str], int] = {}
        self._current_crank: Optional[int] = None

    # -- core ----------------------------------------------------------------

    def record(
        self,
        key: str,
        task: str,
        kind: str,
        writes: Sequence[Tuple[str, Any]] = (),
        reads: Sequence[Tuple[str, Any]] = (),
        causes: Sequence[int] = (),
    ) -> Event:
        clock = dict(self._task_clocks.get(task, {}))
        for ci in causes:
            for t, v in self.events[ci].clock.items():
                if clock.get(t, 0) < v:
                    clock[t] = v
        clock[task] = clock.get(task, 0) + 1
        ev = Event(
            index=len(self.events),
            key=key,
            task=task,
            kind=kind,
            writes=frozenset(writes),
            reads=frozenset(reads),
            causes=tuple(causes),
            clock=clock,
        )
        self.events.append(ev)
        self._task_clocks[task] = clock
        return ev

    # -- DispatchPipeline probe API ------------------------------------------

    def pipe_submit(self, p) -> None:
        kind = p.kind or f"anon{len(self.events)}"
        batch = kind.split(".", 1)[0]
        # per-device-queue footprint (sharded pipeline): a submit
        # APPENDS to its device's queue, a resolve POPS it — same-device
        # entries are thereby ordered (a device stream completes FIFO)
        # while cross-device entries stay concurrent, which is exactly
        # the schedule freedom the shard choose() axis explores
        dev = getattr(p, "device", None)
        ev = self.record(
            f"submit:{kind}", "main", "submit",
            writes=(("devq", dev),) if dev is not None else (),
            reads=(),
        )
        self._pending[id(p)] = ev.index
        # batch identity for the resolve's footprint
        ev.reads = frozenset({("batch", batch)})

    def pipe_resolve(self, p) -> None:
        kind = p.kind or "anon"
        batch = kind.split(".", 1)[0]
        cause = self._pending.pop(id(p), None)
        # object-granular: every chunk of one batch writes "the
        # batch's result object" — deliberately coarser than the
        # disjoint slot ranges, the way a static footprint would be
        writes = [("batch", batch)]
        dev = getattr(p, "device", None)
        if dev is not None:
            writes.append(("devq", dev))
        self.record(
            f"resolve:{kind}",
            f"chunk:{kind}",
            "resolve",
            writes=tuple(writes),
            causes=(cause,) if cause is not None else (),
        )

    # -- VirtualNet probe API ------------------------------------------------

    def tag_message(self, msg) -> str:
        """Assign a stable content-based key at enqueue time, recording
        the enqueuing crank event as the message's cause."""
        kind = type(msg.payload).__name__
        sig = (repr(msg.sender), repr(msg.to), kind)
        n = self._msg_seq.get(sig, 0)
        self._msg_seq[sig] = n + 1
        key = f"{msg.sender}->{msg.to}:{kind}#{n}"
        msg._race_key = key
        msg._race_cause = self._current_crank
        return key

    def begin_crank(self, msg) -> None:
        key = getattr(msg, "_race_key", None)
        if key is None:
            key = self.tag_message(msg)
        cause = getattr(msg, "_race_cause", None)
        ev = self.record(
            f"crank:{key}",
            f"node:{msg.to}",
            "crank",
            writes=(("node", repr(msg.to)),),
            causes=(cause,) if cause is not None else (),
        )
        self._current_crank = ev.index

    def end_crank(self) -> None:
        self._current_crank = None

    # -- analysis ------------------------------------------------------------

    def canonical_form(self) -> str:
        """Foata normal form of the executed trace under the dependence
        relation: each event's level is one past the highest level of a
        dependent predecessor, and the form is the multiset of keys per
        level.  Two schedules with equal forms are equivalent (one can
        be transformed into the other by swapping adjacent independent
        events)."""
        levels: List[int] = []
        level_of: List[int] = []
        recent: List[Event] = []
        for ev in self.events:
            lvl = 0
            for prior_idx, prior in enumerate(recent):
                if events_dependent(ev, prior):
                    lvl = max(lvl, level_of[prior_idx] + 1)
            recent.append(ev)
            level_of.append(lvl)
            levels.append(lvl)
        buckets: Dict[int, List[str]] = {}
        for ev, lvl in zip(self.events, levels):
            buckets.setdefault(lvl, []).append(ev.key)
        h = hashlib.sha256()
        for lvl in sorted(buckets):
            h.update(str(lvl).encode())
            for k in sorted(buckets[lvl]):
                h.update(k.encode())
            h.update(b"|")
        return h.hexdigest()

    def racing_pairs(self, limit: int = 8) -> List[Tuple[str, str]]:
        """Footprint-conflicting event pairs whose vector clocks are
        concurrent — the state whose final value the schedule decides."""
        out: List[Tuple[str, str]] = []
        evs = self.events
        for i in range(len(evs)):
            for j in range(i + 1, len(evs)):
                a, b = evs[i], evs[j]
                if a.task == b.task:
                    continue
                if _footprints_conflict(a, b) and clocks_concurrent(a, b):
                    out.append((a.key, b.key))
                    if len(out) >= limit:
                        return out
        return out


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def stable_repr(obj: Any) -> str:
    """Deterministic, insertion-order-free repr for hashing."""
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(
            f"{stable_repr(k)}:{stable_repr(v)}" for k, v in items
        ) + "}"
    if isinstance(obj, (list, tuple)):
        body = ",".join(stable_repr(x) for x in obj)
        return ("[" if isinstance(obj, list) else "(") + body + (
            "]" if isinstance(obj, list) else ")"
        )
    if isinstance(obj, (set, frozenset)):
        return "{" + ",".join(sorted(stable_repr(x) for x in obj)) + "}"
    if hasattr(obj, "contributions") and hasattr(obj, "epoch"):  # Batch
        return (
            f"Batch(epoch={obj.epoch},"
            f"contributions={stable_repr(obj.contributions)})"
        )
    return repr(obj)


def sha(obj: Any) -> str:
    return hashlib.sha256(stable_repr(obj).encode()).hexdigest()


def counters_fingerprint(*counter_objs) -> Dict[str, int]:
    """Integer counters only — wall-clock attribution (``*_seconds``)
    legitimately varies run to run and is excluded."""
    out: Dict[str, int] = {}
    for c in counter_objs:
        for k, v in c.snapshot().items():
            if isinstance(v, bool) or not isinstance(v, int):
                continue
            out[k] = out.get(k, 0) + v
    return out


@dataclass
class RunResult:
    """One executed schedule: fingerprint parts + analysis artifacts."""

    parts: Dict[str, Any]
    trace: List[int]
    points: List[ChoicePoint]
    canonical: str
    events: List[Event]

    @property
    def fingerprint(self) -> str:
        return hashlib.sha256(
            json.dumps(self.parts, sort_keys=True, default=repr).encode()
        ).hexdigest()


def first_divergence(ref: RunResult, div: RunResult) -> Dict[str, Any]:
    """The first position where the two executed event sequences differ
    — the minimized counterexample's replayable anchor."""
    rk = [e.key for e in ref.events]
    dk = [e.key for e in div.events]
    for i, (a, b) in enumerate(zip(rk, dk)):
        if a != b:
            return {"index": i, "reference": a, "divergent": b}
    if len(rk) != len(dk):
        i = min(len(rk), len(dk))
        return {
            "index": i,
            "reference": rk[i] if i < len(rk) else None,
            "divergent": dk[i] if i < len(dk) else None,
        }
    return {"index": None, "reference": None, "divergent": None}


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------


def _engine_parts(net, batches_list, error: Optional[BaseException],
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    parts: Dict[str, Any] = {
        "batches_sha": sha(batches_list),
        "faults": [],
        "counters": counters_fingerprint(net.counters, net.backend.counters),
        "device_dispatches": net.backend.counters.device_dispatches,
        "error": repr(error) if error is not None else "",
    }
    if extra:
        parts["extra"] = extra
    return parts


def run_pipeline_target(
    controller: ScheduleController,
    tracker: RaceTracker,
    n: int,
    seed: int,
    backend_factory: Optional[Callable[[], Any]] = None,
    epochs: int = 2,
    coin_rounds: int = 1,
) -> RunResult:
    """Honest lockstep epochs with the MockBackend simulated-async
    pipeline under explorer control: every flush's resolution order is a
    schedule decision.  Exercises the chunk pipeline AND the
    deferred-verify seam (the engine's ``verify_*_deferred`` resolvers
    ride the same flush)."""
    from hbbft_tpu_torch.crypto.backend import MockBackend
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet

    backend = (backend_factory or MockBackend)()
    # chunk so the dec/sig verify batches split ~4 ways at this N
    items = n * n * max(1, n - 1)
    backend.pipeline_chunk = max(1, items // 4)
    backend._pipe.probe = tracker
    backend.resolve_order = lambda k: controller.permutation(
        k, "resolve", keys=[p.kind for p in backend._pipe._q]
    )
    net = ArrayHoneyBadgerNet(
        range(n), backend=backend, seed=seed, coin_rounds=coin_rounds
    )
    error: Optional[BaseException] = None
    batches: List[Any] = []
    try:
        batches = net.run_epochs(epochs)
    except Exception as e:  # divergence shows up as a raised invariant
        error = e
    extra = backend.race_extra() if hasattr(backend, "race_extra") else None
    parts = _engine_parts(net, batches, error, extra)
    return RunResult(
        parts, list(controller.trace), list(controller.points),
        tracker.canonical_form(), tracker.events,
    )


def run_traffic_target(
    controller: ScheduleController,
    tracker: RaceTracker,
    n: int,
    seed: int,
    backend_factory: Optional[Callable[[], Any]] = None,
    chunk_listener_factory: Optional[Callable[[Any], Callable]] = None,
    epochs: int = 3,
) -> RunResult:
    """The traffic-hook seam: an ArrayTrafficDriver sources contributions
    and commits batches through the engine hooks while the pipeline
    resolves chunks in explorer-chosen orders.  ``chunk_listener_factory
    (driver) -> callback`` attaches a per-chunk-resolution listener (the
    seeded mid-epoch mempool mutation rides this)."""
    import random

    from hbbft_tpu_torch.crypto.backend import MockBackend
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet
    from hbbft_tpu_torch.traffic.driver import ArrayTrafficDriver
    from hbbft_tpu_torch.traffic.workload import ClosedLoopSource, ZipfPopulation

    backend = (backend_factory or MockBackend)()
    items = n * n * max(1, n - 1)
    backend.pipeline_chunk = max(1, items // 4)
    backend._pipe.probe = tracker
    backend.resolve_order = lambda k: controller.permutation(
        k, "resolve", keys=[p.kind for p in backend._pipe._q]
    )
    net = ArrayHoneyBadgerNet(range(n), backend=backend, seed=seed)
    src = ClosedLoopSource(4 * n, ZipfPopulation(16 * n, 1.1))
    driver = ArrayTrafficDriver(
        net, src, random.Random(seed + 1), batch_size=8,
        mempool_capacity=1 << 10,
    )
    if chunk_listener_factory is not None:
        backend.chunk_listeners = (chunk_listener_factory(driver),)
    error: Optional[BaseException] = None
    batches: List[Any] = []
    try:
        batches = net.run_epochs(epochs)
    except Exception as e:
        error = e
    extra: Dict[str, Any] = {"traffic": driver.tracker.fingerprint()}
    if hasattr(backend, "race_extra"):
        extra.update(backend.race_extra())
    parts = _engine_parts(net, batches, error, extra)
    return RunResult(
        parts, list(controller.trace), list(controller.points),
        tracker.canonical_form(), tracker.events,
    )


def run_virtualnet_target(
    controller: ScheduleController,
    tracker: RaceTracker,
    n: int,
    seed: int,
    wrap: Optional[Callable[[Any], Any]] = None,
) -> RunResult:
    """Message-delivery-order exploration: Broadcast over VirtualNet with
    the controlled scheduler choosing which queued message cranks next.
    This is where the DPOR swap-prune earns its keep — deliveries to
    different nodes without a causal edge commute."""
    from hbbft_tpu_torch.crypto.backend import MockBackend
    from hbbft_tpu_torch.net.virtual_net import NetBuilder

    from hbbft_tpu_torch.protocols.broadcast import Broadcast

    payload = b"race explorer payload " * 4

    def construct(ni, be):
        alg = Broadcast(ni, proposer_id=0)
        return wrap(alg) if wrap is not None else alg

    net = (
        NetBuilder(range(n))
        .backend(MockBackend())
        .using(construct)
        .scheduler("controlled")
        .crank_limit(200_000)
        .build(seed=seed)
    )
    net.race_probe = tracker

    def chooser(vnet) -> int:
        keys = [
            getattr(m, "_race_key", None) or tracker.tag_message(m)
            for m in vnet.queue
        ]
        return controller.choose(len(vnet.queue), "crank", candidates=keys)

    net.crank_chooser = chooser
    error: Optional[BaseException] = None
    try:
        net.send_input(0, payload)
        net.crank_to_quiescence()
    except Exception as e:
        error = e
    outputs = {
        repr(nid): list(net.nodes[nid].outputs) for nid in sorted(net.nodes)
    }
    faults = sorted(
        f"{repr(fault.node_id)}:{fault.kind}"
        for nid in net.nodes
        for fault in net.nodes[nid].faults_observed
    )
    parts = {
        "batches_sha": sha(outputs),
        "faults": faults,
        "counters": counters_fingerprint(net.counters, net.backend.counters),
        "device_dispatches": net.backend.counters.device_dispatches,
        "error": repr(error) if error is not None else "",
    }
    return RunResult(
        parts, list(controller.trace), list(controller.points),
        tracker.canonical_form(), tracker.events,
    )


class ShardedMockBackend(MockBackend):
    """MockBackend whose simulated-async chunks ride the PER-DEVICE
    sharded pipeline (parallel/shardpipe.py) — the mock stand-in
    for MeshBackend's whole-chunk-per-device dispatch.  Each chunk
    reserves a (recorded) device before submitting; ``finish()`` drains
    the device queues under the pipe's ``choose_shard`` hook, which the
    shard explorer target wires to the controller's choose() axis.  The
    default hook resolves the LAST ready device first — deterministic
    cross-device out-of-order, per-device FIFO — so plain test use
    exercises shard reordering without a controller."""

    #: virtual device count: >1 so cross-device order exists, small so
    #: the explorer's choice arity stays tractable at smoke budgets
    n_devices = 4

    def __init__(self) -> None:
        super().__init__()
        from hbbft_tpu_torch.parallel.shardpipe import ShardedDispatchPipeline

        self._pipe = ShardedDispatchPipeline(
            self.n_devices, counters=None, tracer_ref=None,
            depth_fn=lambda: 1 << 30,
        )
        self._pipe.choose_shard = lambda ready: len(ready) - 1

    def _piped_submit(self, items, compute):
        # base body + a device reservation per chunk (the shard seam)
        step = self.pipeline_chunk or len(items) or 1
        out = [None] * len(items)
        b = self._batch_seq
        self._batch_seq += 1
        for ci, lo in enumerate(range(0, len(items), step)):
            chunk = items[lo : lo + step]

            def deliver(res, lo=lo):
                out[lo : lo + len(res)] = res
                for cb in self.chunk_listeners:
                    cb(lo, res)

            self._pipe.reserve_device()
            self._pipe.submit(
                lambda chunk=chunk: compute(chunk), fetch=None,
                kind=f"b{b}.c{ci}", items=len(chunk),
                on_result=deliver,
            )

        def finish():
            self._pipe.flush()
            return out

        return out, finish


def run_shard_target(
    controller: ScheduleController,
    tracker: RaceTracker,
    n: int,
    seed: int,
    backend_factory: Optional[Callable[[], Any]] = None,
    epochs: int = 2,
    coin_rounds: int = 1,
) -> RunResult:
    """The cross-shard completion-order seam: honest lockstep
    epochs with chunks landing on per-device queues, the explorer
    choosing which device's head resolves next at every drain step.
    Placement (recorded) and per-device dispatch tallies ride the
    fingerprint — they are submit-path program state, so any schedule
    leaking into them is itself a divergence."""
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet

    backend = (backend_factory or ShardedMockBackend)()
    items = n * n * max(1, n - 1)
    backend.pipeline_chunk = max(1, items // 4)
    backend._pipe.probe = tracker
    backend._pipe.choose_shard = lambda ready: controller.choose(
        len(ready), "shard", candidates=[f"dev{d}" for d in ready]
    )
    net = ArrayHoneyBadgerNet(
        range(n), backend=backend, seed=seed, coin_rounds=coin_rounds
    )
    error: Optional[BaseException] = None
    batches: List[Any] = []
    try:
        batches = net.run_epochs(epochs)
    except Exception as e:  # divergence shows up as a raised invariant
        error = e
    extra: Dict[str, Any] = {
        "dev_dispatches": list(backend._pipe.dev_dispatches),
        "placements_sha": sha(backend._pipe.placements),
    }
    if hasattr(backend, "race_extra"):
        extra.update(backend.race_extra())
    parts = _engine_parts(net, batches, error, extra)
    return RunResult(
        parts, list(controller.trace), list(controller.points),
        tracker.canonical_form(), tracker.events,
    )


def _mutant_target(name: str):
    from hbbft_tpu_torch.analysis import mutations

    return mutations.target_runner(name)


#: name -> runner(controller, tracker, n, seed) -> RunResult
def target_runner(name: str):
    honest = {
        "pipeline": run_pipeline_target,
        "traffic": run_traffic_target,
        "virtualnet": run_virtualnet_target,
        "shard": run_shard_target,
    }
    if name in honest:
        return honest[name]
    if name.startswith("mutant:"):
        return _mutant_target(name.split(":", 1)[1])
    raise KeyError(f"unknown explorer target {name!r}")


TARGET_NAMES = ("pipeline", "traffic", "virtualnet", "shard")

#: (target, n, max_runs) triples of the smoke sweep — small but
#: covering all four seams; ~1 s on one CPU core
SMOKE_PLAN = (
    ("pipeline", 4, 40),
    ("traffic", 4, 25),
    ("virtualnet", 4, 40),
    ("shard", 4, 40),
)

#: the slow full sweep (the explorer tests' slow arm): ≥1000
#: non-equivalent schedules across the seams at N ∈ {4, 7} — the CLI's
#: --full and the acceptance-bar test share this single definition so
#: they cannot drift apart
FULL_PLAN = (
    ("pipeline", 4, 450),
    ("pipeline", 7, 200),
    ("traffic", 4, 200),
    ("traffic", 7, 100),
    ("virtualnet", 4, 250),
    ("virtualnet", 7, 150),
    ("shard", 4, 250),
    ("shard", 7, 100),
)


# ---------------------------------------------------------------------------
# Exploration
# ---------------------------------------------------------------------------


def run_schedule(target: str, n: int, seed: int, choices: Sequence[int]) -> RunResult:
    """Execute one schedule of ``target`` deterministically."""
    controller = ScheduleController(choices)
    tracker = RaceTracker()
    return target_runner(target)(controller, tracker, n, seed)


def _swap_prunable(run: RunResult, point_idx: int, alt: int) -> bool:
    """DPOR-style check: would taking ``alt`` at ``point_idx`` provably
    yield an equivalent trace?  True when the alternative's event is
    independent of every event between the taken event and its own
    execution in the observed run (the swap commutes all the way)."""
    pt = run.points[point_idx]
    taken_key = pt.candidates[pt.taken]
    alt_key = pt.candidates[alt]
    prefix = "crank:" if pt.label == "crank" else "resolve:"
    by_key = {e.key: e for e in run.events}
    taken_ev = by_key.get(prefix + taken_key)
    alt_ev = by_key.get(prefix + alt_key)
    if taken_ev is None or alt_ev is None:
        return False
    if alt_ev.index <= taken_ev.index:
        return False
    for ev in run.events[taken_ev.index : alt_ev.index]:
        if events_dependent(alt_ev, ev):
            return False
    return True


@dataclass
class Exploration:
    """Outcome of one :func:`explore` sweep."""

    target: str
    n: int
    seed: int
    runs: int = 0
    classes: int = 0
    pruned: int = 0
    revisits: int = 0
    reference: Optional[RunResult] = None
    divergence: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return self.divergence is None

    def summary(self) -> Dict[str, Any]:
        out = {
            "target": self.target,
            "n": self.n,
            "seed": self.seed,
            "runs": self.runs,
            "non_equivalent_schedules": self.classes,
            "dpor_pruned": self.pruned,
            "equivalent_revisits": self.revisits,
            "ok": self.ok,
        }
        if self.divergence is not None:
            out["divergence"] = self.divergence
        return out


def minimize_divergence(
    target: str, n: int, seed: int, choices: List[int], ref_parts: Dict
) -> List[int]:
    """ddmin-lite: zero out choices and strip the tail while the run
    still diverges from the reference fingerprint."""

    def diverges(c: List[int]) -> bool:
        return run_schedule(target, n, seed, c).parts != ref_parts

    best = list(choices)
    for i in range(len(best)):
        if best[i] == 0:
            continue
        trial = list(best)
        trial[i] = 0
        if diverges(trial):
            best = trial
    while best and best[-1] == 0:
        best.pop()
    return best


def explore(
    target: str,
    n: int,
    seed: int = 0,
    max_runs: int = 200,
    stop_on_divergence: bool = True,
) -> Exploration:
    """Stateless DFS over the schedule space with DPOR reduction.

    Runs the default schedule first (the reference fingerprint), then
    systematically flips one decision at a time, exploring each new
    prefix's subtree.  Every executed run's fingerprint is compared to
    the reference; the first mismatch is minimized into a replayable
    counterexample recorded on the returned :class:`Exploration`."""
    out = Exploration(target=target, n=n, seed=seed)
    ref = run_schedule(target, n, seed, [])
    out.reference = ref
    out.runs = 1
    seen_classes = {ref.canonical}

    # DFS stack of (prefix, run-to-derive-children-from or None)
    stack: List[Tuple[List[int], Optional[RunResult], int]] = [([], ref, 0)]
    while stack and out.runs < max_runs:
        prefix, run, floor = stack.pop()
        if run is None:
            run = run_schedule(target, n, seed, prefix)
            out.runs += 1
            if run.canonical in seen_classes:
                out.revisits += 1
            seen_classes.add(run.canonical)
            if run.parts != ref.parts:
                mini = minimize_divergence(
                    target, n, seed, list(run.trace), ref.parts
                )
                div_run = run_schedule(target, n, seed, mini)
                out.divergence = {
                    "choices": mini,
                    "reference_parts": ref.parts,
                    "divergent_parts": div_run.parts,
                    "first_divergence": first_divergence(ref, div_run),
                    "racing": RaceTracker.racing_pairs(
                        _tracker_of(div_run)
                    ) if div_run.events else [],
                }
                if stop_on_divergence:
                    break
        # derive children: flip each not-yet-branched decision (bounded:
        # the frontier stops growing once it could never be drained
        # within max_runs)
        for i in range(len(run.points) - 1, floor - 1, -1):
            if len(stack) + out.runs > max_runs * 4:
                break
            pt = run.points[i]
            for alt in range(1, pt.arity):
                if alt == pt.taken:
                    continue
                if _swap_prunable(run, i, alt):
                    out.pruned += 1
                    continue
                child = list(run.trace[:i]) + [alt]
                stack.append((child, None, i + 1))
                if len(stack) + out.runs > max_runs * 4:
                    break
    out.classes = len(seen_classes)
    return out


def _tracker_of(run: RunResult) -> RaceTracker:
    t = RaceTracker()
    t.events = run.events
    return t


# ---------------------------------------------------------------------------
# Counterexample files
# ---------------------------------------------------------------------------


def write_counterexample(path, exploration: Exploration) -> None:
    div = exploration.divergence
    if div is None:
        raise ValueError("exploration found no divergence")
    doc = {
        "version": 1,
        "target": exploration.target,
        "n": exploration.n,
        "seed": exploration.seed,
        "choices": div["choices"],
        "reference_parts": div["reference_parts"],
        "divergent_parts": div["divergent_parts"],
        "first_divergence": div["first_divergence"],
        "racing": div.get("racing", []),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=repr)
        f.write("\n")


def replay_counterexample(path) -> Dict[str, Any]:
    """Re-execute a counterexample file's reference and divergent
    schedules; report whether the recorded divergence reproduced
    exactly (same fingerprint pair, same first-divergent event)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    target, n, seed = doc["target"], doc["n"], doc["seed"]
    ref = run_schedule(target, n, seed, [])
    div = run_schedule(target, n, seed, doc["choices"])
    got_first = first_divergence(ref, div)
    reproduced = (
        json.loads(json.dumps(ref.parts, sort_keys=True, default=repr))
        == doc["reference_parts"]
        and json.loads(json.dumps(div.parts, sort_keys=True, default=repr))
        == doc["divergent_parts"]
        and got_first == doc["first_divergence"]
    )
    return {
        "reproduced": reproduced,
        "reference_parts": ref.parts,
        "divergent_parts": div.parts,
        "first_divergence": got_first,
        "recorded_first_divergence": doc["first_divergence"],
        "diverged": ref.parts != div.parts,
    }
