"""Scenario harness: the attack × network-schedule matrix over VirtualNet
— the port's copy of the attack × schedule half of the JAX package's
``net/scenarios.py``.

Honest-path bit-identity is not enough: the CCS 2016 headline claim — liveness under a
fully asynchronous adversary controlling f nodes *and* the network — needs
the cross product of misbehaviour (net/adversary.py attack library) and
network conditions (net/virtual_net.NetSchedule).  This module is the
registry + runner for that matrix:

* :data:`ATTACKS` — named attack factories with the fault kinds each one
  provably plants (drawn from ``core.fault_log.FAULT_KINDS``; an
  unregistered expectation fails at import).
* :data:`SCHEDULES` — named network-condition factories (uniform / LAN /
  WAN / partition-and-heal, plus a model-violating lossy shape kept out
  of the liveness matrix by its ``lossy`` flag).
* :func:`run_scenario` — one cell: N nodes, f=⌊(N−1)/3⌋ faulty, a full
  HoneyBadger epoch loop; returns a :class:`ScenarioResult` with the
  per-cell verdicts the matrix asserts: every honest node committed
  identical Batches, every injected misbehaviour landed in the fault log
  with the expected kind against a faulty node, no fault was ever
  attributed to an honest node, and a stalled cell carries the
  why-stalled report naming the attack.

Determinism: a cell is a pure function of (attack, schedule, n, seed) —
all entropy flows through the net's single seeded rng, so replaying a
seed reproduces the fault log and the batch digest bit-for-bit.

A cell runs on ``TorchBackend()``, the card, unless the caller passes a
backend (``MockBackend()`` for the protocol logic alone, or
``TorchBackend(device="cpu")``); it raises without a GPU rather than fall
back to the CPU.  So does a composed soak cell (:func:`run_cell`: the
attack and schedule axes with churn, crash and traffic axes in one
multi-epoch run).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.core.fault_log import all_fault_kinds
from hbbft_tpu_torch.net.adversary import (
    Adversary,
    CraftedShareAdversary,
    EquivocatingAdversary,
    LaggardAdversary,
    NullAdversary,
    ReplayAdversary,
    WithholdingAdversary,
)
from hbbft_tpu_torch.net.virtual_net import (
    CrankError,
    NetBuilder,
    NetSchedule,
    Partition,
    VirtualNet,
)
from hbbft_tpu_torch.obs import critpath as _critpath
from hbbft_tpu_torch.obs.flight import FlightRecorder
from hbbft_tpu_torch.obs.timeseries import MetricsLog, snap_net


@dataclass(frozen=True)
class Attack:
    """One named attack: a per-run adversary factory plus the fault kinds
    the attack provably plants (must be registered in FAULT_KINDS)."""

    name: str
    make: Callable[[int], Adversary]  # n -> fresh adversary
    expected_faults: Tuple[str, ...] = ()
    description: str = ""


@dataclass(frozen=True)
class ScheduleSpec:
    """One named network condition; ``make(n)`` returns a fresh
    NetSchedule (or None for instant delivery).  ``lossy`` marks
    schedules that violate the eventual-delivery model — they exercise
    the drop machinery and the stall reporter, not the liveness matrix."""

    name: str
    make: Callable[[int], Optional[NetSchedule]]
    lossy: bool = False
    description: str = ""


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

_ATTACK_LIST: Tuple[Attack, ...] = (
    Attack(
        "passive",
        lambda n: NullAdversary(),
        description="control row: no tampering",
    ),
    Attack(
        "equivocate",
        lambda n: EquivocatingAdversary(),
        expected_faults=("broadcast:conflicting_values",),
        description="conflicting RBC Values per recipient",
    ),
    Attack(
        "withhold_echo",
        lambda n: WithholdingAdversary(kinds=("echo",)),
        description="faulty nodes send no Echo (quorum at exactly N-f)",
    ),
    Attack(
        "withhold_ready",
        lambda n: WithholdingAdversary(kinds=("ready",)),
        description="faulty nodes send no Ready",
    ),
    Attack(
        "withhold_shares",
        lambda n: WithholdingAdversary(kinds=("sig_share", "dec_share")),
        description="faulty nodes withhold threshold shares",
    ),
    Attack(
        "crafted_shares",
        lambda n: CraftedShareAdversary(rate=0.5),
        expected_faults=("threshold_decrypt:invalid_share",),
        description="well-typed invalid threshold shares at 50% rate",
    ),
    Attack(
        "replay_flood",
        lambda n: ReplayAdversary(copies=3),
        expected_faults=(
            "broadcast:multiple_echos",
            "broadcast:multiple_readys",
        ),
        description="3x duplicate flood of all faulty traffic",
    ),
    Attack(
        "laggard",
        lambda n: LaggardAdversary(lag_cranks=60 * n * n),
        description="one honest node lags, then catches up",
    ),
)

ATTACKS: Dict[str, Attack] = {a.name: a for a in _ATTACK_LIST}


def _wan_latency(sender: Any, to: Any) -> int:
    """Deterministic heterogeneous per-link base latency (1..8 cranks):
    a fixed function of the directed link, not of arrival order."""
    s = sender if isinstance(sender, int) else len(repr(sender))
    t = to if isinstance(to, int) else len(repr(to))
    return 1 + (3 * s + 5 * t) % 8


_SCHEDULE_LIST: Tuple[ScheduleSpec, ...] = (
    ScheduleSpec(
        "uniform",
        lambda n: None,
        description="instant delivery (legacy behavior)",
    ),
    ScheduleSpec(
        "lan",
        lambda n: NetSchedule(name="lan", latency=1, jitter=2),
        description="small uniform latency + jitter",
    ),
    ScheduleSpec(
        "wan",
        lambda n: NetSchedule(name="wan", link_latency=_wan_latency, jitter=3),
        description="heterogeneous per-link latency + jitter",
    ),
    ScheduleSpec(
        "partition_heal",
        lambda n: NetSchedule(
            name="partition_heal",
            partitions=(
                Partition(
                    start=20,
                    end=20 + 30 * n * n,
                    groups=(frozenset(range(n // 2)),),
                ),
            ),
        ),
        description="halves isolated early, healed after 30·N² cranks",
    ),
    ScheduleSpec(
        "lossy",
        lambda n: NetSchedule(name="lossy", drop=0.05, latency=1, jitter=1),
        lossy=True,
        description="5% i.i.d. message loss (violates eventual delivery; "
        "exercises drop accounting and the stall reporter)",
    ),
)

SCHEDULES: Dict[str, ScheduleSpec] = {s.name: s for s in _SCHEDULE_LIST}

#: the liveness matrix: every attack × every eventual-delivery schedule
MATRIX_ATTACKS: Tuple[str, ...] = tuple(
    a.name for a in _ATTACK_LIST if a.name != "passive"
)
MATRIX_SCHEDULES: Tuple[str, ...] = tuple(
    s.name for s in _SCHEDULE_LIST if not s.lossy
)
#: the full verdict matrix: lossy schedules ride too, gated on the
#: bounded-degradation contract (see run_scenario) instead of liveness
MATRIX_SCHEDULES_ALL: Tuple[str, ...] = tuple(s.name for s in _SCHEDULE_LIST)


def _check_registry() -> None:
    known = all_fault_kinds()
    for a in _ATTACK_LIST:
        unknown = [k for k in a.expected_faults if k not in known]
        if unknown:
            raise ValueError(
                f"attack {a.name!r} expects unregistered fault kinds {unknown}"
            )


_check_registry()


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@dataclass
class ScenarioResult:
    """Verdicts + evidence for one matrix cell."""

    attack: str
    schedule: str
    n: int
    f: int
    seed: int
    ok: bool = False
    #: all honest nodes committed identical batch sequences
    batches_identical: bool = False
    #: identical on the COMMON committed prefix (a stalled cell's honest
    #: nodes may have unequal lengths; safety is about what committed)
    prefix_identical: bool = False
    epochs_committed: int = 0
    #: expected fault kinds that never landed against a faulty node
    missing_expected: List[str] = field(default_factory=list)
    #: (observer, accused, kind) for faults attributed to HONEST nodes —
    #: must be empty: correct nodes never accuse each other
    misattributed: List[Tuple[str, str, str]] = field(default_factory=list)
    #: observed fault kind -> count (honest observers only)
    fault_kinds: Dict[str, int] = field(default_factory=dict)
    #: sorted (observer, accused, kind) triples — the replay-determinism
    #: fingerprint next to batch_digest
    fault_log: List[Tuple[str, str, str]] = field(default_factory=list)
    #: sha256 over the canonical repr of every honest node's batches
    batch_digest: str = ""
    cranks: int = 0
    messages_delivered: int = 0
    schedule_dropped: int = 0
    schedule_delayed: int = 0
    error: Optional[str] = None
    #: why-stalled report when the cell starved (CrankError.report)
    why: Optional[Dict[str, Any]] = None
    #: the cell was judged under the bounded-degradation contract (lossy
    #: schedules violate eventual delivery, so liveness isn't gated; the
    #: cell passes iff whatever committed is identical, nothing was
    #: misattributed, and a stall names its cause)
    bounded: bool = False
    #: flight-recorder forensics bundle (obs/flight.py), present when the
    #: cell failed and obs was on
    forensics: Optional[Dict[str, Any]] = None

    def row(self) -> Dict[str, Any]:
        """Flat JSON-friendly form of the verdicts (a matrix report row)."""
        return {
            "attack": self.attack,
            "schedule": self.schedule,
            "n": self.n,
            "f": self.f,
            "seed": self.seed,
            "ok": self.ok,
            "bounded": self.bounded,
            "epochs": self.epochs_committed,
            "fault_kinds": dict(sorted(self.fault_kinds.items())),
            "missing_expected": self.missing_expected,
            "misattributed": self.misattributed,
            "batch_digest": self.batch_digest,
            "cranks": self.cranks,
            "messages_delivered": self.messages_delivered,
            "schedule_dropped": self.schedule_dropped,
            "schedule_delayed": self.schedule_delayed,
            "error": self.error,
        }


def build_scenario_net(
    attack: Attack,
    schedule: ScheduleSpec,
    n: int,
    f: Optional[int] = None,
    seed: int = 0,
    backend=None,
    scheduler: str = "random",
    crank_limit: int = 5_000_000,
) -> VirtualNet:
    """One cell's VirtualNet: HoneyBadger at N nodes / f faulty under the
    attack's adversary and the schedule's network conditions."""
    from hbbft_tpu_torch.protocols.honey_badger import HoneyBadger

    if f is None:
        f = (n - 1) // 3
    builder = (
        NetBuilder(range(n))
        .num_faulty(f)
        .adversary(attack.make(n))
        .schedule(schedule.make(n))
        .scenario(f"{attack.name}x{schedule.name}@n{n}")
        .scheduler(scheduler)
        .crank_limit(crank_limit)
        .using(
            lambda ni, be: HoneyBadger(ni, be, session_id=b"scenario-matrix")
        )
    )
    if backend is not None:
        builder = builder.backend(backend)
    return builder.build(seed=seed)


def _collect(result: ScenarioResult, net: VirtualNet, epochs: int) -> None:
    """Fill the result's evidence fields from a (possibly partial) run."""
    correct = net.correct_nodes()
    faulty_ids = {node.id for node in net.faulty_nodes()}
    triples = sorted(
        (repr(node.id), repr(fa.node_id), fa.kind)
        for node in correct
        for fa in node.faults_observed
    )
    result.fault_log = triples
    kinds: Dict[str, int] = {}
    for _, _, kind in triples:
        kinds[kind] = kinds.get(kind, 0) + 1
    result.fault_kinds = kinds
    result.misattributed = [
        t
        for node in correct
        for fa in node.faults_observed
        if fa.node_id not in faulty_ids
        for t in ((repr(node.id), repr(fa.node_id), fa.kind),)
    ]
    common = min((len(node.outputs) for node in correct), default=0)
    result.epochs_committed = common
    seqs = [node.outputs[:epochs] for node in correct]
    result.batches_identical = bool(seqs) and all(s == seqs[0] for s in seqs)
    prefix = [node.outputs[:common] for node in correct]
    result.prefix_identical = bool(prefix) and all(
        s == prefix[0] for s in prefix
    )
    h = hashlib.sha256()
    for b in seqs[0] if seqs else ():
        h.update(repr((b.epoch, sorted(b.contributions.items(), key=repr))).encode())
    result.batch_digest = h.hexdigest()
    result.cranks = net.cranks
    result.messages_delivered = net.messages_delivered
    result.schedule_dropped = net.counters.schedule_dropped
    result.schedule_delayed = net.counters.schedule_delayed


def run_scenario(
    attack_name: str,
    schedule_name: str,
    n: int,
    f: Optional[int] = None,
    seed: int = 0,
    epochs: int = 1,
    backend=None,
    scheduler: str = "random",
    crank_limit: int = 5_000_000,
    obs: bool = True,
) -> ScenarioResult:
    """Run one matrix cell; never raises — a starved cell comes back with
    ``ok=False`` and the why-stalled report naming the attack.  With
    ``obs=True`` a flight recorder rides along and a failed cell carries
    its forensics bundle on ``result.forensics``."""
    attack = ATTACKS[attack_name]
    schedule = SCHEDULES[schedule_name]
    if f is None:
        f = (n - 1) // 3
    result = ScenarioResult(
        attack=attack_name, schedule=schedule_name, n=n, f=f, seed=seed
    )
    net = build_scenario_net(
        attack, schedule, n, f=f, seed=seed, backend=backend,
        scheduler=scheduler, crank_limit=crank_limit,
    )
    rec = _critpath.CritPathRecorder() if obs else None
    flight = None
    if rec is not None:
        _critpath.activate(rec)
        net.critpath = rec
        flight = FlightRecorder(
            context={
                "cell": {
                    "attack": attack_name, "schedule": schedule_name,
                    "n": n, "f": f, "seed": seed, "epochs": epochs,
                }
            }
        )

    def _frame(e: int) -> None:
        if rec is None:
            return
        events = rec.take()
        paths = _critpath.paths_from_events(events)
        if paths:
            rec.last_path = paths[-1]
        flight.record(e, events=events)

    def _dump(reason: str) -> None:
        if rec is None:
            return
        if rec.events:
            _frame(epochs)  # trailing mid-epoch window
        summary = (result.why or {}).get("summary") or []
        result.forensics = flight.bundle(
            reason,
            why=result.why,
            faults=result.fault_log,
            gate_hint=summary[0] if summary else None,
        )

    try:
        try:
            for e in range(epochs):
                for i in sorted(net.nodes):
                    net.send_input(i, {"from": i, "epoch": e})
                net.crank_until(
                    lambda nt, e=e: all(
                        len(node.outputs) >= e + 1
                        for node in nt.correct_nodes()
                    ),
                    max_cranks=crank_limit,
                )
                _frame(e)
        except CrankError as err:
            result.error = str(err).splitlines()[0]
            result.why = err.report
            _collect(result, net, epochs)
            if schedule.lossy:
                result.ok = _bounded_degradation_ok(result)
                result.bounded = result.ok
            _dump("crank_error")
            return result
        _collect(result, net, epochs)
        missing = []
        faulty_ids = {repr(node.id) for node in net.faulty_nodes()}
        for kind in attack.expected_faults:
            landed = any(
                k == kind and accused in faulty_ids
                for _, accused, k in result.fault_log
            )
            if not landed:
                missing.append(kind)
        result.missing_expected = missing
        result.ok = (
            result.batches_identical
            and result.epochs_committed >= epochs
            and not missing
            and not result.misattributed
        )
        if schedule.lossy and not result.ok:
            result.ok = _bounded_degradation_ok(result)
            result.bounded = result.ok
        if not result.ok:
            _dump("verdict_failure")
        return result
    finally:
        if rec is not None:
            _critpath.deactivate()


def _bounded_degradation_ok(result: ScenarioResult) -> bool:
    """The lossy-schedule verdict (a dropped message may legitimately
    starve a quorum or swallow an attack's evidence): whatever prefix
    committed is identical on every honest node, no fault was ever
    attributed to an honest node, and — when the cell stalled — the
    why-stalled report names a cause instead of a bare limit."""
    if result.misattributed or not result.prefix_identical:
        return False
    if result.error is None:
        return True  # completed; only the expected-fault evidence is waived
    return bool((result.why or {}).get("summary"))


def run_matrix(
    ns: Sequence[int] = (4, 7, 16),
    attacks: Sequence[str] = MATRIX_ATTACKS,
    schedules: Sequence[str] = MATRIX_SCHEDULES,
    seed: int = 0,
    epochs: int = 1,
    backend_factory: Optional[Callable[[], Any]] = None,
    scheduler: str = "random",
) -> List[ScenarioResult]:
    """Sweep the attack × schedule × N matrix (one fresh backend per cell
    when ``backend_factory`` is given; else each cell builds the
    default, ``TorchBackend()``)."""
    out: List[ScenarioResult] = []
    for n in ns:
        for attack_name in attacks:
            for schedule_name in schedules:
                backend = backend_factory() if backend_factory else None
                out.append(
                    run_scenario(
                        attack_name, schedule_name, n,
                        seed=seed, epochs=epochs, backend=backend,
                        scheduler=scheduler,
                    )
                )
    return out


# ---------------------------------------------------------------------------
# The composed gauntlet: a cell is the full
# product attack × net-schedule × churn-schedule × crash-schedule ×
# traffic-source, run as a multi-epoch soak over the object runtime —
# SenderQueue-wrapped QueueingHoneyBadger on VirtualNet — so every axis
# composes with the real wire protocol: era changes ride committed votes,
# crashed nodes restore from utils/snapshot checkpoints and catch up
# through the sender-queue window, and client load flows through the
# traffic subsystem's mempools and lifecycle tracker.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChurnSpec:
    """Era-change schedule: ``make(n, epochs)`` returns the epochs at
    which every correct node votes the encryption-schedule flip (a
    schedule change wins by strict majority and turns the era over
    without a DKG — the cheapest real era change; the DKG-bearing
    remove/add path is the dynamic protocols' own)."""

    name: str
    make: Callable[[int, int], Tuple[int, ...]]
    description: str = ""


@dataclass(frozen=True)
class CrashSpec:
    """Crash axis: ``make(n, epochs)`` returns a fresh CrashSchedule (or
    None for the crash-free runtime)."""

    name: str
    make: Callable[[int, int], Optional["CrashSchedule"]]
    description: str = ""


@dataclass(frozen=True)
class TrafficSpec:
    """Traffic axis: open-loop Poisson client load at ``rate_frac`` of
    the nominal per-epoch capacity (validators × batch_size); None runs
    the soak load-free (QHB commits empty batches).  ``adaptive`` puts
    the SLO-driven batch controller (hbbft_tpu_torch/control/) in the loop —
    B updates ride ("batch_size", B) inputs so they are WAL-logged and
    crash-restart replay stays bit-identical; ``trace`` names a
    registered load trace (control/trace.py) modulating the rate."""

    name: str
    rate_frac: Optional[float] = None
    description: str = ""
    adaptive: bool = False
    trace: Optional[str] = None


_CHURN_LIST: Tuple[ChurnSpec, ...] = (
    ChurnSpec("none", lambda n, epochs: (), description="single era"),
    ChurnSpec(
        "era_flip",
        lambda n, epochs: tuple(
            e for e in (epochs // 3, (2 * epochs) // 3) if 0 < e < epochs
        ),
        description="two era changes (encryption-schedule flip votes)",
    ),
)

CHURNS: Dict[str, ChurnSpec] = {c.name: c for c in _CHURN_LIST}


def _one_restart(n: int, epochs: int) -> "CrashSchedule":
    from hbbft_tpu_torch.net.crash import CrashEvent, CrashSchedule

    return CrashSchedule(
        (
            CrashEvent(
                at_epoch=max(1, epochs // 3),
                down_epochs=max(2, min(4, epochs // 6)),
            ),
        ),
        recommit_epochs=3,
    )


def _two_restarts(n: int, epochs: int) -> "CrashSchedule":
    from hbbft_tpu_torch.net.crash import CrashEvent, CrashSchedule

    down = max(2, min(4, epochs // 6))
    return CrashSchedule(
        (
            CrashEvent(at_epoch=max(1, epochs // 4), down_epochs=down),
            CrashEvent(at_epoch=max(2, (3 * epochs) // 5), down_epochs=down),
        ),
        recommit_epochs=3,
    )


_CRASH_LIST: Tuple[CrashSpec, ...] = (
    CrashSpec("none", lambda n, epochs: None, description="no crashes"),
    CrashSpec(
        "one_restart",
        _one_restart,
        description="highest-id honest node dies at epochs/3, restarts "
        "after the net advances a few epochs",
    ),
    CrashSpec(
        "two_restarts",
        _two_restarts,
        description="the same node dies and recovers twice",
    ),
)

CRASHES: Dict[str, CrashSpec] = {c.name: c for c in _CRASH_LIST}

_TRAFFIC_LIST: Tuple[TrafficSpec, ...] = (
    TrafficSpec("none", None, description="load-free soak"),
    TrafficSpec("half_x", 0.5, description="0.5x nominal open-loop load"),
    TrafficSpec("one_x", 1.0, description="1x nominal open-loop load"),
    TrafficSpec("two_x", 2.0, description="2x nominal (overload) load"),
    TrafficSpec(
        "one_x_adaptive",
        1.0,
        description="1x nominal load with the SLO-driven adaptive batch "
        "controller in the loop (input-borne B updates)",
        adaptive=True,
    ),
    TrafficSpec(
        "swing_adaptive",
        0.4,
        description="0.4x base rate under the 10x-swing trace with the "
        "adaptive controller in the loop",
        adaptive=True,
        trace="swing10x",
    ),
)

TRAFFICS: Dict[str, TrafficSpec] = {t.name: t for t in _TRAFFIC_LIST}


@dataclass(frozen=True)
class Cell:
    """One composed-gauntlet cell: the five axes plus shape and seed.
    A cell is a pure function of its fields — same cell, same
    fingerprint, bit for bit (hbbft_tpu_torch/tools/soak.py pins this)."""

    attack: str = "passive"
    schedule: str = "uniform"
    churn: str = "none"
    crash: str = "none"
    traffic: str = "none"
    n: int = 4
    epochs: int = 12
    seed: int = 0
    batch_size: int = 3
    f: Optional[int] = None

    def cell_id(self) -> str:
        return (
            f"{self.attack}x{self.schedule}x{self.churn}x{self.crash}"
            f"x{self.traffic}@n{self.n}e{self.epochs}s{self.seed}"
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "attack": self.attack,
            "schedule": self.schedule,
            "churn": self.churn,
            "crash": self.crash,
            "traffic": self.traffic,
            "n": self.n,
            "epochs": self.epochs,
            "seed": self.seed,
            "batch_size": self.batch_size,
            "f": self.f,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Cell":
        return Cell(**{k: d[k] for k in Cell.__dataclass_fields__ if k in d})


@dataclass
class SoakResult:
    """Verdicts + evidence + replay fingerprint for one gauntlet cell."""

    cell: Cell
    ok: bool = False
    batches_identical: bool = False
    epochs_committed: int = 0
    eras: List[int] = field(default_factory=list)
    missing_expected: List[str] = field(default_factory=list)
    misattributed: List[Tuple[str, str, str]] = field(default_factory=list)
    fault_kinds: Dict[str, int] = field(default_factory=dict)
    fault_log: List[Tuple[str, str, str]] = field(default_factory=list)
    batch_digest: str = ""
    cranks: int = 0
    messages_delivered: int = 0
    #: crash-axis evidence: counts + per-recovery records, and the gate —
    #: every restarted node within recommit_epochs of the honest maximum
    crashes: int = 0
    restarts: int = 0
    recoveries: List[Dict[str, Any]] = field(default_factory=list)
    recovered_in_time: bool = True
    #: traffic-axis evidence (empty without a traffic source)
    tx_committed: int = 0
    tx_per_epoch: float = 0.0
    commit_p50: float = 0.0
    commit_p99: float = 0.0
    traffic_fingerprint: str = ""
    traffic_state: str = ""
    error: Optional[str] = None
    why: Optional[Dict[str, Any]] = None
    stall_named: bool = False
    bounded: bool = False
    #: observability planes (run_cell obs=True): the per-epoch series
    #: rows, the run's gating histogram, and — on failure — the flight
    #: recorder's forensics bundle.  Evidence, NOT state: none of these
    #: enter fingerprint(), so obs on/off cannot flip a replay verdict.
    series: List[Dict[str, Any]] = field(default_factory=list)
    gating: Dict[str, float] = field(default_factory=dict)
    forensics: Optional[Dict[str, Any]] = None

    def fingerprint(self) -> str:
        """Seeded-replay fingerprint: batch sha256 + sorted fault log +
        tx-tracker fingerprint + the crash/restart trace."""
        h = hashlib.sha256()
        h.update(self.batch_digest.encode())
        for t in self.fault_log:
            h.update(repr(t).encode())
        h.update(self.traffic_fingerprint.encode())
        h.update(
            repr(
                (
                    self.crashes,
                    self.restarts,
                    [
                        (r.get("node"), r.get("restart_crank"), r.get("replayed_events"))
                        for r in self.recoveries
                    ],
                    self.cranks,
                    self.epochs_committed,
                )
            ).encode()
        )
        return h.hexdigest()

    def row(self) -> Dict[str, Any]:
        return {
            "cell": self.cell.cell_id(),
            **self.cell.to_dict(),
            "ok": self.ok,
            "bounded": self.bounded,
            "epochs_committed": self.epochs_committed,
            "eras": self.eras,
            "batch_digest": self.batch_digest,
            "fingerprint": self.fingerprint(),
            "fault_kinds": dict(sorted(self.fault_kinds.items())),
            "missing_expected": self.missing_expected,
            "misattributed": self.misattributed[:8],
            "cranks": self.cranks,
            "messages_delivered": self.messages_delivered,
            "crashes": self.crashes,
            "restarts": self.restarts,
            "recoveries": self.recoveries,
            "recovered_in_time": self.recovered_in_time,
            "tx_committed": self.tx_committed,
            "tx_per_epoch": self.tx_per_epoch,
            "commit_p50": self.commit_p50,
            "commit_p99": self.commit_p99,
            "traffic_state": self.traffic_state,
            "stall_named": self.stall_named,
            "error": self.error,
            "gating": self.gating,
        }


def build_cell_net(cell: Cell, backend=None, crank_limit: int = 5_000_000):
    """The composed cell's VirtualNet: SenderQueue-wrapped QHB at N/f
    under the cell's adversary, network schedule, and crash schedule."""
    from hbbft_tpu_torch.protocols.queueing_honey_badger import (
        QueueingHoneyBadgerBuilder,
    )
    from hbbft_tpu_torch.protocols.sender_queue import SenderQueue

    attack = ATTACKS[cell.attack]
    sched = SCHEDULES[cell.schedule]
    crash = CRASHES[cell.crash]
    f = cell.f if cell.f is not None else (cell.n - 1) // 3

    def make(ni, be, rng):
        qhb = (
            QueueingHoneyBadgerBuilder(ni, be, rng)
            .batch_size(cell.batch_size)
            .session_id(b"gauntlet")
            .build()
        )
        return SenderQueue(qhb)

    builder = (
        NetBuilder(range(cell.n))
        .num_faulty(f)
        .adversary(attack.make(cell.n))
        .schedule(sched.make(cell.n))
        .crashes(crash.make(cell.n, cell.epochs))
        .scenario(cell.cell_id())
        .crank_limit(crank_limit)
        .using(make)
    )
    if backend is not None:
        builder = builder.backend(backend)
    return builder.build(seed=cell.seed)


def _soak_collect(result: SoakResult, net, driver) -> None:
    """Evidence fields from a (possibly partial) composed run."""
    correct = net.correct_nodes()
    faulty_ids = {node.id for node in net.faulty_nodes()}
    triples = sorted(
        (repr(node.id), repr(fa.node_id), fa.kind)
        for node in correct
        for fa in node.faults_observed
    )
    result.fault_log = triples
    kinds: Dict[str, int] = {}
    for _, _, kind in triples:
        kinds[kind] = kinds.get(kind, 0) + 1
    result.fault_kinds = kinds
    result.misattributed = [
        t
        for node in correct
        for fa in node.faults_observed
        if fa.node_id not in faulty_ids
        for t in ((repr(node.id), repr(fa.node_id), fa.kind),)
    ]
    common = min((len(node.outputs) for node in correct), default=0)
    result.epochs_committed = common
    seqs = [node.outputs[:common] for node in correct]
    result.batches_identical = bool(seqs) and all(s == seqs[0] for s in seqs)
    h = hashlib.sha256()
    for b in seqs[0] if seqs else ():
        h.update(
            repr(
                (
                    getattr(b, "era", 0),
                    b.epoch,
                    sorted(b.contributions.items(), key=repr),
                    getattr(b, "change", None),
                )
            ).encode()
        )
    result.batch_digest = h.hexdigest()
    result.eras = sorted(
        {getattr(b, "era", 0) for b in (seqs[0] if seqs else ())}
    )
    result.cranks = net.cranks
    result.messages_delivered = net.messages_delivered
    if net.crash is not None:
        st = net.crash.stats()
        result.crashes = st["crashes"]
        result.restarts = st["restarts"]
        result.recoveries = st["recoveries"]
        gate = net.crash.schedule.recommit_epochs
        down = net.down_node_ids()
        ref = max(
            (len(n.outputs) for n in correct if n.id not in down), default=0
        )
        for nid, t in sorted(net.crash.tracks.items(), key=lambda kv: repr(kv[0])):
            if t.crashes and t.state != "up":
                result.recovered_in_time = False  # still (or terminally) down
            elif t.restarts and len(net.nodes[nid].outputs) < ref - gate:
                result.recovered_in_time = False
    if driver is not None:
        rep = driver.report()
        result.tx_committed = rep["committed"]
        result.tx_per_epoch = rep["tx_per_epoch"]
        lat = driver.tracker.hist("tx_commit_latency")
        result.commit_p50 = round(lat.percentile(50), 3)
        result.commit_p99 = round(lat.percentile(99), 3)
        # tracker.fingerprint() is a nested dict; hash a sorted repr so
        # the soak fingerprint stays one hex string.  The controller's B
        # trace (when the adaptive axis is on) is part of the replay
        # contract: a divergent control decision must flip the cell
        # fingerprint even if throughput happens to match.
        fp = repr(sorted(driver.tracker.fingerprint().items()))
        if driver.controller is not None:
            fp += repr(driver.controller.b_trace())
        result.traffic_fingerprint = hashlib.sha256(fp.encode()).hexdigest()
        result.traffic_state = rep["status"]["state"]


def run_cell(
    cell: Cell,
    backend=None,
    crank_limit: int = 5_000_000,
    obs: bool = True,
    net_sink: Optional[List] = None,
) -> SoakResult:
    """Run one composed-gauntlet cell; never raises — a starved cell
    comes back ok=False with the why-stalled report naming the dominant
    cause (attack, partition, down node, or starved/saturated source).

    ``obs=True`` (default) wires the three observability planes: a
    :class:`~hbbft_tpu_torch.obs.critpath.CritPathRecorder` on the module stamp
    hook (gating-chain reconstruction per epoch), a per-epoch
    :class:`~hbbft_tpu_torch.obs.timeseries.MetricsLog` (``result.series``),
    and a :class:`~hbbft_tpu_torch.obs.flight.FlightRecorder` whose forensics
    bundle lands on ``result.forensics`` when the cell dies (CrankError,
    verdict failure, or a ``crash:*`` fault).  None of it enters the
    replay fingerprint.  Cells run sequentially, so the single
    process-wide stamp hook is activated around this run only.

    ``net_sink`` (a caller-supplied list) receives the live VirtualNet
    before the first crank — the post-run inspection hook the dynamic
    snapshot-coverage twin test uses to diff restored instances against
    live ones."""
    rec = _critpath.CritPathRecorder() if obs else None
    if rec is not None:
        _critpath.activate(rec)
    try:
        return _run_cell(cell, backend, crank_limit, rec, net_sink)
    finally:
        if rec is not None:
            _critpath.deactivate()


def _run_cell(
    cell: Cell,
    backend,
    crank_limit: int,
    rec: Optional[_critpath.CritPathRecorder],
    net_sink: Optional[List] = None,
) -> SoakResult:
    from hbbft_tpu_torch.protocols.change import Change
    from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
    from hbbft_tpu_torch.traffic.driver import ObjectTrafficDriver
    from hbbft_tpu_torch.traffic.workload import OpenLoopSource, ZipfPopulation

    attack = ATTACKS[cell.attack]
    sched = SCHEDULES[cell.schedule]
    churn = CHURNS[cell.churn]
    traffic = TRAFFICS[cell.traffic]
    result = SoakResult(cell=cell)
    net = build_cell_net(cell, backend=backend, crank_limit=crank_limit)
    if net_sink is not None:
        net_sink.append(net)
    f = cell.f if cell.f is not None else (cell.n - 1) // 3

    driver = None
    if traffic.rate_frac is not None:
        rate = traffic.rate_frac * (cell.n - f) * cell.batch_size
        trace = None
        if traffic.trace is not None:
            from hbbft_tpu_torch.control.trace import make_trace

            trace = make_trace(traffic.trace)
        controller = None
        if traffic.adaptive:
            from hbbft_tpu_torch.control import SLO, AdaptiveBatchController

            # small-N soak ladder bracketing the cell's batch size; a
            # generous p99 target — soak cells compose partitions and
            # outages, and the controller reacting (not the SLO holding)
            # is what the gauntlet exercises
            controller = AdaptiveBatchController(
                SLO(p99_epochs=8.0),
                initial_b=4,
                ladder=(2, 4, 8, 16),
                window=3,
                hold_epochs=2,
            )
        source = OpenLoopSource(
            rate=rate, population=ZipfPopulation(1024), trace=trace
        )
        driver = ObjectTrafficDriver(
            net,
            source,
            rng=net.rng,
            batch_size=cell.batch_size,
            mempool_capacity=1 << 12,
            controller=controller,
        )

    series = flight = None
    all_paths: List[_critpath.EpochCritPath] = []
    next_frame = [0]
    if rec is not None:
        series = MetricsLog()
        flight = FlightRecorder(context={"cell": cell.to_dict()})
        net.critpath = rec  # crank/virtual-clock ticks + health gate line
        net.metrics_log = series

    def _epoch_obs(k: Optional[int] = None) -> None:
        """Epoch boundary: drain the stamp ring, reconstruct the window's
        gating chains, snap a series row, and push a flight frame."""
        if rec is None:
            return
        if k is None:
            k = next_frame[0]
        next_frame[0] = k + 1
        events = rec.take()
        paths = _critpath.paths_from_events(events)
        if paths:
            rec.last_path = paths[-1]
            all_paths.extend(paths)
        row = snap_net(
            series,
            net,
            k,
            gate=paths[-1] if paths else None,
            controller_b=(
                driver.controller.current_b
                if driver is not None and driver.controller is not None
                else None
            ),
            mempool_depth=driver.max_depth if driver is not None else None,
        )
        flight.record(k, series_row=row, events=events)

    def _obs_finish(reason: Optional[str]) -> None:
        """Attach the evidence planes to the result; ``reason`` non-None
        dumps the flight ring as a forensics bundle."""
        if rec is None:
            return
        if rec.events:
            _epoch_obs()  # trailing window (recovery grace / mid-epoch death)
        result.series = series.rows_list()
        result.gating = _critpath.gating_histogram(all_paths)
        if reason is not None:
            summary = (result.why or {}).get("summary") or []
            result.forensics = flight.bundle(
                reason,
                why=result.why,
                faults=result.fault_log,
                gate_hint=summary[0] if summary else None,
            )

    churn_epochs = set(churn.make(cell.n, cell.epochs))
    # alternating schedule flips so consecutive churn votes name distinct
    # winning changes (tick_tock(1, 0) encrypts every epoch — semantics
    # identical to always, so the flip costs an era change and nothing else)
    flips = (
        Change.set_schedule(EncryptionSchedule("tick_tock", 1, 0)),
        Change.set_schedule(EncryptionSchedule.always()),
    )
    nflip = 0

    def live_done(nt, k: int) -> bool:
        down = nt.down_node_ids()
        return all(
            len(node.outputs) >= k + 1
            for node in nt.correct_nodes()
            if node.id not in down
        )

    try:
        for k in range(cell.epochs):
            if k in churn_epochs:
                ch = flips[nflip % 2]
                nflip += 1
                # down nodes included: send_input parks the vote and the
                # restarted node casts it at recovery (client-retry model)
                for node in net.correct_nodes():
                    net.send_input(node.id, ("change", ch))
            if driver is not None:
                driver._wave(k)
            else:
                if k == 0:
                    for node in net.correct_nodes():
                        net.send_input(
                            node.id, ("user", ("boot", repr(node.id)))
                        )
                net.crank_until(
                    lambda nt, k=k: live_done(nt, k), max_cranks=crank_limit
                )
            _epoch_obs(k)
        if net.crash is not None:
            # recovery grace: give the last restart room to catch up to
            # the honest maximum before the verdict reads the gate.
            # Bounded by a few epochs' worth of cranks — a permanently
            # failed recovery must not spin to the crank limit (QHB
            # self-perpetuates, so the net never quiesces on its own)
            gate = net.crash.schedule.recommit_epochs
            per_epoch = max(1_000, net.cranks // max(1, cell.epochs))
            grace = min(crank_limit, per_epoch * (gate + 3) * 4)

            def recovered(nt) -> bool:
                correct = nt.correct_nodes()
                ref = max(
                    (
                        len(n.outputs)
                        for n in correct
                        if not nt.crash.is_down(n.id)
                    ),
                    default=0,
                )
                for nid, t in sorted(
                    nt.crash.tracks.items(), key=lambda kv: repr(kv[0])
                ):
                    if t.state == "failed":
                        continue  # terminally down: the verdict fails it
                    if (t.state == "down" and t.restart_pending) or (
                        t.state == "up" and t.restarts
                    ):
                        if (
                            nt.crash.is_down(nid)
                            or len(nt.nodes[nid].outputs) < ref - gate
                        ):
                            return False
                return True

            try:
                net.crank_until(recovered, max_cranks=grace)
            except CrankError:
                pass  # verdict reads the gate from the final state
    except CrankError as err:
        result.error = str(err).splitlines()[0]
        result.why = err.report
        result.stall_named = bool((err.report or {}).get("summary"))
        _soak_collect(result, net, driver)
        _obs_finish("crank_error")
        if sched.lossy:
            # bounded-degradation contract: a lossy stall passes iff the
            # committed prefix is identical, nothing was misattributed,
            # restarts met their gate, and the stall names its cause
            result.ok = (
                result.batches_identical
                and not result.misattributed
                and result.recovered_in_time
                and result.stall_named
            )
            result.bounded = result.ok
        return result
    _soak_collect(result, net, driver)
    faulty_ids = {repr(node.id) for node in net.faulty_nodes()}
    missing = []
    for kind in attack.expected_faults:
        landed = any(
            k == kind and accused in faulty_ids
            for _, accused, k in result.fault_log
        )
        if not landed:
            missing.append(kind)
    result.missing_expected = missing
    result.ok = (
        result.batches_identical
        and result.epochs_committed >= cell.epochs
        and not missing
        and not result.misattributed
        and result.recovered_in_time
    )
    if sched.lossy and not result.ok:
        # bounded-degradation contract, same as the 2-axis matrix
        result.ok = (
            result.batches_identical
            and not result.misattributed
            and result.recovered_in_time
        )
        result.bounded = result.ok
    reason = None
    if not result.ok:
        reason = "verdict_failure"
    else:
        # a crash:* fault with a passing verdict (e.g. checkpoint_failed)
        # still merits the evidence dump, the evidence to debug it from
        crash_kinds = sorted(k for k in result.fault_kinds if k.startswith("crash:"))
        if crash_kinds:
            reason = crash_kinds[0]
    _obs_finish(reason)
    return result
