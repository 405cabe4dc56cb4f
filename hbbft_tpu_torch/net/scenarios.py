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
back to the CPU.  The reference's composed soak half (churn, crash and
traffic axes in one multi-epoch cell: ``Cell``, ``run_cell``) comes with
the port's ``traffic/``.
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
