"""Epoch critical-path reconstruction (commit-latency attribution) — the
port's copy of the JAX package's ``obs/critpath.py``.

A HoneyBadger epoch is a DAG — N RBC instances feed N BA instances feed
per-proposer threshold-decrypts feed one batch commit — so epoch latency
is gated by one *chain* through that DAG.  This module rebuilds that
chain per epoch from the protocols' completion events and attributes
latency to phase x instance x node with per-contributor slack.

The protocols stamp lightweight events at their output seams — RBC
decode (``broadcast.py``), BA decision + coin reveal
(``binary_agreement.py``), decrypt combine + batch commit
(``honey_badger.py``) — via the module-level :func:`stamp` hook.  A
:class:`CritPathRecorder` installed with :func:`activate` receives them,
time-stamped with the virtual-clock/crank context the net feeds through
:meth:`CritPathRecorder.tick`; with none active each call costs one
module-global ``is None`` check.  The lockstep array engine's per-epoch
phase wall stamps (``EpochReport.phase_seconds``) collapse to a path via
:func:`path_from_phase_seconds`; :func:`gating_from_series` and
:func:`diff_gating` read and compare the gates a ``MetricsLog`` carries.

Determinism: no wall-clock reads — every timestamp arrives from the
caller (virtual cranks, tracer clocks) — and all dict/set iteration is
sorted.
"""

from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

#: The closed phase vocabulary: every :func:`stamp` call site passes one
#: of these literals, and every phase bills exactly one tracer span
#: category (PHASE_SPAN_CATS); the phase-label guard test pins both, and
#: the trace report's inline copies of them.
PHASES = (
    "rbc.output",
    "ba.decide",
    "coin.reveal",
    "decrypt.combine",
    "epoch.commit",
    "crank",
    "crash:recovery",
)

#: phase -> the array-engine tracer span category it attributes
#: (engine/array_engine.py span vocabulary: cat= literals).
PHASE_SPAN_CATS = {
    "rbc.output": "rbc",
    "ba.decide": "ba",
    "coin.reveal": "coin",
    "decrypt.combine": "decrypt",
    "epoch.commit": "epoch",
    "crank": "crank",
    "crash:recovery": "crash",
}

_PHASE_SET = frozenset(PHASES)

#: engine phase-stamp key -> phase name (path_from_phase_seconds input).
_ENGINE_PHASES = {
    "rbc": "rbc.output",
    "ba": "ba.decide",
    "coin": "coin.reveal",
    "decrypt": "decrypt.combine",
    "crash:recovery": "crash:recovery",
}

# -- the module-level stamp hook -------------------------------------------

_ACTIVE: Optional["CritPathRecorder"] = None


def activate(recorder: "CritPathRecorder") -> "CritPathRecorder":
    """Install ``recorder`` as the process-wide stamp sink (single
    runtime at a time — harnesses activate around a run and deactivate
    in a ``finally``)."""
    global _ACTIVE
    _ACTIVE = recorder
    return recorder


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional["CritPathRecorder"]:
    return _ACTIVE


def stamp(
    phase: str,
    node: Any = None,
    instance: Optional[int] = None,
    rnd: Optional[int] = None,
    epoch: Optional[int] = None,
    value: Any = None,
) -> None:
    """Record a completion event on the active recorder (no-op when none
    is active).  Called from the protocol output seams."""
    r = _ACTIVE
    if r is not None:
        r.stamp(phase, node=node, instance=instance, rnd=rnd, epoch=epoch, value=value)


class CritPathRecorder:
    """Bounded ring of completion events with crank/virtual-clock
    context; drained per epoch by the harness (net/scenarios.run_scenario, run_cell)
    into flight-recorder frames."""

    __slots__ = (
        "capacity",
        "events",
        "crank",
        "now",
        "dropped",
        "last_path",
        "_recovering",
        "_emitted",
    )

    def __init__(self, capacity: int = 65536) -> None:
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.crank = 0
        self.now = 0
        self.dropped = 0
        #: the most recent epoch's reconstructed path (the health
        #: reporter's "last epoch gated by ..." one-liner reads this)
        self.last_path: Optional["EpochCritPath"] = None
        self._recovering: List[Any] = []
        self._emitted = 0

    def tick(self, crank: int, now: int) -> None:
        """Per-crank/virtual-clock-tick context update (the net calls
        this once per crank; stamps inherit the latest tick)."""
        self.crank = crank
        self.now = now

    def stamp(
        self,
        phase: str,
        node: Any = None,
        instance: Optional[int] = None,
        rnd: Optional[int] = None,
        epoch: Optional[int] = None,
        value: Any = None,
    ) -> None:
        if phase not in _PHASE_SET:
            raise ValueError(f"unknown critpath phase {phase!r} (PHASES: {PHASES})")
        ev: Dict[str, Any] = {
            "phase": phase,
            "node": node,
            "instance": instance,
            "round": rnd,
            "epoch": epoch,
            "crank": self.crank,
            "now": self.now,
        }
        if value is not None:
            ev["value"] = value
        if self._recovering and phase != "crash:recovery":
            # WAL replay after a restart: re-derived outputs are recovery
            # work, not consensus progress — bill the pseudo-phase and
            # keep the original phase as ``via`` for forensics.
            ev["via"] = phase
            ev["phase"] = "crash:recovery"
            ev["recovering"] = self._recovering[-1]
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)
        self._emitted += 1

    # -- crash/WAL-replay scoping (net/crash.py _restart) ------------------

    def begin_recovery(self, node: Any) -> None:
        self._recovering.append(node)
        self.stamp("crash:recovery", node=node)

    def end_recovery(self) -> None:
        if self._recovering:
            self._recovering.pop()

    # -- draining ----------------------------------------------------------

    def take(self) -> List[Dict[str, Any]]:
        """Drain and return the buffered events (harness epoch boundary)."""
        out = list(self.events)
        self.events.clear()
        return out

    def gate_line(self) -> Optional[str]:
        p = self.last_path
        return None if p is None else p.one_liner()


# -- the reconstructed path -------------------------------------------------


def phase_label(
    phase: str, instance: Optional[int] = None, rnd: Optional[int] = None
) -> str:
    """Human vocabulary for one chain link: ``BA(7) coin round 3``."""
    inst = "*" if instance is None else str(instance)
    if phase == "rbc.output":
        return f"RBC({inst}) output"
    if phase == "ba.decide":
        return f"BA({inst}) decision" + (f" round {rnd}" if rnd is not None else "")
    if phase == "coin.reveal":
        return f"BA({inst}) coin" + (f" round {rnd}" if rnd is not None else "")
    if phase == "decrypt.combine":
        return f"decrypt.combine({inst})"
    if phase == "epoch.commit":
        return "epoch commit"
    return phase


@dataclass
class EpochCritPath:
    """One epoch's gating chain + latency attribution."""

    epoch: int
    gate_phase: str
    gate_instance: Optional[int] = None
    gate_node: Optional[str] = None  # repr'd node id (JSON-stable)
    gate_round: Optional[int] = None
    #: epoch latency in the three units the gate attributes
    cranks: int = 0
    wall_s: float = 0.0
    device_s: float = 0.0
    #: commit-first chain links: [{"phase", "instance", "node", "round",
    #: "crank", "seg_cranks"|"seg_s"}, ...] — read as
    #: ``epoch <- decrypt.combine <- BA(i) coin <- RBC(i)``
    chain: List[Dict[str, Any]] = field(default_factory=list)
    #: per-(phase, instance, node) completion + slack behind the gate
    contributors: List[Dict[str, Any]] = field(default_factory=list)

    def one_liner(self) -> str:
        label = phase_label(self.gate_phase, self.gate_instance, self.gate_round)
        where = f" on node {self.gate_node}" if self.gate_node is not None else ""
        return f"epoch {self.epoch} gated by {label}{where}"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "EpochCritPath":
        known = {k: d[k] for k in EpochCritPath.__dataclass_fields__ if k in d}
        return EpochCritPath(**known)


def _last_event(
    window: List[Dict[str, Any]],
    phase: str,
    node: Any = None,
    instance: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    for ev in reversed(window):
        if ev.get("phase") != phase:
            continue
        if node is not None and ev.get("node") != node:
            continue
        if instance is not None and ev.get("instance") != instance:
            continue
        return ev
    return None


def _link(ev: Dict[str, Any], seg_cranks: int) -> Dict[str, Any]:
    return {
        "phase": ev.get("via") or ev.get("phase"),
        "instance": ev.get("instance"),
        "node": repr(ev.get("node")),
        "round": ev.get("round"),
        "crank": ev.get("crank", 0),
        "seg_cranks": seg_cranks,
    }


def _window_path(
    epoch: int, window: List[Dict[str, Any]], commit: Dict[str, Any]
) -> EpochCritPath:
    gate_node = commit.get("node")
    start_crank = window[0].get("crank", 0) if window else 0
    # walk the chain backwards from the slowest node's commit
    dec = _last_event(window, "decrypt.combine", node=gate_node)
    ba = _last_event(window, "ba.decide", node=gate_node)
    coin = None
    if ba is not None:
        coin = _last_event(
            window, "coin.reveal", node=gate_node, instance=ba.get("instance")
        )
    rbc = None
    if ba is not None:
        rbc = _last_event(
            window, "rbc.output", node=gate_node, instance=ba.get("instance")
        )
    if rbc is None:
        rbc = _last_event(window, "rbc.output", node=gate_node)
    temporal = [ev for ev in (rbc, coin, ba, dec, commit) if ev is not None]
    temporal.sort(key=lambda ev: ev.get("crank", 0))  # stable: ties keep order
    links: List[Dict[str, Any]] = []
    prev = start_crank
    for ev in temporal:
        c = ev.get("crank", 0)
        links.append(_link(ev, max(0, c - prev)))
        prev = max(prev, c)
    # the gating link owns the longest crank stretch (ties -> latest link)
    gate_link = links[-1] if links else _link(commit, 0)
    best = -1
    for ln in links:
        if ln["seg_cranks"] >= best:
            best = ln["seg_cranks"]
            gate_link = ln
    recov = [ev for ev in window if ev.get("phase") == "crash:recovery"]
    if recov:
        last = recov[-1]
        who = last.get("recovering", last.get("node"))
        gate_phase: str = "crash:recovery"
        gate_instance = None
        gate_round = None
        gate_node_r = repr(who)
        links.insert(0, _link(last, 0))
    else:
        gate_phase = gate_link["phase"]
        gate_instance = gate_link["instance"]
        gate_round = gate_link["round"]
        gate_node_r = gate_link["node"]
    commit_crank = commit.get("crank", 0)
    # per-contributor slack: the last completion per (phase, instance,
    # node), measured behind the commit — the critical contributor has
    # zero slack, everything that finished earlier had room to be slower
    latest: Dict[Any, Dict[str, Any]] = {}
    for ev in window:
        ph = ev.get("phase")
        if ph in ("crank", "epoch.commit"):
            continue
        key = (ph, repr(ev.get("instance")), repr(ev.get("node")))
        cur = latest.get(key)
        if cur is None or ev.get("crank", 0) >= cur.get("crank", 0):
            latest[key] = ev
    contributors = [
        {
            "phase": key[0],
            "instance": latest[key].get("instance"),
            "node": repr(latest[key].get("node")),
            "round": latest[key].get("round"),
            "crank": latest[key].get("crank", 0),
            "slack": max(0, commit_crank - latest[key].get("crank", 0)),
        }
        for key in sorted(latest, key=repr)
    ]
    contributors.sort(key=lambda c: (c["slack"], repr(c["phase"]), repr(c["node"])))
    return EpochCritPath(
        epoch=epoch,
        gate_phase=gate_phase,
        gate_instance=gate_instance,
        gate_node=gate_node_r,
        gate_round=gate_round,
        cranks=max(0, commit_crank - start_crank),
        chain=list(reversed(links)),
        contributors=contributors[:64],
    )


def paths_from_events(events: List[Dict[str, Any]]) -> List[EpochCritPath]:
    """Reconstruct per-epoch gating chains from stamped completion
    events (arrival order preserved; an epoch's window closes at its
    LAST ``epoch.commit`` — the slowest node is the gate)."""
    events = list(events)
    last_commit: Dict[int, int] = {}
    for i, ev in enumerate(events):
        if ev.get("phase") == "epoch.commit" and isinstance(ev.get("epoch"), int):
            last_commit[ev["epoch"]] = i
    paths: List[EpochCritPath] = []
    prev = -1
    for ep in sorted(last_commit):
        end = last_commit[ep]
        if end <= prev:
            continue  # interleaved late commit of an already-closed epoch
        window = events[prev + 1 : end + 1]
        paths.append(_window_path(ep, window, events[end]))
        prev = end
    return paths


def path_from_phase_seconds(
    epoch: int,
    phase_seconds: Dict[str, float],
    cranks: int = 0,
    device_s: float = 0.0,
) -> EpochCritPath:
    """The lockstep array engine's path: phase wall stamps (rbc / ba /
    coin / decrypt, EpochReport.phase_seconds) collapse to a chain whose
    gate is the longest phase.  Instances are degenerate (lockstep runs
    all N in the same wall interval), so the gate names phase only."""
    durs: Dict[str, float] = {}
    for k in sorted(phase_seconds):
        ph = _ENGINE_PHASES.get(k)
        if ph is not None:
            durs[ph] = durs.get(ph, 0.0) + phase_seconds[k]
    gate_phase = "epoch.commit"
    best = -1.0
    for ph in sorted(durs):
        if durs[ph] > best:
            best = durs[ph]
            gate_phase = ph
    chain = [
        {"phase": ph, "instance": None, "node": None, "round": None, "seg_s": round(durs[ph], 6)}
        for ph in sorted(durs, key=lambda p: -durs[p])
    ]
    return EpochCritPath(
        epoch=epoch,
        gate_phase=gate_phase,
        cranks=cranks,
        wall_s=round(sum(durs.values()), 6),
        device_s=round(device_s, 6),
        chain=chain,
    )


# -- run-level aggregation --------------------------------------------------


def gating_histogram(paths: List[EpochCritPath]) -> Dict[str, float]:
    """Run-level gating shares: fraction of epochs each phase gated
    ('BA coin rounds gate 61% of epochs')."""
    counts: Dict[str, int] = {}
    for p in paths:
        counts[p.gate_phase] = counts.get(p.gate_phase, 0) + 1
    total = sum(counts[k] for k in counts)
    if not total:
        return {}
    return {k: round(counts[k] / total, 4) for k in sorted(counts)}


def gating_from_series(rows: List[Dict[str, Any]]) -> Dict[str, float]:
    """Gating histogram straight from MetricsLog rows (their ``gate``
    field) — the series-capture form tools/trace_report.py diffs."""
    counts: Dict[str, int] = {}
    for r in rows:
        g = r.get("gate")
        if isinstance(g, dict) and g.get("phase"):
            counts[g["phase"]] = counts.get(g["phase"], 0) + 1
    total = sum(counts[k] for k in counts)
    if not total:
        return {}
    return {k: round(counts[k] / total, 4) for k in sorted(counts)}


def diff_gating(
    old: Dict[str, float], new: Dict[str, float], tol: float = 0.10
) -> List[Dict[str, Any]]:
    """Phase-share shifts beyond ``tol`` between two gating histograms
    (absolute share points; >tol is a regression-gate failure)."""
    out = []
    for ph in sorted(set(old) | set(new)):
        a, b = old.get(ph, 0.0), new.get(ph, 0.0)
        if abs(b - a) > tol:
            out.append(
                {"phase": ph, "old": round(a, 4), "new": round(b, 4), "shift": round(b - a, 4)}
            )
    return out
