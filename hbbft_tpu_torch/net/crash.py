"""Crash/restart fault injection: kill a node mid-epoch, restore it from
its last checkpoint, and replay it back into the current epoch — the
port's copy of the JAX package's ``net/crash.py``.

``SilentAdversary`` can make a node mute,
but it can never make one *die and come back* — lose every byte of state
since its last checkpoint, miss epochs while the rest of the network
advances, and rejoin committing the same Batches.  This module is that
axis, built on two existing pieces:

* **Checkpoints** are :func:`hbbft_tpu_torch.utils.snapshot.save_node` blobs of
  the node's whole algorithm stack (SenderQueue ⊃ QHB ⊃ DHB ⊃ HB ⊃ …),
  taken at quiescent crank boundaries every ``checkpoint_every``
  committed batches (knob: ``HBBFT_TPU_CHECKPOINT_EVERY``).
* **Catch-up** rides the sender-queue/replay machinery.  Between
  checkpoints the manager keeps a write-ahead log of every event the
  node consumed (delivered message or injected input, each with the
  shared rng's state *before* handling) plus the ordered log of every
  message the node emitted.  Restart = ``load_node(checkpoint)`` + replay
  the WAL with the logged rng states — the restored node re-derives its
  crash-time state **bit-identically**, so each re-emitted message
  matches the sent log and is suppressed instead of double-delivered
  (peers never see an honest node equivocate because it restarted).
  From there the normal SenderQueue window protocol carries it to the
  current epoch: traffic addressed to the node while it was down is
  parked by the manager (the link-layer-retransmission model) and
  re-enqueued at restart; peers' SenderQueues release their buffered
  future-epoch traffic as the node announces progress.

Failure policy: a recovery that cannot complete — unreadable checkpoint,
replay raising, or replayed emissions/outputs diverging from the
pre-crash record — is an **attributed fault** (``crash:recovery_failed``
/ ``crash:replay_divergence``, recorded against the crashed node in its
own fault log), never a harness exception: the soak cell fails its
verdict with evidence instead of killing the run.

Determinism: the manager draws no entropy of its own — replay rng states
come from the WAL, node choice falls back to the highest-id honest node
(the LaggardAdversary convention), and all bookkeeping iterates sorted
ids — so a seeded soak replays its crash/restart trace bit-for-bit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.fault_log import Fault
from hbbft_tpu_torch.obs import critpath as _critpath
from hbbft_tpu_torch.utils.snapshot import SnapshotError, load_node, save_node

if TYPE_CHECKING:  # pragma: no cover
    from hbbft_tpu_torch.net.virtual_net import NetMessage, VirtualNet


def _default_checkpoint_every() -> int:
    return max(1, int(os.environ.get("HBBFT_TPU_CHECKPOINT_EVERY", "4")))


@dataclass(frozen=True)
class CrashEvent:
    """One crash (and optional restart) of one node.

    ``node_id=None`` resolves to the highest-id honest node when the
    schedule arms (deterministic for a given seed — same convention as
    :class:`~hbbft_tpu_torch.net.adversary.LaggardAdversary`).  The crash
    fires when the node has committed ``at_epoch`` batches (or at
    virtual-clock time ``at``, whichever is set); the restart fires once
    the rest of the honest network has advanced ``down_epochs`` further
    batches (or after ``down_ticks`` virtual-clock ticks).  A down node
    whose restart is epoch-gated restarts immediately if the network
    starves without it — the starvation-release convention that keeps a
    misconfigured cell diagnosable instead of silently dead."""

    node_id: Any = None
    at_epoch: Optional[int] = 1
    at: Optional[int] = None
    down_epochs: Optional[int] = 2
    down_ticks: Optional[int] = None
    restart: bool = True


class CrashSchedule:
    """The crash axis of a scenario cell: which nodes die when, how long
    they stay down, and how often their state is checkpointed."""

    def __init__(
        self,
        events: Tuple[CrashEvent, ...] = (),
        checkpoint_every: Optional[int] = None,
        recommit_epochs: int = 3,
    ) -> None:
        self.events = tuple(events)
        self.checkpoint_every = (
            checkpoint_every
            if checkpoint_every is not None
            else _default_checkpoint_every()
        )
        #: the recovery gate: a restarted node must be within this many
        #: committed batches of the honest maximum by the end of a soak
        self.recommit_epochs = recommit_epochs

    def describe(self) -> Dict[str, Any]:
        return {
            "events": len(self.events),
            "checkpoint_every": self.checkpoint_every,
            "recommit_epochs": self.recommit_epochs,
        }


class _NodeTrack:
    """Per-node crash-axis state: pending events, checkpoint, WAL."""

    def __init__(self, events: List[CrashEvent]) -> None:
        self.pending: List[CrashEvent] = list(events)
        self.state = "up"  # "up" | "down" | "restoring" | "failed"
        self.down_since_now = 0
        self.down_since_crank = 0
        self.outputs_at_crash = 0
        self.restart_at_now: Optional[int] = None
        self.restart_epoch_mark: Optional[int] = None
        self.restart_pending = False
        # checkpoint: algorithm blob + the harness-side marks that pair it
        self.ckpt_blob: Optional[bytes] = None
        self.ckpt_outputs = 0
        self.ckpt_faults = 0
        self.ckpt_epoch: Tuple[int, int] = (0, 0)
        # write-ahead log since the checkpoint: ("m", rng_state, sender,
        # payload) for deliveries, ("i", rng_state, input, None) for inputs
        self.wal: List[Tuple[str, Any, Any, Any]] = []
        # ordered (to, payload) emissions since the checkpoint, and the
        # replay cursor consumed against it during restart
        self.sent: List[Tuple[Any, Any]] = []
        self.sent_cursor = 0
        self.diverged = False
        # traffic/input parked while down (re-enqueued at restart)
        self.parked: List["NetMessage"] = []
        self.parked_inputs: List[Any] = []
        # evidence for the soak verdicts
        self.crashes = 0
        self.restarts = 0
        self.recoveries: List[Dict[str, Any]] = []

    @property
    def active(self) -> bool:
        """Still worth logging for: a crash is pending or in progress."""
        return bool(self.pending) or self.state != "up"


#: wrapper-chain depth bound (SenderQueue ⊃ QHB ⊃ DHB ⊃ HB is 4; the
#: bound replaces an id()-based cycle guard, which would make the walk
#: depend on object addresses)
_MAX_WRAP_DEPTH = 8


def _era_epoch(algo: Any) -> Tuple[int, int]:
    """(era, epoch) of an algorithm stack, for checkpoint reporting.
    Duck-typed walk through SenderQueue/QHB wrappers (obs/health.py's
    unwrap convention); totals to (0, 0) on unknown shapes."""
    for _ in range(_MAX_WRAP_DEPTH):
        for attr in ("algo", "dhb"):
            inner = getattr(algo, attr, None)
            if inner is not None and hasattr(inner, "handle_message"):
                algo = inner
                break
        else:
            break
    hb = getattr(algo, "hb", None)
    if hb is not None:
        return (getattr(algo, "era", 0), getattr(hb, "epoch", 0))
    return (0, getattr(algo, "epoch", 0))


def _find_rng(algo: Any) -> Optional[Any]:
    """The rng object the algorithm stack draws from internally (QHB/DHB
    store the builder rng; plain HB takes it per call)."""
    for _ in range(_MAX_WRAP_DEPTH):
        rng = getattr(algo, "rng", None)
        if rng is not None and hasattr(rng, "getstate"):
            return rng
        for attr in ("algo", "dhb", "hb"):
            inner = getattr(algo, attr, None)
            if inner is not None and hasattr(inner, "handle_message"):
                algo = inner
                break
        else:
            return None
    return None


def _rebind_rng(algo: Any, rng: Any) -> None:
    """Point every wrapper layer's stored rng back at the net's shared
    stream (post-replay: the restored clone's job is done, and future
    deliveries log the shared rng's state for any *second* crash)."""
    for _ in range(_MAX_WRAP_DEPTH):
        if algo is None:
            return
        if hasattr(getattr(algo, "rng", None), "getstate"):
            algo.rng = rng
        nxt = None
        for attr in ("algo", "dhb", "hb"):
            inner = getattr(algo, attr, None)
            if inner is not None and hasattr(inner, "handle_message"):
                nxt = inner
                break
        algo = nxt


class CrashManager:
    """VirtualNet's crash axis driver.  All hooks are total: a failure
    inside recovery becomes an attributed ``crash:*`` fault, never an
    exception out of the crank loop."""

    #: environment, not state: live callables installed by drivers (e.g.
    #: ObjectTrafficDriver re-installing its sample_listener on the
    #: restored algorithm).  Whole-net snapshots drop them.
    restart_listeners = ()
    _SNAPSHOT_ENV_ATTRS = ("restart_listeners",)

    def __init__(self, schedule: CrashSchedule) -> None:
        self.schedule = schedule
        self.tracks: Dict[Any, _NodeTrack] = {}
        self._order: List[Any] = []
        self._armed = False
        self._replaying: Any = None
        self.restart_listeners: List[Any] = []

    def add_restart_listener(self, fn) -> None:
        """Register a restart hook.  Rebinds instead of appending so it
        also works on a restored manager, whose env-attr fallback is the
        immutable class-level ``()``."""
        self.restart_listeners = list(self.restart_listeners) + [fn]

    # -- introspection -------------------------------------------------------

    def down_ids(self) -> frozenset:
        return frozenset(
            nid for nid in self._order if self.tracks[nid].state != "up"
        )

    def is_down(self, node_id) -> bool:
        t = self.tracks.get(node_id)
        return t is not None and t.state != "up"

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"crashes": 0, "restarts": 0, "recoveries": []}
        for nid in self._order:
            t = self.tracks[nid]
            out["crashes"] += t.crashes
            out["restarts"] += t.restarts
            out["recoveries"].extend(t.recoveries)
        return out

    def describe(self, now: int) -> Dict[str, Any]:
        """State snapshot for the why-stalled crash context."""
        nodes: Dict[str, Any] = {}
        for nid in self._order:
            t = self.tracks[nid]
            d: Dict[str, Any] = {"state": t.state}
            if t.state != "up":
                d["down_since_crank"] = t.down_since_crank
                d["checkpoint_epoch"] = list(t.ckpt_epoch)
                d["restart_pending"] = t.restart_pending
                if t.restart_at_now is not None:
                    d["restart_at"] = t.restart_at_now
                if t.restart_epoch_mark is not None:
                    d["restart_epoch_mark"] = t.restart_epoch_mark
            elif t.restarts:
                d["restarts"] = t.restarts
            if t.parked:
                d["parked_messages"] = len(t.parked)
            nodes[repr(nid)] = d
        return {"schedule": self.schedule.describe(), "nodes": nodes}

    # -- arming --------------------------------------------------------------

    def _arm(self, net: "VirtualNet") -> None:
        self._armed = True
        by_node: Dict[Any, List[CrashEvent]] = {}
        honest = [n.id for n in net.correct_nodes()]
        fallback = max(honest, key=net.node_order_key) if honest else None
        for ev in self.schedule.events:
            nid = ev.node_id if ev.node_id is not None else fallback
            if nid is None or nid not in net.nodes:
                continue
            by_node.setdefault(nid, []).append(ev)
        self._order = sorted(by_node, key=net.node_order_key)
        for nid in self._order:
            self.tracks[nid] = _NodeTrack(by_node[nid])
            # epoch-0 baseline: a node that dies before its first periodic
            # checkpoint still has a recovery point
            self._checkpoint(net, nid)

    # -- crank hooks (called by VirtualNet; must never raise) ----------------

    def on_crank(self, net: "VirtualNet") -> None:
        """Fire due crashes and due restarts (start-of-crank)."""
        if not self._armed:
            self._arm(net)
        for nid in self._order:
            t = self.tracks[nid]
            if t.state == "up" and t.pending:
                ev = t.pending[0]
                due = (ev.at is not None and net.now >= ev.at) or (
                    ev.at_epoch is not None
                    and len(net.nodes[nid].outputs) >= ev.at_epoch
                )
                if due:
                    self._crash(net, nid, ev)
            elif t.state == "down" and t.restart_pending:
                if self._restart_due(net, t):
                    self._restart(net, nid)

    def on_idle(self, net: "VirtualNet") -> bool:
        """Quiescence handling: fast-forward the virtual clock to the
        next tick-gated event, and starvation-release any epoch-gated
        restart (the net drained without the node, so nothing will ever
        advance the epoch mark).  Returns True when an event fired."""
        if not self._armed and self.schedule.events:
            self._arm(net)
        fired = False
        ticks = [
            t.restart_at_now
            for nid in self._order
            for t in (self.tracks[nid],)
            if t.state == "down" and t.restart_pending
            and t.restart_at_now is not None
        ] + [
            t.pending[0].at
            for nid in self._order
            for t in (self.tracks[nid],)
            if t.state == "up" and t.pending and t.pending[0].at is not None
        ]
        if ticks:
            net.now = max(net.now, min(ticks))
            self.on_crank(net)
            fired = True
        for nid in self._order:
            t = self.tracks[nid]
            # starvation release is for EPOCH-gated restarts only (their
            # mark can never advance on a drained net); a tick-gated
            # restart keeps its configured outage — the fast-forward
            # branch above reaches it when its time comes
            if (
                t.state == "down"
                and t.restart_pending
                and t.restart_at_now is None
            ):
                self._restart(net, nid)
                fired = True
        return fired

    def after_crank(self, net: "VirtualNet") -> None:
        """Periodic checkpointing at the quiescent crank boundary."""
        if not self._armed or net._pending_work:
            return
        for nid in self._order:
            t = self.tracks[nid]
            if (
                t.state == "up"
                and t.pending
                and len(net.nodes[nid].outputs) - t.ckpt_outputs
                >= self.schedule.checkpoint_every
            ):
                self._checkpoint(net, nid)

    def on_deliver(self, net: "VirtualNet", msg: "NetMessage") -> None:
        """WAL a delivery to a crash-tracked node (pre-handling, with the
        shared rng's pre-handling state)."""
        # lint: allow[seam-race] live WAL append vs replay read is the axis's
        # one seam: _restart only runs between cranks, never concurrently
        t = self.tracks.get(msg.to)
        if t is not None and t.state == "up" and t.pending:
            t.wal.append(("m", net.rng.getstate(), msg.sender, msg.payload))

    def on_input(self, net: "VirtualNet", node_id, input: Any) -> bool:
        """Park inputs to a down node (True = consumed); WAL inputs to a
        crash-tracked live node."""
        t = self.tracks.get(node_id)
        if t is None:
            return False
        if t.state != "up":
            t.parked_inputs.append(input)
            return True
        if t.pending:
            t.wal.append(("i", net.rng.getstate(), input, None))
        return False

    def on_send(self, net: "VirtualNet", node: Any, msg: "NetMessage") -> bool:
        """Sent-log bookkeeping.  During a replay, emissions matching the
        pre-crash record are suppressed (True) — they were already
        delivered; a mismatch marks the recovery diverged and lets the
        message through (peers will fault the double-send, which is the
        point: divergence must be visible evidence)."""
        # lint: allow[seam-race] _restart sets _replaying around a synchronous
        # replay loop; the crank loop is single-threaded so no interleaving
        if self._replaying == node.id:
            t = self.tracks[node.id]
            if t.sent_cursor < len(t.sent):
                to, payload = t.sent[t.sent_cursor]
                if to == msg.to and payload == msg.payload:
                    t.sent_cursor += 1
                    net.counters.crash_suppressed_sends += 1
                    return True
            t.diverged = True
            return False
        t = self.tracks.get(node.id)
        if t is not None and t.state == "up" and t.pending:
            t.sent.append((msg.to, msg.payload))
        return False

    def on_enqueue(self, net: "VirtualNet", msg: "NetMessage") -> bool:
        """Park traffic addressed to a down node (True = consumed): the
        simulator's stand-in for link-layer retransmission."""
        t = self.tracks.get(msg.to)
        if t is not None and t.state != "up":
            t.parked.append(msg)
            net.counters.crash_parked_messages += 1
            return True
        return False

    # -- the axis itself -----------------------------------------------------

    def _fault(self, net: "VirtualNet", nid, kind: str) -> None:
        net.nodes[nid].faults_observed.append(Fault(nid, kind))
        net.counters.faults_recorded += 1

    def _checkpoint(self, net: "VirtualNet", nid) -> None:
        node = net.nodes[nid]
        t = self.tracks[nid]
        try:
            blob = save_node(node.algorithm)
        except SnapshotError:
            # a stale recovery point, visibly attributed — not a crash of
            # the harness and not a silently-skipped checkpoint
            self._fault(net, nid, "crash:checkpoint_failed")
            return
        t.ckpt_blob = blob
        t.ckpt_outputs = len(node.outputs)
        t.ckpt_faults = len(node.faults_observed)
        t.ckpt_epoch = _era_epoch(node.algorithm)
        t.wal = []
        t.sent = []
        net.counters.crash_checkpoints += 1

    def _max_honest_outputs(self, net: "VirtualNet") -> int:
        best = 0
        for node in net.correct_nodes():
            if not self.is_down(node.id):
                best = max(best, len(node.outputs))
        return best

    def _crash(self, net: "VirtualNet", nid, ev: CrashEvent) -> None:
        import heapq

        t = self.tracks[nid]
        t.pending.pop(0)
        t.state = "down"
        t.crashes += 1
        t.down_since_now = net.now
        t.down_since_crank = net.cranks
        t.outputs_at_crash = len(net.nodes[nid].outputs)
        t.restart_pending = ev.restart
        t.restart_at_now = (
            net.now + ev.down_ticks if ev.down_ticks is not None else None
        )
        t.restart_epoch_mark = (
            self._max_honest_outputs(net) + ev.down_epochs
            if ev.down_epochs is not None
            else None
        )
        net.counters.node_crashes += 1
        # sweep in-flight traffic addressed to the dead node into the
        # parked store: live queue + the schedule layer's future heap
        # (entries are (not_before, seq, msg) with unique seq, so sorting
        # never compares messages — the LaggardAdversary convention)
        held = [m for m in net.queue if m.to == nid]
        if held:
            net.queue[:] = [m for m in net.queue if m.to != nid]
            t.parked.extend(held)
            net.counters.crash_parked_messages += len(held)
        fut = net._future
        if fut and any(e[2].to == nid for e in fut):
            fut_held = sorted(e for e in fut if e[2].to == nid)
            fut[:] = [e for e in fut if e[2].to != nid]
            heapq.heapify(fut)
            t.parked.extend(e[2] for e in fut_held)
            net.counters.crash_parked_messages += len(fut_held)

    def _restart_due(self, net: "VirtualNet", t: _NodeTrack) -> bool:
        if t.restart_at_now is not None and net.now >= t.restart_at_now:
            return True
        return (
            t.restart_epoch_mark is not None
            and self._max_honest_outputs(net) >= t.restart_epoch_mark
        )

    def _restart(self, net: "VirtualNet", nid) -> None:
        t = self.tracks[nid]
        node = net.nodes[nid]
        t.restart_pending = False
        t.state = "restoring"
        if t.ckpt_blob is None:
            self._fault(net, nid, "crash:recovery_failed")
            t.state = "failed"
            return
        pre_tail = list(node.outputs[t.ckpt_outputs :])
        try:
            algo = load_node(t.ckpt_blob, net.backend)
        except SnapshotError:
            self._fault(net, nid, "crash:recovery_failed")
            t.state = "failed"
            return
        node.algorithm = algo
        del node.outputs[t.ckpt_outputs :]
        # protocol faults in the truncated tail re-emerge from the replay;
        # manager-attributed crash:* evidence does not — preserve it
        preserved = [
            f
            for f in node.faults_observed[t.ckpt_faults :]
            if f.kind.startswith("crash:")
        ]
        del node.faults_observed[t.ckpt_faults :]
        node.faults_observed.extend(preserved)
        replay_rng = _find_rng(algo)
        if replay_rng is None:
            replay_rng = net.rng.__class__()
        t.sent_cursor = 0
        t.diverged = False
        self._replaying = nid
        # WAL-replay window: protocol completion stamps fired while the
        # node catches up attribute to the crash:recovery pseudo-phase —
        # a restart-gated epoch must name the recovering node, not the
        # phase the replay happened to re-run.
        rec = _critpath.active()
        if rec is not None:
            rec.begin_recovery(nid)
        try:
            for kind, state, a, b in t.wal:
                replay_rng.setstate(state)
                if kind == "m":
                    step = node.algorithm.handle_message(a, b, rng=replay_rng)
                else:
                    step = node.algorithm.handle_input(a, rng=replay_rng)
                net._process_step(node, step)
                net.counters.crash_replayed_events += 1
        except Exception:
            self._fault(net, nid, "crash:recovery_failed")
            t.state = "failed"
            return
        finally:
            self._replaying = None
            if rec is not None:
                rec.end_recovery()
        if (
            t.diverged
            or t.sent_cursor != len(t.sent)
            or node.outputs[t.ckpt_outputs :] != pre_tail
        ):
            self._fault(net, nid, "crash:replay_divergence")
        _rebind_rng(node.algorithm, net.rng)
        t.state = "up"
        t.restarts += 1
        net.counters.node_restarts += 1
        t.recoveries.append(
            {
                "node": repr(nid),
                "down_cranks": net.cranks - t.down_since_crank,
                "checkpoint_epoch": list(t.ckpt_epoch),
                "replayed_events": len(t.wal),
                "recommitted": len(node.outputs) - t.ckpt_outputs,
                "behind_after_replay": max(
                    0, self._max_honest_outputs(net) - len(node.outputs)
                ),
                "restart_crank": net.cranks,
            }
        )
        parked, t.parked = t.parked, []
        for msg in parked:
            net._enqueue(msg)
        parked_inputs, t.parked_inputs = t.parked_inputs, []
        for inp in parked_inputs:
            net.send_input(nid, inp)
        # lint: allow[replay-purity] post-replay env reattachment: the WAL
        # loop above has already sealed replayed state; listeners exist
        # precisely so the environment (traffic driver, controller) can
        # re-install its checkpoint-detached hooks on the fresh instance
        for fn in self.restart_listeners:
            try:
                fn(net, nid, node.algorithm)
            except Exception:
                self._fault(net, nid, "crash:recovery_failed")
