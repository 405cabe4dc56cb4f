"""Run health: periodic heartbeat + stall detection with a "why-stalled"
protocol report — the port's copy of the JAX package's ``obs/health.py``.

HoneyBadger's liveness argument is compositional: an epoch terminates iff
every accepted RBC reaches Echo/Ready quorum and every BA instance's
MMR-style agreement (Mostéfaoui et al., PODC 2014) terminates coin round
by coin round.  So when a run stops making progress there is always
a *nameable* culprit: a BA instance blocked on a coin round short of
threshold+1 verified shares, an RBC instance short of Echo (N−f) or
Ready (2f+1) quorum, or a ThresholdDecrypt short of f+1 shares.
:func:`why_stalled` walks the live protocol objects (through the
SenderQueue → QueueingHoneyBadger → DynamicHoneyBadger → HoneyBadger →
Subset wrapper chain) and reports exactly that, per node;
``VirtualNet`` attaches it to every tripped limit.  A runner's scenario
label, its crash axis (``net.crash``) and its critical-path recorder's
latest gate (``net.critpath``) lead the report, and a traffic driver
(``net.traffic``) adds its source's state: starved or saturated.

:class:`HealthReporter` is the driver-facing wrapper: call :meth:`tick`
once per crank burst / epoch with the run's monotonic progress figures;
it emits a JSON heartbeat every ``interval_s`` wall seconds (epoch,
msgs/s, device-time share, fault count, counter deltas) and — after
``stall_timeout_s`` seconds without progress — a one-shot why-stalled
report.  Wired into ``hbbft_tpu_torch/tools/simulation.py``
(``--heartbeat`` / ``--stall-timeout``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional


# ---------------------------------------------------------------------------
# Protocol introspection (duck-typed: no protocol imports, so obs/ stays a
# leaf package usable from net/, engine/, and tools/ alike)
# ---------------------------------------------------------------------------

#: wrapper attribute chain: SenderQueue.algo, QueueingHoneyBadger.dhb,
#: DynamicHoneyBadger.hb
_WRAPPER_ATTRS = ("algo", "dhb", "hb")


def _unwrap(algo: Any) -> Any:
    seen = set()
    while algo is not None and id(algo) not in seen:
        seen.add(id(algo))
        for attr in _WRAPPER_ATTRS:
            inner = getattr(algo, attr, None)
            if inner is not None and hasattr(inner, "handle_message"):
                algo = inner
                break
        else:
            return algo
    return algo


def _ba_status(ba: Any) -> Optional[Dict[str, Any]]:
    """Progress state of one undecided BinaryAgreement instance."""
    if ba.decision is not None:
        return None
    netinfo = ba.netinfo
    st: Dict[str, Any] = {"round": ba.round}
    if ba._coin_invoked and ba._coin_value is None:
        coin = ba._coin
        st["blocked_on"] = "coin"
        st["coin_round"] = ba.round
        st["coin_shares_verified"] = (
            len(coin._verified) if coin is not None else 0
        )
        st["coin_shares_needed"] = netinfo.public_key_set.threshold() + 1
    elif ba.sent_conf is None:
        st["blocked_on"] = "sbv"
    else:
        st["blocked_on"] = "conf"
        st["conf_received"] = ba._count_conf()
        st["conf_needed"] = netinfo.num_correct()
    return st


def _rbc_status(bc: Any) -> Optional[Dict[str, Any]]:
    """Progress state of one undelivered Broadcast (RBC) instance."""
    if bc.terminated():
        return None
    n = bc.netinfo.num_nodes()
    f = bc.netinfo.num_faulty()
    roots = {p.root_hash for p in bc.echos.values()} | set(bc.readys.values())
    echo_max = max((bc._count_echos(r) for r in roots), default=0)
    ready_max = max((bc._count_readys(r) for r in roots), default=0)
    return {
        "has_value": bc.has_value,
        "echoes": echo_max,
        "echoes_needed": n - f,
        "readys": ready_max,
        "readys_needed": 2 * f + 1,
    }


def _decrypt_status(td: Any) -> Optional[Dict[str, Any]]:
    if td.terminated():
        return None
    return {
        "ciphertext_set": td.ciphertext is not None,
        "shares_verified": len(td._verified),
        "shares_needed": td.netinfo.public_key_set.threshold() + 1,
    }


def _inspect_subset(subset: Any) -> Dict[str, Any]:
    out: Dict[str, Any] = {"ba": {}, "rbc": {}}
    for proposer, ps in subset.proposals.items():
        if ps.decision is None:
            ba = _ba_status(ps.agreement)
            if ba is not None:
                out["ba"][repr(proposer)] = ba
        if ps.value is None:
            rbc = _rbc_status(ps.broadcast)
            if rbc is not None:
                out["rbc"][repr(proposer)] = rbc
    return out


def _inspect_core(core: Any) -> Dict[str, Any]:
    """Dispatch on the duck type of an unwrapped protocol instance."""
    es = getattr(core, "_epoch_state", None)
    if es is not None and hasattr(es, "subset"):  # HoneyBadger
        out = _inspect_subset(es.subset)
        out["epoch"] = core.epoch
        dec = {
            repr(p): st
            for p, st in (
                (p, _decrypt_status(td)) for p, td in es.decrypt.items()
            )
            if st is not None
        }
        if dec:
            out["decrypt"] = dec
        return out
    if hasattr(core, "proposals"):  # Subset driven directly
        return _inspect_subset(core)
    if hasattr(core, "received_conf") and hasattr(core, "sbv"):  # BA
        ba = _ba_status(core)
        return {"ba": {"self": ba}} if ba is not None else {"ba": {}}
    if hasattr(core, "echos") and hasattr(core, "readys"):  # Broadcast
        rbc = _rbc_status(core)
        return {"rbc": {"self": rbc}} if rbc is not None else {"rbc": {}}
    return {}


def _scenario_context(net: Any) -> Optional[Dict[str, Any]]:
    """Attack/scenario/schedule identity of a VirtualNet-like runner —
    names the active adversary and the network condition so a starved
    instance reads as "partition isolates {2,3}; BA coin quorum short",
    not as an anonymous missing quorum.  Duck-typed and total: absent
    attributes simply contribute nothing."""
    ctx: Dict[str, Any] = {}
    name = getattr(net, "scenario_name", None)
    if name:
        ctx["scenario"] = name
    adv = getattr(net, "adversary", None)
    if adv is not None and type(adv).__name__ != "NullAdversary":
        describe = getattr(adv, "describe", None)
        ctx["adversary"] = (
            describe() if callable(describe) else type(adv).__name__
        )
    sched = getattr(net, "schedule", None)
    now = getattr(net, "now", 0)
    if sched is not None:
        try:
            ctx["schedule"] = sched.describe(now)
        except Exception:  # a report must never raise on a custom schedule
            ctx["schedule"] = {"name": type(sched).__name__}
        future = len(getattr(net, "_future", ()) or ())
        if future:
            ctx["future_dated_messages"] = future
    return ctx or None


def _scenario_summary(ctx: Dict[str, Any]) -> str:
    parts = []
    if "scenario" in ctx:
        parts.append(f"scenario {ctx['scenario']}")
    adv = ctx.get("adversary")
    if adv:
        parts.append(f"adversary {adv.get('name', adv)}" if isinstance(adv, dict) else f"adversary {adv}")
    sched = ctx.get("schedule")
    if isinstance(sched, dict):
        part = sched.get("partition")
        if part:
            isolates = "; ".join(
                "{" + ", ".join(map(str, g)) + "}" for g in part["isolates"]
            )
            parts.append(
                f"partition isolates {isolates} until crank {part['heals_at']}"
            )
        else:
            parts.append(f"schedule {sched.get('name')}")
    if ctx.get("future_dated_messages"):
        parts.append(f"{ctx['future_dated_messages']} messages future-dated")
    return "; ".join(parts)


def _crash_context(net: Any) -> Optional[Dict[str, Any]]:
    """Crash-axis state of a runner with a crash manager attached
    (``net.crash`` — hbbft_tpu_torch/net/crash.py): which nodes are down since
    when, which checkpoint each would restore from, and completed
    restarts.  Duck-typed and total like the other contexts."""
    cm = getattr(net, "crash", None)
    if cm is None:
        return None
    describe = getattr(cm, "describe", None)
    if not callable(describe):
        return None
    try:
        ctx = dict(describe(getattr(net, "now", 0)))
    except Exception:
        return None
    return ctx if ctx.get("nodes") else None


def _crash_summary(ctx: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    for nid, st in sorted(ctx.get("nodes", {}).items()):
        state = st.get("state")
        if state in ("down", "restoring"):
            ck = st.get("checkpoint_epoch", [0, 0])
            lines.append(
                f"node {nid} down since crank {st.get('down_since_crank')}"
                f" / restoring from checkpoint at epoch "
                f"(era {ck[0]}, epoch {ck[1]})"
                + (
                    ""
                    if st.get("restart_pending")
                    else " — no restart scheduled"
                )
            )
        elif state == "failed":
            lines.append(
                f"node {nid} down since crank "
                f"{st.get('down_since_crank')} — recovery FAILED "
                "(crash:recovery_failed attributed)"
            )
    return lines


def _traffic_context(net: Any) -> Optional[Dict[str, Any]]:
    """Traffic-source state of a runner driven by the traffic subsystem
    (``net.traffic`` is a driver exposing ``status()`` —
    hbbft_tpu_torch/traffic/driver.py).  Duck-typed and total like the
    scenario context: a runner without traffic contributes nothing, and
    a report must never raise on a custom driver."""
    tr = getattr(net, "traffic", None)
    if tr is None:
        return None
    status = getattr(tr, "status", None)
    if not callable(status):
        return None
    try:
        st = dict(status())
    except Exception:
        return None
    return st or None


def _traffic_summary(ctx: Dict[str, Any]) -> str:
    state = ctx.get("state", "unknown")
    src = ctx.get("source") or {}
    name = src.get("source", "traffic") if isinstance(src, dict) else str(src)
    if state == "saturated":
        line = (
            f"traffic source {name} saturated: mempool "
            f"{ctx.get('mempool_depth', '?')}/{ctx.get('capacity', '?')}, "
            f"{ctx.get('dropped', 0)} dropped, {ctx.get('evicted', 0)} evicted"
        )
    elif state == "starved":
        line = (
            f"traffic source {name} starved: mempool empty, "
            f"{ctx.get('committed', 0)} committed, nothing pending"
        )
    else:
        line = f"traffic source {name} {state}"
    ctrl = ctx.get("controller")
    if isinstance(ctrl, dict):
        # the control plane's live operating point rides the stall
        # report: current B and whether the declared SLO holds
        slo = ctrl.get("slo") or {}
        line += (
            f"; adaptive batch B={ctrl.get('batch_size')} "
            f"(p99 target {slo.get('p99_epochs')} epochs, "
            + ("SLO compliant" if ctrl.get("compliant") else "SLO VIOLATED")
            + ")"
        )
    return line


def why_stalled(net_or_nodes: Any) -> Dict[str, Any]:
    """Build the why-stalled report for a quiesced-but-unfinished run.

    Accepts a :class:`~hbbft_tpu_torch.net.virtual_net.VirtualNet`, an
    ``examples.simulation.Simulation``, or any ``{node_id: node}`` mapping
    whose values carry the protocol under ``.algorithm``/``.algo`` (or
    are the protocol itself).  When the runner carries an adversary /
    scenario / schedule (the scenario harness), the report leads with
    that context — a starved quorum under a live partition names the
    partition, not just the shortfall.
    """
    nodes = getattr(net_or_nodes, "nodes", net_or_nodes)
    report: Dict[str, Any] = {"nodes": {}, "summary": []}
    # lead with the latest critical-path gate (net.critpath, when the
    # harness attached a CritPathRecorder): "last epoch gated by BA(3)
    # coin round 2 on node 7" orients the reader before the per-node
    # quorum shortfalls below
    cp = getattr(net_or_nodes, "critpath", None)
    gate_line = getattr(cp, "gate_line", None)
    line = gate_line() if callable(gate_line) else None
    if line:
        report["gate"] = line
        report["summary"].append(f"last {line}")
    ctx = _scenario_context(net_or_nodes)
    if ctx is not None:
        report["scenario"] = ctx
        report["summary"].append(_scenario_summary(ctx))
    cctx = _crash_context(net_or_nodes)
    if cctx is not None:
        report["crash"] = cctx
        report["summary"].extend(_crash_summary(cctx))
    tctx = _traffic_context(net_or_nodes)
    if tctx is not None:
        report["traffic"] = tctx
        report["summary"].append(_traffic_summary(tctx))
    for nid in sorted(nodes, key=repr):
        node = nodes[nid]
        algo = getattr(node, "algorithm", None)
        if algo is None:
            algo = getattr(node, "algo", node)
        state = _inspect_core(_unwrap(algo))
        pruned = {
            k: v for k, v in state.items() if v or k == "epoch"
        }
        if any(pruned.get(k) for k in ("ba", "rbc", "decrypt")):
            report["nodes"][repr(nid)] = pruned
    for nid, state in report["nodes"].items():
        for p, ba in state.get("ba", {}).items():
            if ba["blocked_on"] == "coin":
                short = ba["coin_shares_needed"] - ba["coin_shares_verified"]
                report["summary"].append(
                    f"node {nid}: BA[{p}] blocked on coin round "
                    f"{ba['coin_round']} — coin quorum short {short} shares "
                    f"({ba['coin_shares_verified']}/{ba['coin_shares_needed']}"
                    " verified)"
                )
            else:
                report["summary"].append(
                    f"node {nid}: BA[{p}] in round {ba['round']} waiting on "
                    f"{ba['blocked_on']}"
                )
        for p, rbc in state.get("rbc", {}).items():
            report["summary"].append(
                f"node {nid}: RBC[{p}] lacks quorum "
                f"(Echo {rbc['echoes']}/{rbc['echoes_needed']}, "
                f"Ready {rbc['readys']}/{rbc['readys_needed']})"
            )
        for p, td in state.get("decrypt", {}).items():
            report["summary"].append(
                f"node {nid}: decrypt[{p}] has "
                f"{td['shares_verified']}/{td['shares_needed']} shares"
            )
    return report


def render_why_stalled(report: Dict[str, Any]) -> str:
    lines = ["why-stalled report:"]
    lines.extend("  " + s for s in report["summary"])
    if not report["summary"]:
        lines.append("  no blocked protocol instances found")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Heartbeat + stall detector
# ---------------------------------------------------------------------------


def _print_sink(record: Dict[str, Any]) -> None:
    print(json.dumps(record, default=repr), flush=True)


class HealthReporter:
    """Periodic heartbeat + no-progress stall detector for soak runs.

    ``counters_fn`` returns the run's merged counter snapshot (e.g.
    ``net.metrics`` or ``backend.counters.snapshot``); heartbeats carry
    the nonzero deltas since the previous beat plus a device-time share.
    ``stall_report_fn`` (e.g. ``lambda: why_stalled(net)``) is invoked
    once per stall episode; progress re-arms the detector.  A traffic
    driver's fields (mempool depth, commit p99, committed and dropped
    transactions, the controller's B and SLO compliance) ride ``tick``'s
    keyword extras.  ``shard_stats_fn`` (a sharded backend's
    ``shard_stats``) contributes the cumulative ``shard_imbalance`` ratio
    (max/mean per-device dispatches; 1.0 = balanced) and the per-device
    dispatch tallies to every heartbeat.  The reference's ``gate_fn`` (no
    caller in either package) is left out.
    """

    def __init__(
        self,
        interval_s: float = 60.0,
        stall_timeout_s: float = 0.0,
        counters_fn: Optional[Callable[[], Dict[str, float]]] = None,
        stall_report_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        sink: Callable[[Dict[str, Any]], None] = _print_sink,
        clock: Callable[[], float] = time.monotonic,
        shard_stats_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> None:
        self.interval_s = interval_s
        self.shard_stats_fn = shard_stats_fn
        self.stall_timeout_s = stall_timeout_s
        self.counters_fn = counters_fn
        self.stall_report_fn = stall_report_fn
        self.sink = sink
        self.clock = clock
        t = clock()
        self._t_start = t
        self._t_beat = t
        self._t_progress = t
        self._last_progress: Any = None
        self._last_counters: Dict[str, float] = (
            dict(counters_fn()) if counters_fn else {}
        )
        self._last_msgs: Optional[float] = None
        self._seq = 0
        self.stalled = False
        self.beats: List[Dict[str, Any]] = []

    def report_quiesced(
        self, epoch: Optional[int] = None, msgs: Optional[float] = None
    ) -> Dict[str, Any]:
        """Emit a stall record UNCONDITIONALLY — for drivers that detect
        quiescence-before-completion themselves (the event loop drained
        with the run unfinished, so no further :meth:`tick` will ever
        observe the timeout).  This is exactly the quiesced-but-unfinished
        state :func:`why_stalled` introspects."""
        now = self.clock()
        record: Dict[str, Any] = {
            "stall": True,
            "quiesced": True,
            "seconds_without_progress": round(now - self._t_progress, 1),
            "epoch": epoch,
            "msgs": msgs,
        }
        if self.stall_report_fn is not None:
            record["why"] = self.stall_report_fn()
        self.stalled = True
        self.sink(record)
        return record

    def tick(
        self,
        epoch: Optional[int] = None,
        msgs: Optional[float] = None,
        faults: Optional[int] = None,
        **extra: Any,
    ) -> Optional[Dict[str, Any]]:
        """Report progress; emits a heartbeat/stall record when due.

        Progress — for stall purposes — is the EPOCH (the run's externally
        visible output), falling back to ``msgs`` only when no epoch is
        supplied.  Counting delivered messages as progress would make the
        detector inert in a livelock: the object engine's crank loop
        delivers messages between any two ticks, so ``msgs`` always moves
        even when no epoch ever completes — exactly the state a soak run
        needs reported."""
        now = self.clock()
        progress = epoch if epoch is not None else msgs
        if progress != self._last_progress:
            self._last_progress = progress
            self._t_progress = now
            self.stalled = False
        if (
            self.stall_timeout_s
            and not self.stalled
            and now - self._t_progress >= self.stall_timeout_s
        ):
            self.stalled = True
            record: Dict[str, Any] = {
                "stall": True,
                "seconds_without_progress": round(now - self._t_progress, 1),
                "epoch": epoch,
                "msgs": msgs,
            }
            if self.stall_report_fn is not None:
                record["why"] = self.stall_report_fn()
            self.sink(record)
            return record
        if now - self._t_beat < self.interval_s:
            return None
        dt = now - self._t_beat
        self._t_beat = now
        self._seq += 1
        beat: Dict[str, Any] = {
            "heartbeat": self._seq,
            "uptime_s": round(now - self._t_start, 1),
            "epoch": epoch,
            "msgs": msgs,
            "faults": faults,
        }
        if msgs is not None and self._last_msgs is not None and dt > 0:
            beat["msgs_per_s"] = round((msgs - self._last_msgs) / dt, 1)
        self._last_msgs = msgs
        if self.counters_fn is not None:
            cur = dict(self.counters_fn())
            delta = {
                k: round(cur[k] - self._last_counters.get(k, 0), 4)
                for k in cur
                if cur[k] != self._last_counters.get(k, 0)
            }
            self._last_counters = cur
            beat["counters_delta"] = delta
            if dt > 0:
                # NOTE: under pipelined dispatch (ops/pipeline.py) the
                # per-dispatch [dispatch, fetch] intervals overlap, so
                # device_share may legitimately exceed 1.0 — it reads as
                # "device dispatch wall including overlapped assembly".
                beat["device_share"] = round(
                    delta.get("device_seconds", 0.0) / dt, 4
                )
                host = delta.get("host_assembly_seconds", 0.0)
                if host:
                    beat["host_assembly_share"] = round(host / dt, 4)
                ovl = delta.get("overlap_seconds", 0.0)
                dev = delta.get("device_seconds", 0.0)
                if ovl and dev > 0:
                    beat["overlap_fraction"] = round(ovl / dev, 4)
        if self.shard_stats_fn is not None:
            try:
                st = self.shard_stats_fn()
            except Exception:  # a heartbeat must never raise on a hook
                st = None
            if st:
                beat["shard_imbalance"] = st.get("shard_imbalance")
                beat["shard_dispatches"] = st.get("shard_dispatches")
        beat.update(extra)
        self.beats.append(beat)
        self.sink(beat)
        return beat
