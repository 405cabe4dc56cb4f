"""Stall diagnosis: the "why-stalled" protocol report.

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
``VirtualNet`` attaches it to every tripped limit.

The port's copy of the JAX package's ``obs/health.py`` without the parts
whose subsystems the port does not have yet: the crash-axis, traffic and
critical-path-gate sections of the report, the scenario label, and the
heartbeat ``HealthReporter``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


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
    """Attack/schedule identity of a VirtualNet-like runner — names the
    active adversary and the network condition so a starved instance
    reads as "partition isolates {2,3}; BA coin quorum short", not as an
    anonymous missing quorum.  Duck-typed and total: absent attributes
    simply contribute nothing."""
    ctx: Dict[str, Any] = {}
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


def why_stalled(net_or_nodes: Any) -> Dict[str, Any]:
    """Build the why-stalled report for a quiesced-but-unfinished run.

    Accepts a :class:`~hbbft_tpu_torch.net.virtual_net.VirtualNet`, an
    ``examples.simulation.Simulation``, or any ``{node_id: node}`` mapping
    whose values carry the protocol under ``.algorithm``/``.algo`` (or
    are the protocol itself).  When the runner carries an adversary or a
    schedule, the report leads with that context — a starved quorum
    under a live partition names the partition, not just the shortfall.
    """
    nodes = getattr(net_or_nodes, "nodes", net_or_nodes)
    report: Dict[str, Any] = {"nodes": {}, "summary": []}
    ctx = _scenario_context(net_or_nodes)
    if ctx is not None:
        report["scenario"] = ctx
        report["summary"].append(_scenario_summary(ctx))
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
