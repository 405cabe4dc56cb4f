"""Adversary framework + attack library for the VirtualNet simulator.

Rebuild of `tests/net/adversary.rs` § (SURVEY.md §2.1): an adversary gets two
hooks — ``pre_crank`` (observe/reorder/inject before each delivery) and
``tamper`` (rewrite traffic originating from faulty nodes).  Used by every
protocol integration test to exercise Byzantine scheduling and corruption.

The attack library covers the concrete misbehaviors the
CCS 2016 liveness claim must survive:

* :class:`EquivocatingAdversary` — conflicting RBC ``Value``\\ s per
  recipient (provable ``broadcast:conflicting_values``),
* :class:`WithholdingAdversary` — withheld echoes/readies/threshold
  shares up to the f-boundary (crash-style liveness pressure, no
  provable evidence),
* :class:`CraftedShareAdversary` — well-typed-but-invalid threshold
  shares at a configurable contamination rate (the RLC bisection's
  worst case; ``threshold_sign:invalid_sig_share`` /
  ``threshold_decrypt:invalid_share``),
* :class:`ReplayAdversary` — duplicate floods (``broadcast:
  multiple_echos`` / ``multiple_readys`` under exactly-once delivery),
* :class:`LaggardAdversary` — one honest node lags behind, then catches
  up (the state-transfer-free catch-up path).

All entropy comes from ``net.rng`` — the run's single seeded stream — so
every attack replays bit-identically for a given seed.  Tamper hooks
never raise on unrecognized payloads: a message the attack doesn't
understand passes through untouched (the same no-crash discipline the
byzantine-input lint family enforces on protocol handlers).
"""

from __future__ import annotations

import heapq

from dataclasses import replace
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover
    from hbbft_tpu_torch.net.virtual_net import NetMessage, VirtualNet


class Adversary:
    """Default: passive (deliver in scheduler order, no tampering).

    ``scheduler_override``: adversaries whose power *is* delivery order set
    this to ``"first"`` so VirtualNet pops the queue head they arranged in
    ``pre_crank`` (the default random scheduler would erase the ordering).
    """

    scheduler_override: Optional[str] = None

    def pre_crank(self, net: "VirtualNet") -> None:
        """Called before each crank; may reorder/inject into ``net.queue``."""

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        """Rewrite a message sent by a *faulty* node.  Return the (possibly
        empty, possibly longer) list of messages to enqueue instead."""
        return [msg]

    def describe(self) -> Dict[str, Any]:
        """Attack identity for the why-stalled report (name + knobs)."""
        return {"name": type(self).__name__}


class NullAdversary(Adversary):
    pass


class NodeOrderAdversary(Adversary):
    """Delivers messages grouped by recipient id order — a scheduling game
    that starves late nodes (reference `NodeOrderAdversary` §)."""

    scheduler_override = "first"

    def pre_crank(self, net: "VirtualNet") -> None:
        if net.queue:
            net.queue.sort(key=lambda m: net.node_order_key(m.to))


class ReorderingAdversary(Adversary):
    """Randomly shuffles the pending queue every crank (seeded)."""

    scheduler_override = "first"

    def pre_crank(self, net: "VirtualNet") -> None:
        net.rng.shuffle(net.queue)


class SilentAdversary(Adversary):
    """Faulty nodes never send anything (crash-style faults)."""

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        return []


class RandomAdversary(Adversary):
    """Replaces faulty nodes' traffic with random well-typed messages.

    ``generator(net, msg)`` produces a replacement payload; with probability
    ``p_replace`` the original message is swapped, otherwise passed through.
    (Reference `RandomAdversary` § generates random well-typed messages via
    proptest strategies; here the per-protocol test supplies the generator.)
    """

    def __init__(
        self,
        generator: Callable[["VirtualNet", "NetMessage"], object],
        p_replace: float = 0.5,
        p_drop: float = 0.0,
    ) -> None:
        # lint: allow[hook-detachment] the generator is adversary structure,
        # not environment: snapshot-bearing runs supply module-level
        # generator functions (serialized by name), and env-dropping it
        # would turn a restored RandomAdversary into a silent pass-through
        self.generator = generator
        self.p_replace = p_replace
        self.p_drop = p_drop

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        from hbbft_tpu_torch.net.virtual_net import NetMessage

        roll = net.rng.random()
        if roll < self.p_drop:
            return []
        if roll < self.p_drop + self.p_replace:
            payload = self.generator(net, msg)
            if payload is None:
                return []
            return [NetMessage(msg.sender, msg.to, payload)]
        return [msg]

    def describe(self) -> Dict[str, Any]:
        return {
            "name": type(self).__name__,
            "p_replace": self.p_replace,
            "p_drop": self.p_drop,
        }


# ---------------------------------------------------------------------------
# Message surgery: the protocol stack wraps Broadcast/BA/share messages in
# Subset/HB/DHB envelopes; an attack on the innermost message rebuilds the
# envelope chain around the tampered payload.
# ---------------------------------------------------------------------------


def locate_inner(
    payload: Any, match: Callable[[Any], bool]
) -> Tuple[Any, Optional[Callable[[Any], Any]]]:
    """Find the innermost sub-message satisfying ``match`` inside the
    envelope chain DHB ⊃ HB ⊃ Subset ⊃ {Broadcast | BA ⊃ Coin}.

    Returns ``(inner, rebuild)`` where ``rebuild(new_inner)`` produces the
    whole payload with only the matched message replaced, or
    ``(None, None)`` when nothing matches — the caller passes the message
    through untouched (tamper hooks never raise on unknown shapes).

    The port has the HB, Subset and BA envelopes; the reference's DHB and
    SenderQueue arms (``DhbMessage``, ``SqMessage`` with kind ``"algo"``)
    come with those protocols.  No message of either class exists here
    before then, so every payload is classified as the reference's is."""
    from hbbft_tpu_torch.protocols.binary_agreement import BaMessage
    from hbbft_tpu_torch.protocols.honey_badger import HbMessage
    from hbbft_tpu_torch.protocols.subset import SubsetMessage

    if match(payload):
        return payload, lambda m: m
    descend = (
        isinstance(payload, SubsetMessage)
        or (isinstance(payload, HbMessage) and payload.kind in ("subset", "dec_share"))
        or (isinstance(payload, BaMessage) and payload.kind == "coin")
    )
    if descend:
        inner, rebuild = locate_inner(payload.payload, match)
        if inner is not None:
            return inner, lambda m, rb=rebuild: replace(payload, payload=rb(m))
    return None, None


def classify_inner(payload: Any) -> Optional[str]:
    """Traffic class of the innermost protocol message: one of
    ``{"value", "echo", "ready", "sig_share", "dec_share"}`` or None."""
    from hbbft_tpu_torch.protocols.broadcast import BroadcastMessage
    from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecryptMessage
    from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSignMessage

    def interesting(m: Any) -> bool:
        return isinstance(
            m, (BroadcastMessage, ThresholdSignMessage, ThresholdDecryptMessage)
        )

    inner, _ = locate_inner(payload, interesting)
    if inner is None:
        return None
    if isinstance(inner, BroadcastMessage):
        return inner.kind if inner.kind in ("value", "echo", "ready") else None
    if isinstance(inner, ThresholdSignMessage):
        return "sig_share"
    return "dec_share"


# ---------------------------------------------------------------------------
# Attack library
# ---------------------------------------------------------------------------


class EquivocatingAdversary(Adversary):
    """Faulty proposers equivocate: every recipient of an RBC ``Value``
    additionally receives a *conflicting* ``Value`` for its own shard
    index, committed to an alternative Merkle root.  Under exactly-once
    delivery the second Value is provable proposer misbehaviour —
    ``broadcast:conflicting_values`` — and the honest majority still
    terminates (the losing root never reaches an Echo quorum that the
    winning root's totality argument doesn't subsume)."""

    def __init__(self, alt_value: bytes = b"equivocated contribution") -> None:
        self.alt_value = alt_value
        self._alt_trees: Dict[Tuple[Any, int], Any] = {}

    def _alt_tree(self, sender: Any, n: int):
        from hbbft_tpu_torch.crypto.erasure import rs_codec
        from hbbft_tpu_torch.crypto.merkle import MerkleTree

        key = (sender, n)
        tree = self._alt_trees.get(key)
        if tree is None:
            f = (n - 1) // 3
            value = self.alt_value + b"/" + repr(sender).encode()
            framed = len(value).to_bytes(4, "big") + value
            shards = rs_codec(n - 2 * f, 2 * f).encode(framed)
            tree = MerkleTree(shards)
            self._alt_trees[key] = tree
        return tree

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        from hbbft_tpu_torch.net.virtual_net import NetMessage
        from hbbft_tpu_torch.protocols.broadcast import BroadcastMessage

        inner, rebuild = locate_inner(
            msg.payload,
            lambda m: isinstance(m, BroadcastMessage) and m.kind == "value",
        )
        if inner is None:
            return [msg]
        n = len(net.nodes)
        idx = net.node_order_key(msg.to)
        if idx >= n:  # recipient outside the modelled id set
            return [msg]
        alt_proof = self._alt_tree(msg.sender, n).proof(idx)
        alt = rebuild(BroadcastMessage.value(alt_proof))
        return [msg, NetMessage(msg.sender, msg.to, alt)]

    def describe(self) -> Dict[str, Any]:
        return {"name": type(self).__name__, "alt_value": repr(self.alt_value)}


class WithholdingAdversary(Adversary):
    """Faulty nodes withhold selected traffic classes — echoes, readys,
    threshold shares — in full or at a seeded ``fraction``.  Withholding
    is not provable misbehaviour (no fault expected); the honest N−f must
    carry every quorum, which sizes the attack exactly to the f-boundary
    (the tamper hook only ever fires for faulty senders)."""

    def __init__(
        self,
        kinds: Tuple[str, ...] = ("echo", "ready", "sig_share", "dec_share"),
        fraction: float = 1.0,
    ) -> None:
        self.kinds = tuple(kinds)
        self.fraction = fraction

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        if classify_inner(msg.payload) not in self.kinds:
            return [msg]
        if self.fraction < 1.0 and net.rng.random() >= self.fraction:
            return [msg]
        return []

    def describe(self) -> Dict[str, Any]:
        return {
            "name": type(self).__name__,
            "kinds": list(self.kinds),
            "fraction": self.fraction,
        }


class CraftedShareAdversary(Adversary):
    """Faulty nodes replace outgoing threshold shares with *well-typed*
    garbage group elements at a configurable contamination ``rate``
    (drawn per message copy from ``net.rng``).  This is the RLC
    bisection's adversarial shape: every crafted share must be rejected,
    attributed (``threshold_sign:invalid_sig_share`` /
    ``threshold_decrypt:invalid_share``), and must never reach a
    combine."""

    def __init__(
        self,
        rate: float = 1.0,
        kinds: Tuple[str, ...] = ("sig_share", "dec_share"),
    ) -> None:
        self.rate = rate
        self.kinds = tuple(kinds)

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        from hbbft_tpu_torch.crypto.keys import DecryptionShare, SignatureShare
        from hbbft_tpu_torch.net.virtual_net import NetMessage
        from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecryptMessage
        from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSignMessage

        wanted = []
        if "sig_share" in self.kinds:
            wanted.append(ThresholdSignMessage)
        if "dec_share" in self.kinds:
            wanted.append(ThresholdDecryptMessage)
        inner, rebuild = locate_inner(
            msg.payload, lambda m: isinstance(m, tuple(wanted))
        )
        if inner is None:
            return [msg]
        if self.rate < 1.0 and net.rng.random() >= self.rate:
            return [msg]
        group = net.backend.group
        r = net.rng.randrange(1, 1 << 64)
        if isinstance(inner, ThresholdSignMessage):
            crafted: Any = ThresholdSignMessage(
                SignatureShare(group, group.g2_mul(r, group.g2()))
            )
        else:
            crafted = ThresholdDecryptMessage(
                DecryptionShare(group, group.g1_mul(r, group.g1()))
            )
        return [NetMessage(msg.sender, msg.to, rebuild(crafted))]

    def describe(self) -> Dict[str, Any]:
        return {
            "name": type(self).__name__,
            "rate": self.rate,
            "kinds": list(self.kinds),
        }


class ReplayAdversary(Adversary):
    """Duplicate flood: every message a faulty node sends is enqueued
    ``copies`` times.  Under the simulator's exactly-once delivery a
    re-sent Echo/Ready is provable (``broadcast:multiple_echos`` /
    ``multiple_readys``); share re-sends are legal and must be absorbed
    silently — the flood tests both paths plus queue pressure."""

    def __init__(self, copies: int = 3) -> None:
        if copies < 2:
            raise ValueError("ReplayAdversary needs copies >= 2")
        self.copies = copies

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        from hbbft_tpu_torch.net.virtual_net import NetMessage

        return [msg] + [
            NetMessage(msg.sender, msg.to, msg.payload)
            for _ in range(self.copies - 1)
        ]

    def describe(self) -> Dict[str, Any]:
        return {"name": type(self).__name__, "copies": self.copies}


class LaggardAdversary(Adversary):
    """One *honest* node lags behind: traffic addressed to it is held in
    a side buffer until ``lag_cranks`` deliveries elapsed (or the rest of
    the network would starve without it), then released all at once — the
    lag-behind-then-catch-up path that exercises future-epoch buffering
    and quorum progress at N−1 live nodes.  The laggard defaults to the
    highest-id honest node (deterministic for a given seed)."""

    def __init__(self, lag_cranks: int = 400, node_id: Any = None) -> None:
        self.lag_cranks = lag_cranks
        self.node_id = node_id
        self._held: List["NetMessage"] = []
        self._released = False

    def laggard(self, net: "VirtualNet") -> Any:
        if self.node_id is None:
            honest = [n.id for n in net.correct_nodes()]
            if honest:
                self.node_id = max(honest, key=net.node_order_key)
        return self.node_id

    def pre_crank(self, net: "VirtualNet") -> None:
        lid = self.laggard(net)
        if lid is None or self._released:
            return
        held = [m for m in net.queue if m.to == lid]
        if held:
            net.queue[:] = [m for m in net.queue if m.to != lid]
            self._held.extend(held)
        # The hold must also sweep the schedule layer's future-dated
        # heap: crank() fast-forwards the virtual clock AFTER pre_crank
        # when the live queue drains, so a laggard-bound message left on
        # the heap could be released and delivered mid-lag.  Entries are
        # (not_before, seq, msg) with unique seq, so sorting never
        # compares messages.
        fut = getattr(net, "_future", None)
        if fut and any(e[2].to == lid for e in fut):
            fut_held = sorted(e for e in fut if e[2].to == lid)
            fut[:] = [e for e in fut if e[2].to != lid]
            heapq.heapify(fut)
            self._held.extend(e[2] for e in fut_held)
        # Starvation check covers the future heap too: with the laggard's
        # traffic held, remaining future messages mean the net
        # fast-forwards rather than starving, so the lag must hold —
        # releasing on a momentarily empty live queue would degenerate
        # the attack under any latency schedule.
        starved = not net.queue and not getattr(net, "_future", None)
        if self._held and (net.cranks >= self.lag_cranks or starved):
            net.queue.extend(self._held)
            self._held.clear()
            self._released = True

    def describe(self) -> Dict[str, Any]:
        return {
            "name": type(self).__name__,
            "laggard": repr(self.node_id),
            "lag_cranks": self.lag_cranks,
            "released": self._released,
            "held": len(self._held),
        }
