"""SenderQueue — epoch-aware outgoing-message buffering.

Rebuild of `src/sender_queue/` § (SURVEY.md §2.1): wraps DynamicHoneyBadger
or QueueingHoneyBadger and holds back outgoing messages addressed to peers
that have not yet reached the message's (era, epoch) — peers announce
progress with ``EpochStarted``.  This keeps a fast node from flooding a slow
peer with traffic the peer would buffer or drop (the reference's
`max_future_epochs` contract), and cleanly drops obsolete traffic to peers
that already moved past an era.

The wrapper turns ``Target.all``/``all_except`` into per-peer sends (it must
make a per-recipient decision), so it needs the peer list: validators are
taken from the wrapped algorithm's NetworkInfo; observers can be registered
with :meth:`add_peer`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import (
    CryptoWork,
    Step,
    Target,
    TargetedMessage,
    absorb_child_step,
)
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbMessage
from hbbft_tpu_torch.protocols.honey_badger import HbMessage


@dataclass(frozen=True, slots=True)
class SqMessage:
    """kind ∈ {"epoch_started", "algo"}."""

    kind: str
    payload: Any

    @staticmethod
    def epoch_started(era: int, epoch: int) -> "SqMessage":
        return SqMessage("epoch_started", (era, epoch))

    @staticmethod
    def algo(inner: Any) -> "SqMessage":
        return SqMessage("algo", inner)


def _default_our_epoch(algo) -> Tuple[int, int]:
    dhb = getattr(algo, "dhb", algo)
    if hasattr(dhb, "hb"):
        return (dhb.era, dhb.hb.epoch)
    return (0, dhb.epoch)  # bare HoneyBadger: single implicit era


def _default_msg_epoch(msg: Any) -> Tuple[int, int]:
    if isinstance(msg, DhbMessage):
        inner = msg.payload
        epoch = inner.epoch if isinstance(inner, HbMessage) else 0
        return (msg.era, epoch)
    if isinstance(msg, HbMessage):
        return (0, msg.epoch)
    return (0, 0)


class SenderQueue(ConsensusProtocol):
    def __init__(
        self,
        algo: ConsensusProtocol,
        max_future_epochs: int = 3,
        our_epoch_fn: Callable[[Any], Tuple[int, int]] = _default_our_epoch,
        msg_epoch_fn: Callable[[Any], Tuple[int, int]] = _default_msg_epoch,
        extra_peers: Tuple[Any, ...] = (),
    ) -> None:
        self.algo = algo
        self.max_future_epochs = max_future_epochs
        # lint: allow[hook-detachment] epoch extractors are protocol
        # structure, not environment: both default to module-level
        # functions, which the snapshot encoder serializes by name — a
        # restored queue must keep the same epoch extraction to stay
        # bit-identical under replay (env-dropping them would change
        # gating decisions mid-WAL)
        self.our_epoch_fn = our_epoch_fn
        # lint: allow[hook-detachment] same serialized-by-name contract as
        # our_epoch_fn above: module-level function, replay-significant
        self.msg_epoch_fn = msg_epoch_fn
        self._extra_peers = set(extra_peers)
        self.peer_epochs: Dict[Any, Tuple[int, int]] = {}
        self._outgoing: Dict[Any, List[Any]] = {}  # peer -> buffered inner msgs
        self._last_announced: Optional[Tuple[int, int]] = None
        # peers() memo: invalidated when the era's NetworkInfo object is
        # replaced or a peer set grows (both sets only ever grow).
        self._peers_cache: Optional[List[Any]] = None
        self._peers_netinfo: Any = None
        self._peers_sizes: Tuple[int, int] = (-1, -1)

    # -- peers ---------------------------------------------------------------

    def peers(self) -> List[Any]:
        netinfo = getattr(self.algo, "netinfo", None)
        sizes = (len(self._extra_peers), len(self.peer_epochs))
        if (
            self._peers_cache is not None
            and self._peers_netinfo is netinfo
            and self._peers_sizes == sizes
        ):
            return self._peers_cache
        ids = set(netinfo.all_ids()) if netinfo is not None else set()
        ids |= self._extra_peers
        ids |= set(self.peer_epochs)
        ids.discard(self.our_id())
        self._peers_cache = sorted(ids, key=repr)
        self._peers_netinfo = netinfo  # strong ref: no id-reuse staleness
        self._peers_sizes = sizes
        return self._peers_cache

    def add_peer(self, node_id) -> None:
        """Register an observer so it receives algorithm traffic."""
        self._extra_peers.add(node_id)

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.algo.our_id()

    def terminated(self) -> bool:
        return self.algo.terminated()

    def handle_input(self, input: Any, rng=None) -> Step:
        return self._post(self.algo.handle_input(input, rng=rng))

    def handle_message(self, sender_id: Any, message: SqMessage, rng=None) -> Step:
        if not isinstance(message, SqMessage):
            return Step.from_fault(sender_id, "sender_queue:malformed_message")
        if message.kind == "epoch_started":
            return self._on_epoch_started(sender_id, message.payload)
        if message.kind == "algo":
            return self._post(
                self.algo.handle_message(sender_id, message.payload, rng=rng)
            )
        return Step.from_fault(sender_id, "sender_queue:unknown_kind")

    def __getattr__(self, name):
        # Delegate protocol-specific entry points (propose, vote_for,
        # push_transaction, ...) through the queueing wrapper.
        inner = getattr(self.algo, name)
        if callable(inner):

            def call(*args, **kwargs):
                result = inner(*args, **kwargs)
                return self._post(result) if isinstance(result, Step) else result

            return call
        return inner

    # -- epoch tracking ------------------------------------------------------

    def _on_epoch_started(self, sender_id: Any, payload: Any) -> Step:
        if (
            not isinstance(payload, tuple)
            or len(payload) != 2
            or not all(isinstance(x, int) for x in payload)
        ):
            return Step.from_fault(sender_id, "sender_queue:malformed_epoch")
        cur = self.peer_epochs.get(sender_id)
        if cur is not None and payload <= cur:
            return Step()
        self.peer_epochs[sender_id] = payload
        return self._flush_peer(sender_id)

    def _flush_peer(self, peer) -> Step:
        buffered = self._outgoing.get(peer, [])
        if not buffered:
            return Step()
        keep: List[Any] = []
        step = Step()
        for msg in buffered:
            status = self._classify(peer, msg)
            if status == "send":
                step.messages.append(TargetedMessage(Target.node(peer), SqMessage.algo(msg)))
            elif status == "premature":
                keep.append(msg)
            # obsolete: drop
        self._outgoing[peer] = keep
        return step

    def _classify(self, peer, msg, era_epoch=None) -> str:
        """The single epoch-gating predicate (both the hot `_post` loop and
        buffered replay route through here).  ``era_epoch`` lets callers
        pass a precomputed ``msg_epoch_fn(msg)`` to avoid re-extracting it
        once per peer."""
        peer_epoch = self.peer_epochs.get(peer)
        if peer_epoch is None:
            # Unknown progress: optimistic send (the peer buffers future
            # epochs itself, same as an un-wrapped network).
            return "send"
        era, epoch = (
            era_epoch if era_epoch is not None else self.msg_epoch_fn(msg)
        )
        p_era, p_epoch = peer_epoch
        if era < p_era or (era == p_era and epoch < p_epoch):
            return "obsolete"
        if era > p_era or epoch > p_epoch + self.max_future_epochs:
            return "premature"
        return "send"

    # -- outgoing interception ----------------------------------------------

    def _post(self, inner_step: Step) -> Step:
        routed = Step(output=list(inner_step.output))
        routed.fault_log.extend(inner_step.fault_log)
        # Deferred-crypto follow-up steps must re-enter through _post so
        # their messages get epoch-routed too.
        for w in inner_step.work:
            routed.work.append(
                CryptoWork(
                    kind=w.kind,
                    payload=w.payload,
                    on_result=lambda res, _cb=w.on_result: self._post(_cb(res)),
                    owner=w.owner,
                )
            )
        # Inline per-peer routing (the N·messages hot loop): the envelope is
        # built once per message (frozen — shared across peers) and the
        # message's epoch is extracted lazily, once, not once per peer.
        msgs = routed.messages
        peers = self.peers()
        our = self.our_id()
        peer_epochs = self.peer_epochs
        for tm in inner_step.messages:
            m = tm.message
            envelope = SqMessage.algo(m)
            era_epoch = None
            for peer in tm.target.recipients(peers, our_id=our):
                if era_epoch is None and peer_epochs.get(peer) is not None:
                    era_epoch = self.msg_epoch_fn(m)
                status = self._classify(peer, m, era_epoch)
                if status == "send":
                    msgs.append(TargetedMessage(Target.node(peer), envelope))
                elif status == "premature":
                    self._outgoing.setdefault(peer, []).append(m)
                # obsolete: drop
        return routed.extend(self._maybe_announce())

    def _route(self, tm: TargetedMessage) -> Step:
        """Route one targeted message (the unit-testable single-message
        form of the inlined loop in :meth:`_post`)."""
        step = Step()
        for peer in tm.target.recipients(self.peers(), our_id=self.our_id()):
            status = self._classify(peer, tm.message)
            if status == "send":
                step.messages.append(
                    TargetedMessage(Target.node(peer), SqMessage.algo(tm.message))
                )
            elif status == "premature":
                self._outgoing.setdefault(peer, []).append(tm.message)
        return step

    def _maybe_announce(self) -> Step:
        cur = self.our_epoch_fn(self.algo)
        if cur == self._last_announced:
            return Step()
        self._last_announced = cur
        return Step.from_msg(Target.all(), SqMessage.epoch_started(*cur))
