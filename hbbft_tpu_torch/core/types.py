"""Core state-machine contracts.

Device-native rebuild of the reference's trait core (hbbft `src/traits.rs`,
`src/lib.rs` §, unverified — see SURVEY.md provenance note): the universal
sans-I/O contract every protocol speaks.  A protocol is a deterministic state
machine; feeding it input or a message yields a :class:`Step` carrying outputs,
outgoing targeted messages, and a fault log.  No I/O, no threads, no clocks.

Design deltas vs the reference (deliberate, device-first):

* ``Step`` may also carry *deferred crypto work items* (``CryptoWork``) so the
  runtime can batch BLS pairing checks / Lagrange combines across every node
  and protocol instance into one device dispatch per crank round, instead of
  verifying each share synchronously inside ``handle_message``.  The reference
  verifies inline; on a device per-share dispatch would be ruinous (SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, Hashable, Iterable, Optional, TypeVar

from hbbft_tpu_torch.core.fault_log import Fault, FaultLog

NodeId = TypeVar("NodeId", bound=Hashable)
M = TypeVar("M")  # message payload type


# ---------------------------------------------------------------------------
# Target — who an outgoing message is addressed to.
# Mirrors hbbft `Target::{All, Nodes, AllExcept, Node}` (src/traits.rs §).
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Target(Generic[NodeId]):
    """Routing directive for an outgoing message.

    Exactly one of the four forms:

    * ``Target.all()``            — every other node.
    * ``Target.node(id)``         — a single node.
    * ``Target.nodes(ids)``       — an explicit set of nodes.
    * ``Target.all_except(ids)``  — everyone except the given set.
    """

    kind: str  # "all" | "node" | "nodes" | "all_except"
    ids: frozenset = frozenset()

    @staticmethod
    def all() -> "Target":
        return _TARGET_ALL

    @staticmethod
    def node(node_id) -> "Target":
        # Memoized: Target.node(peer) is built once per message *delivery*
        # (hot in SenderQueue routing); targets are frozen so sharing is safe.
        try:
            return _node_target(node_id)
        except TypeError:  # unhashable id — cannot memoize
            return Target("node", frozenset([node_id]))

    @staticmethod
    def nodes(node_ids: Iterable) -> "Target":
        return Target("nodes", frozenset(node_ids))

    @staticmethod
    def all_except(node_ids: Iterable) -> "Target":
        return Target("all_except", frozenset(node_ids))

    def recipients(self, all_ids: Iterable, our_id=None) -> list:
        """Expand to the concrete recipient list: members of ``all_ids``
        only, always excluding ``our_id`` (uniform across all four kinds)."""
        if self.kind == "all":
            return [n for n in all_ids if n != our_id]
        if self.kind in ("node", "nodes"):
            return [n for n in all_ids if n in self.ids and n != our_id]
        return [n for n in all_ids if n not in self.ids and n != our_id]

    def contains(self, node_id, our_id=None) -> bool:
        if self.kind == "all":
            return node_id != our_id
        if self.kind in ("node", "nodes"):
            return node_id in self.ids
        return node_id not in self.ids and node_id != our_id


_TARGET_ALL = Target("all")


@functools.lru_cache(maxsize=4096)
def _node_target(node_id) -> "Target":
    return Target("node", frozenset([node_id]))


@dataclass(frozen=True, slots=True)
class TargetedMessage(Generic[M, NodeId]):
    """An outgoing message with its routing target (hbbft `TargetedMessage` §)."""

    target: Target
    message: Any

    def map(self, f: Callable[[Any], Any]) -> "TargetedMessage":
        return TargetedMessage(self.target, f(self.message))


@dataclass(frozen=True, slots=True)
class SourcedMessage(Generic[M, NodeId]):
    """An inbound message tagged with its sender (hbbft `SourcedMessage` §)."""

    sender: Any
    message: Any


# ---------------------------------------------------------------------------
# Deferred crypto work items (device-first addition; no reference equivalent).
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class CryptoWork:
    """A crypto check/combine deferred to the round-barrier device batch.

    ``kind`` selects the batched kernel (e.g. ``"verify_sig_share"``,
    ``"verify_dec_share"``).  ``payload`` is kernel-specific.  ``on_result``
    re-enters the protocol state machine with the boolean/array result and
    returns a follow-up :class:`Step` (possibly with more work).
    """

    kind: str
    payload: Any
    on_result: Callable[[Any], "Step"]
    owner: Any = None  # node id; stamped by the runtime when the Step surfaces


# ---------------------------------------------------------------------------
# Step — the universal return value of every state-machine transition.
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class Step(Generic[NodeId]):
    """Result of one state-machine transition (hbbft `Step` §).

    ``output``    — values this protocol has irrevocably decided/delivered.
    ``messages``  — outgoing :class:`TargetedMessage`\\ s for the embedder.
    ``fault_log`` — evidence of provably faulty peer behaviour.
    ``work``      — deferred device crypto (device-first extension).
    """

    output: list = field(default_factory=list)
    messages: list = field(default_factory=list)
    fault_log: FaultLog = field(default_factory=FaultLog)
    work: list = field(default_factory=list)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_output(*outputs) -> "Step":
        return Step(output=list(outputs))

    @staticmethod
    def from_msg(target: Target, message) -> "Step":
        return Step(messages=[TargetedMessage(target, message)])

    @staticmethod
    def from_fault(node_id, kind: str) -> "Step":
        return Step(fault_log=FaultLog([Fault(node_id, kind)]))

    # -- combinators --------------------------------------------------------

    def extend(self, other: "Step") -> "Step":
        """Absorb ``other`` into ``self`` (hbbft `Step::extend` §)."""
        if not other:
            return self  # most child steps are empty; skip 4 list ops
        self.output.extend(other.output)
        self.messages.extend(other.messages)
        self.fault_log.extend(other.fault_log)
        self.work.extend(other.work)
        return self

    def join(self, other: "Step") -> "Step":
        return self.extend(other)

    def extend_with(self, other: "Step", f: Callable[[Any], Any]) -> "Step":
        """Absorb ``other``, mapping its messages through ``f``.

        This is how nested protocols wrap inner messages into their own
        envelope (hbbft `Step::extend_with`/`map` §).
        """
        self.output.extend(other.output)
        self.messages.extend(tm.map(f) for tm in other.messages)
        self.fault_log.extend(other.fault_log)
        self.work.extend(other.work)
        return self

    def map_messages(self, f: Callable[[Any], Any]) -> "Step":
        return Step(
            output=list(self.output),
            messages=[tm.map(f) for tm in self.messages],
            fault_log=FaultLog(list(self.fault_log.entries)),
            work=list(self.work),
        )

    def with_output(self, *outputs) -> "Step":
        self.output.extend(outputs)
        return self

    def add_fault(self, node_id, kind: str) -> "Step":
        self.fault_log.append(Fault(node_id, kind))
        return self

    def defer(self, work: CryptoWork) -> "Step":
        self.work.append(work)
        return self

    def __bool__(self) -> bool:
        # Hot (hundreds of thousands of calls per simulated epoch): read
        # fault_log.entries directly to skip a FaultLog.__bool__ dispatch.
        return bool(
            self.messages or self.output or self.work or self.fault_log.entries
        )


def absorb_child_step(
    child_step: "Step",
    wrap_msg: Callable[[Any], Any],
    on_output: Callable[[Any], "Step"],
) -> "Step":
    """Lift a sub-protocol's Step into its parent's message/output space.

    The reference does this with `Step::extend_with`/`map` per nesting level
    (QHB ⊃ DHB ⊃ HB ⊃ Subset ⊃ {Broadcast | BA ⊃ Coin} — SURVEY.md §1).
    The batching twist: deferred :class:`CryptoWork` callbacks inside the child
    step are *re-wrapped recursively*, so when the runtime resolves a batched
    pairing check the follow-up step re-enters through every parent layer —
    outputs keep triggering parent logic and messages keep getting enveloped.

    ``wrap_msg``  — child message -> parent message envelope.
    ``on_output`` — child output -> parent Step (parent's reaction).
    """
    if not child_step:
        return Step()
    step = Step(messages=[tm.map(wrap_msg) for tm in child_step.messages])
    step.fault_log.extend(child_step.fault_log)
    for work in child_step.work:
        step.work.append(
            CryptoWork(
                kind=work.kind,
                payload=work.payload,
                on_result=(
                    lambda res, _cb=work.on_result: absorb_child_step(
                        _cb(res), wrap_msg, on_output
                    )
                ),
                owner=work.owner,
            )
        )
    for out in child_step.output:
        step.extend(on_output(out))
    return step


# The reference's `Epoched` trait (SURVEY.md §2.1) has no class here: epoch
# extraction is structural — SenderQueue reads the epoch coordinate off
# message dataclasses directly (sender_queue._default_msg_epoch), which is
# the idiomatic-Python equivalent of the trait bound.
