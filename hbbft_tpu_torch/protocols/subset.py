"""Subset — Asynchronous Common Subset (ACS).

Rebuild of `src/subset/{subset,proposal_state}.rs` § (SURVEY.md §2.1): N
parallel Broadcast instances (one per proposer) + N BinaryAgreement instances
decide which proposals make it into the common subset.  All correct nodes
output the same set of ≥ N−f contributions.

Rules (HoneyBadgerBFT paper / reference):
* our input → our Broadcast.
* Broadcast_p delivers → input ``true`` to BA_p (if it has no input yet).
* once N−f BAs have decided ``true`` → input ``false`` to every BA without
  input yet.
* emit ``SubsetOutput.contribution(p, value)`` for every p with BA_p = true
  as soon as both the decision and the broadcast value are known; emit
  ``SubsetOutput.done()`` when all BAs have decided and every accepted
  broadcast has delivered.

This is pure composition — all crypto lives in the children and surfaces
through the shared deferred-work path, so one epoch's N broadcasts + N
agreements batch their device work together (the inter-instance parallelism
of SURVEY.md §2.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import Step, absorb_child_step
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.protocols.binary_agreement import BinaryAgreement
from hbbft_tpu_torch.protocols.broadcast import Broadcast
from hbbft_tpu_torch.utils.canonical import encode as canonical_encode


@dataclass(frozen=True, slots=True)
class SubsetMessage:
    """kind ∈ {"broadcast", "agreement"}; routed to the child for ``proposer``."""

    proposer: Any
    kind: str
    payload: Any


@dataclass(frozen=True, slots=True)
class SubsetOutput:
    """Either one accepted contribution or the final Done marker."""

    kind: str  # "contribution" | "done"
    proposer: Any = None
    value: Optional[bytes] = None

    @staticmethod
    def contribution(proposer, value: bytes) -> "SubsetOutput":
        return SubsetOutput("contribution", proposer, value)

    @staticmethod
    def done() -> "SubsetOutput":
        return SubsetOutput("done")


class _ProposalState:
    """Per-proposer pair of child instances + delivery bookkeeping
    (reference `proposal_state.rs` §)."""

    def __init__(self, broadcast: Broadcast, agreement: BinaryAgreement) -> None:
        self.broadcast = broadcast
        self.agreement = agreement
        self.value: Optional[bytes] = None
        self.decision: Optional[bool] = None
        self.ba_has_input = False
        self.emitted = False


class Subset(ConsensusProtocol):
    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        session_id: bytes,
    ) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.session_id = session_id
        self.proposals: Dict[Any, _ProposalState] = {}
        for p in netinfo.all_ids():
            ba_session = canonical_encode(
                ("subset-ba", session_id, netinfo.node_index(p))
            )
            self.proposals[p] = _ProposalState(
                Broadcast(netinfo, proposer_id=p),
                BinaryAgreement(
                    netinfo,
                    backend,
                    session_id=ba_session,
                    instance=netinfo.node_index(p),
                ),
            )
        self._false_inputs_sent = False
        self._done = False

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return self._done

    def count_accepted(self) -> int:
        return sum(1 for ps in self.proposals.values() if ps.decision is True)

    def handle_input(self, input: bytes, rng=None) -> Step:
        return self.propose(input)

    def propose(self, value: bytes) -> Step:
        ps = self.proposals[self.netinfo.our_id]
        return self._wrap_broadcast(
            self.netinfo.our_id, ps.broadcast.broadcast(bytes(value))
        )

    def handle_message(self, sender_id: Any, message: SubsetMessage, rng=None) -> Step:
        if not isinstance(message, SubsetMessage):
            return Step.from_fault(sender_id, "subset:malformed_message")
        ps = self.proposals.get(message.proposer)
        if ps is None:
            return Step.from_fault(sender_id, "subset:unknown_proposer")
        if message.kind == "broadcast":
            return self._wrap_broadcast(
                message.proposer, ps.broadcast.handle_message(sender_id, message.payload)
            )
        if message.kind == "agreement":
            return self._wrap_agreement(
                message.proposer, ps.agreement.handle_message(sender_id, message.payload)
            )
        return Step.from_fault(sender_id, "subset:unknown_kind")

    # -- child wiring --------------------------------------------------------

    def _wrap_broadcast(self, proposer, child_step: Step) -> Step:
        return absorb_child_step(
            child_step,
            wrap_msg=lambda m, _p=proposer: SubsetMessage(_p, "broadcast", m),
            on_output=lambda value, _p=proposer: self._on_broadcast_output(_p, value),
        )

    def _wrap_agreement(self, proposer, child_step: Step) -> Step:
        return absorb_child_step(
            child_step,
            wrap_msg=lambda m, _p=proposer: SubsetMessage(_p, "agreement", m),
            on_output=lambda decision, _p=proposer: self._on_ba_output(_p, decision),
        )

    def _on_broadcast_output(self, proposer, value: bytes) -> Step:
        ps = self.proposals[proposer]
        if ps.value is not None:
            return Step()
        ps.value = value
        step = Step()
        if not ps.ba_has_input and ps.decision is None:
            ps.ba_has_input = True
            step.extend(self._wrap_agreement(proposer, ps.agreement.propose(True)))
        return step.extend(self._progress())

    def _on_ba_output(self, proposer, decision: bool) -> Step:
        ps = self.proposals[proposer]
        if ps.decision is not None:
            return Step()
        ps.decision = decision
        step = Step()
        if (
            not self._false_inputs_sent
            and self.count_accepted() >= self.netinfo.num_correct()
        ):
            # Quorum of accepted proposals: vote false everywhere else so the
            # epoch terminates.
            self._false_inputs_sent = True
            for p in self.netinfo.all_ids():
                other = self.proposals[p]
                if not other.ba_has_input and other.decision is None:
                    other.ba_has_input = True
                    step.extend(
                        self._wrap_agreement(p, other.agreement.propose(False))
                    )
        return step.extend(self._progress())

    # -- output --------------------------------------------------------------

    def _progress(self) -> Step:
        if self._done:
            return Step()
        step = Step()
        for p in self.netinfo.all_ids():
            ps = self.proposals[p]
            if ps.decision is True and ps.value is not None and not ps.emitted:
                ps.emitted = True
                step.output.append(SubsetOutput.contribution(p, ps.value))
        all_decided = all(ps.decision is not None for ps in self.proposals.values())
        all_delivered = all(
            ps.value is not None
            for ps in self.proposals.values()
            if ps.decision is True
        )
        if all_decided and all_delivered:
            self._done = True
            step.output.append(SubsetOutput.done())
        return step
