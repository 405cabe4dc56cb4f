"""Synchronized Binary-Value broadcast — BinaryAgreement's inner gadget.

Rebuild of `src/binary_agreement/sbv_broadcast.rs` § (SURVEY.md §2.1),
implementing the BV-broadcast + AUX phase of Mostéfaoui–Moumen–Raynal
(PODC 2014):

* ``BVal(b)``: on input b, multicast BVal(b).  On receiving BVal(b) from f+1
  distinct nodes, multicast BVal(b) too (if not already).  On 2f+1 distinct
  BVal(b), add b to ``bin_values``.
* ``Aux(b)``: on ``bin_values`` becoming non-empty, multicast Aux(b) for the
  first such b.  Output fires once ≥ N−f nodes sent Aux values that are all
  in ``bin_values``: the output is the set of those values.

Pure counting logic — no crypto.  One instance per BA round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.types import Step, Target, TargetedMessage
from hbbft_tpu_torch.protocols.bool_set import BoolMultimap, BoolSet


@dataclass(frozen=True, slots=True)
class SbvMessage:
    kind: str  # "bval" | "aux"
    value: bool

    @staticmethod
    def bval(b: bool) -> "SbvMessage":
        return SbvMessage("bval", b)

    @staticmethod
    def aux(b: bool) -> "SbvMessage":
        return SbvMessage("aux", b)


class SbvBroadcast:
    """One round's synchronized binary-value broadcast state machine."""

    def __init__(self, netinfo: NetworkInfo) -> None:
        self.netinfo = netinfo
        self.received_bval = BoolMultimap()
        self.sent_bval = BoolSet.none()
        # Aux is one-per-sender: keyed by sender so a Byzantine node cannot
        # count twice toward the N-f quorum by sending both values.
        self.received_aux: dict = {}
        self.sent_aux = False
        self.bin_values = BoolSet.none()
        self.output: Optional[BoolSet] = None

    def handle_input(self, b: bool) -> Step:
        return self.send_bval(b)

    def handle_message(self, sender_id: Any, msg: SbvMessage) -> Step:
        if self.netinfo.node_index(sender_id) is None:
            # Non-validators (observers) must not count toward quorums.
            return Step.from_fault(sender_id, "sbv:non_validator_sender")
        if msg.kind == "bval":
            return self._handle_bval(sender_id, msg.value)
        if msg.kind == "aux":
            return self._handle_aux(sender_id, msg.value)
        return Step.from_fault(sender_id, "sbv:malformed_message")

    # -- BVal ----------------------------------------------------------------

    def send_bval(self, b: bool) -> Step:
        if self.sent_bval.contains(b):
            return Step()
        self.sent_bval = self.sent_bval.inserted(b)
        step = Step()
        step.messages.append(TargetedMessage(Target.all(), SbvMessage.bval(b)))
        # Count our own BVal as received.
        step.extend(self._handle_bval(self.netinfo.our_id, b))
        return step

    def _handle_bval(self, sender_id: Any, b: bool) -> Step:
        # Duplicates are ignored silently: re-delivery is legal under
        # reordering, and BA's Term replay may race the sender's own BVal.
        if not self.received_bval.insert(b, sender_id):
            return Step()
        step = Step()
        count = len(self.received_bval[b])
        f = self.netinfo.num_faulty()
        if count == 2 * f + 1:
            # b is now in bin_values.
            self.bin_values = self.bin_values.inserted(b)
            if not self.sent_aux:
                self.sent_aux = True
                step.messages.append(TargetedMessage(Target.all(), SbvMessage.aux(b)))
                step.extend(self._handle_aux(self.netinfo.our_id, b))
            else:
                step.extend(self._try_output())
        elif count == f + 1:
            step.extend(self.send_bval(b))
        return step

    # -- Aux -----------------------------------------------------------------

    def _handle_aux(self, sender_id: Any, b: bool) -> Step:
        if sender_id in self.received_aux:
            return Step()  # only the first Aux per sender counts
        self.received_aux[sender_id] = b
        return self._try_output()

    def _try_output(self) -> Step:
        if self.output is not None or not self.bin_values:
            return Step()
        # Count distinct Aux senders whose value is in bin_values.
        vals = BoolSet.none()
        count = 0
        # lint: allow[determinism] BoolSet union and counting are commutative
        for sender, b in self.received_aux.items():
            if self.bin_values.contains(b):
                vals = vals.inserted(b)
                count += 1
        if count < self.netinfo.num_correct():
            return Step()
        self.output = vals
        return Step.from_output(vals)
