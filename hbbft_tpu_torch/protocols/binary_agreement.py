"""BinaryAgreement — randomized asynchronous binary Byzantine consensus.

Rebuild of `src/binary_agreement/{binary_agreement,...}.rs` § (SURVEY.md
§2.1): the Mostéfaoui–Moumen–Raynal (PODC 2014) algorithm as realized in
hbbft — per round: SBV broadcast (BVal/Aux), a Conf phase, then a common
coin; decide when the singleton candidate matches the coin.  Early rounds
use a fixed coin schedule (round % 3: true, false, then a real threshold
coin — *(uncertain exact reference schedule — SURVEY.md §2.1)*), so crypto
is only paid every third round while an adaptive adversary still cannot
stall the protocol.

Decision broadcasts a ``Term(b)`` message; ``Term`` doubles as BVal+Aux+Conf
for all later rounds, and f+1 matching Terms decide immediately.

Coin shares ride the deferred-verification path (see threshold_sign.py):
the inner ThresholdSign's pairing checks surface through
:func:`~hbbft_tpu_torch.core.types.absorb_child_step`, so one crank round's coin
shares across *all* concurrent BA instances batch into one device call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import Step, Target, TargetedMessage, absorb_child_step
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.keys import Signature
from hbbft_tpu_torch.obs import critpath as _critpath
from hbbft_tpu_torch.protocols.bool_set import BoolMultimap, BoolSet
from hbbft_tpu_torch.protocols.sbv_broadcast import SbvBroadcast, SbvMessage
from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSign, ThresholdSignMessage
from hbbft_tpu_torch.utils.canonical import encode as canonical_encode

# Don't queue messages absurdly far in the future (memory-bound + fault evidence).
MAX_FUTURE_ROUNDS = 1000


@dataclass(frozen=True, slots=True)
class BaMessage:
    """Round-tagged BA wire message.

    kind ∈ {"sbv", "conf", "coin", "term"}; payload is the inner message
    (SbvMessage | BoolSet | ThresholdSignMessage | bool).
    """

    round: int
    kind: str
    payload: Any

    @staticmethod
    def sbv(r: int, m: SbvMessage) -> "BaMessage":
        return BaMessage(r, "sbv", m)

    @staticmethod
    def conf(r: int, vals: BoolSet) -> "BaMessage":
        return BaMessage(r, "conf", vals)

    @staticmethod
    def coin(r: int, m: ThresholdSignMessage) -> "BaMessage":
        return BaMessage(r, "coin", m)

    @staticmethod
    def term(r: int, b: bool) -> "BaMessage":
        return BaMessage(r, "term", b)


class BinaryAgreement(ConsensusProtocol):
    """One binary-consensus instance, identified by a session id.

    ``session_id`` must be globally unique per instance and identical on all
    nodes (it salts the coin document); Subset uses (subset-session,
    proposer-index).
    """

    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        session_id: bytes,
        instance: Optional[int] = None,
    ) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.session_id = session_id
        # Proposer index when this BA sits inside a Subset (critical-path
        # attribution label); standalone BAs leave it None.
        self.instance = instance
        self.round = 0
        self.sbv = SbvBroadcast(netinfo)
        self.received_conf: Dict[Any, BoolSet] = {}
        self.sent_conf: Optional[BoolSet] = None
        self.conf_values: Optional[BoolSet] = None  # our SBV output this round
        self.estimate: Optional[bool] = None
        self.decision: Optional[bool] = None
        self.received_term = BoolMultimap()
        self._sent_term = False
        self._coin: Optional[ThresholdSign] = None
        self._coin_invoked = False
        self._coin_value: Optional[bool] = None
        self._coin_applied = False
        self._queue: Dict[int, List[Tuple[Any, BaMessage]]] = {}

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return self.decision is not None

    def handle_input(self, input: bool, rng=None) -> Step:
        return self.propose(bool(input))

    def propose(self, value: bool) -> Step:
        if self.estimate is not None or self.decision is not None:
            return Step()
        self.estimate = value
        step = self._wrap_sbv(self.sbv.handle_input(value))
        return step.extend(self._poll())

    def handle_message(self, sender_id: Any, message: BaMessage, rng=None) -> Step:
        if not isinstance(message, BaMessage):
            return Step.from_fault(sender_id, "binary_agreement:malformed_message")
        if self.netinfo.node_index(sender_id) is None:
            return Step.from_fault(sender_id, "binary_agreement:non_validator_sender")
        if not isinstance(message.round, int):
            # Unvalidated round would TypeError in the comparisons below —
            # a remote crash vector (wire decode enforces int, but locally
            # embedded adversaries can inject arbitrary objects).
            return Step.from_fault(sender_id, "binary_agreement:malformed_round")
        if message.kind == "term":
            return self._handle_term(sender_id, message)
        if self.decision is not None:
            return Step()
        r = message.round
        if r < self.round:
            return Step()  # stale round — benign under async delivery
        if r > self.round:
            if r > self.round + MAX_FUTURE_ROUNDS:
                return Step.from_fault(sender_id, "binary_agreement:far_future_round")
            self._queue.setdefault(r, []).append((sender_id, message))
            return Step()
        return self._handle_current(sender_id, message)

    # -- current-round dispatch ---------------------------------------------

    def _handle_current(self, sender_id: Any, message: BaMessage) -> Step:
        if message.kind == "sbv":
            if not isinstance(message.payload, SbvMessage):
                return Step.from_fault(sender_id, "binary_agreement:malformed_sbv")
            step = self._wrap_sbv(self.sbv.handle_message(sender_id, message.payload))
            return step.extend(self._poll())
        if message.kind == "conf":
            return self._handle_conf(sender_id, message.payload)
        if message.kind == "coin":
            return self._handle_coin_message(sender_id, message.payload)
        return Step.from_fault(sender_id, "binary_agreement:unknown_kind")

    # -- SBV phase -----------------------------------------------------------

    def _wrap_sbv(self, sbv_step: Step) -> Step:
        r = self.round
        return absorb_child_step(
            sbv_step,
            wrap_msg=lambda m, _r=r: BaMessage.sbv(_r, m),
            on_output=self._on_sbv_output,
        )

    def _on_sbv_output(self, vals: BoolSet) -> Step:
        if self.sent_conf is not None or self.decision is not None:
            return Step()
        self.sent_conf = vals
        self.conf_values = vals
        step = Step()
        step.messages.append(
            TargetedMessage(Target.all(), BaMessage.conf(self.round, vals))
        )
        step.extend(self._handle_conf(self.netinfo.our_id, vals))
        return step

    # -- Conf phase ----------------------------------------------------------

    def _handle_conf(self, sender_id: Any, vals: Any) -> Step:
        if not isinstance(vals, BoolSet) or not vals:
            return Step.from_fault(sender_id, "binary_agreement:malformed_conf")
        if sender_id in self.received_conf:
            # A Term replay pre-fills received_conf, so a conf racing its
            # own sender's Term is legal; absent a Term, two different Conf
            # values in one round are provable equivocation.
            if (
                self.received_conf[sender_id] != vals
                and sender_id not in self.received_term.senders()
            ):
                return Step.from_fault(sender_id, "binary_agreement:conflicting_conf")
            return Step()
        self.received_conf[sender_id] = vals
        return self._poll()

    def _count_conf(self) -> int:
        bv = self.sbv.bin_values
        return sum(1 for v in self.received_conf.values() if v.is_subset_of(bv))

    def _poll(self) -> Step:
        """Re-check conf-round completion (bin_values may have grown),
        invoke the coin when ready, and apply a coin value that may have
        already combined from peers' shares before our conf round finished."""
        if (
            self.decision is not None
            or self.sent_conf is None
            or self._count_conf() < self.netinfo.num_correct()
        ):
            return Step()
        step = Step()
        if not self._coin_invoked:
            self._coin_invoked = True
            fixed = self._fixed_coin()
            if fixed is not None:
                self._coin_value = fixed
            else:
                step.extend(self._wrap_coin(self._ensure_coin().sign()))
        return step.extend(self._try_apply_coin())

    # -- Coin ----------------------------------------------------------------

    def _coin_doc(self) -> bytes:
        return canonical_encode(("ba-coin", self.session_id, self.round))

    def _fixed_coin(self) -> Optional[bool]:
        """Fixed schedule for cheap early rounds; every third round flips a
        real threshold coin."""
        m = self.round % 3
        if m == 0:
            return True
        if m == 1:
            return False
        return None

    def _ensure_coin(self) -> ThresholdSign:
        if self._coin is None:
            self._coin = ThresholdSign(self.netinfo, self.backend, doc=self._coin_doc())
        return self._coin

    def _handle_coin_message(self, sender_id: Any, msg: Any) -> Step:
        if self._fixed_coin() is not None:
            return Step.from_fault(sender_id, "binary_agreement:coin_in_fixed_round")
        if not isinstance(msg, ThresholdSignMessage):
            return Step.from_fault(sender_id, "binary_agreement:malformed_coin")
        return self._wrap_coin(self._ensure_coin().handle_message(sender_id, msg))

    def _wrap_coin(self, ts_step: Step) -> Step:
        r = self.round
        return absorb_child_step(
            ts_step,
            wrap_msg=lambda m, _r=r: BaMessage.coin(_r, m),
            on_output=lambda sig, _r=r: self._on_coin_output(_r, sig),
        )

    def _on_coin_output(self, r: int, sig: Signature) -> Step:
        if r != self.round or self._coin_value is not None:
            return Step()  # late coin from a superseded round
        # The coin may combine from f+1 peers' shares before our own
        # SBV/Conf phase completes — store it and apply at conf quorum.
        self._coin_value = sig.parity()
        _critpath.stamp(
            "coin.reveal",
            node=self.netinfo.our_id,
            instance=self.instance,
            rnd=r,
            value=self._coin_value,
        )
        return self._try_apply_coin()

    def _try_apply_coin(self) -> Step:
        if (
            self.decision is not None
            or self._coin_applied
            or self._coin_value is None
            or self.conf_values is None
            or self._count_conf() < self.netinfo.num_correct()
        ):
            return Step()
        self._coin_applied = True
        coin = self._coin_value
        definite = self.conf_values.definite()
        if definite is not None:
            if definite == coin:
                return self._decide(definite)
            next_est = definite
        else:
            next_est = coin
        return self._next_round(next_est)

    # -- Term ----------------------------------------------------------------

    def _handle_term(self, sender_id: Any, message: BaMessage) -> Step:
        b = message.payload
        if not isinstance(b, bool):
            return Step.from_fault(sender_id, "binary_agreement:malformed_term")
        if sender_id in self.received_term.senders():
            return Step.from_fault(sender_id, "binary_agreement:duplicate_term")
        self.received_term.insert(b, sender_id)
        if self.decision is not None:
            return Step()
        step = Step()
        # A Term implies BVal+Aux+Conf for the current and all later rounds.
        step.extend(self._replay_term(sender_id, b))
        if len(self.received_term[b]) > self.netinfo.num_faulty():
            # f+1 Terms(b): at least one correct node decided b.
            step.extend(self._decide(b))
        return step

    def _replay_term(self, sender_id: Any, b: bool) -> Step:
        step = self._wrap_sbv(self.sbv.handle_message(sender_id, SbvMessage.bval(b)))
        step.extend(self._wrap_sbv(self.sbv.handle_message(sender_id, SbvMessage.aux(b))))
        if sender_id not in self.received_conf:
            self.received_conf[sender_id] = BoolSet.single(b)
        return step.extend(self._poll())

    # -- round transitions ---------------------------------------------------

    def _decide(self, b: bool) -> Step:
        if self.decision is not None:
            return Step()
        self.decision = b
        _critpath.stamp(
            "ba.decide",
            node=self.netinfo.our_id,
            instance=self.instance,
            rnd=self.round,
            value=b,
        )
        step = Step.from_output(b)
        if not self._sent_term:
            self._sent_term = True
            step.messages.append(
                TargetedMessage(Target.all(), BaMessage.term(self.round, b))
            )
        return step

    def _next_round(self, estimate: bool) -> Step:
        self.round += 1
        self.sbv = SbvBroadcast(self.netinfo)
        self.received_conf = {}
        self.sent_conf = None
        self.conf_values = None
        self._coin = None
        self._coin_invoked = False
        self._coin_value = None
        self._coin_applied = False
        self.estimate = estimate
        step = self._wrap_sbv(self.sbv.handle_input(estimate))
        # Replay recorded Terms into the fresh round.
        for b in (False, True):
            for sender in sorted(self.received_term[b], key=repr):
                step.extend(self._replay_term_into_round(sender, b))
        # Drain queued messages for the new round.  Route through
        # handle_message: processing may advance the round again mid-drain,
        # turning the remaining queued messages stale.
        for sender, msg in self._queue.pop(self.round, []):
            step.extend(self.handle_message(sender, msg))
        return step.extend(self._poll())

    def _replay_term_into_round(self, sender_id: Any, b: bool) -> Step:
        step = self._wrap_sbv(self.sbv.handle_message(sender_id, SbvMessage.bval(b)))
        step.extend(self._wrap_sbv(self.sbv.handle_message(sender_id, SbvMessage.aux(b))))
        self.received_conf.setdefault(sender_id, BoolSet.single(b))
        return step
