"""DynamicHoneyBadger — HoneyBadger with dynamic validator membership.

Rebuild of `src/dynamic_honey_badger/` § (SURVEY.md §2.1, §3.4): validators
cast signed votes for `Change`s (add/remove a validator, or switch the
encryption schedule); votes ride inside committed contributions so every
node tallies them identically.  A strict-majority winner triggers an
in-band `SyncKeyGen` among the *new* validator set, whose Part/Ack messages
also ride (signed) inside contributions; when the DKG completes, the era
ends: a fresh `NetworkInfo` (new master key, new shares) and a fresh
`HoneyBadger` start, and the batch reports ``ChangeState.complete``.

A joining node starts from a serializable `JoinPlan` as an *observer*: it
follows all traffic (combining broadcast shares without contributing),
passively receives its DKG row values from committed Acks (each Ack carries
an encrypted value slot for every member of the next era, including the
joiner), and becomes a validator when the era turns over.

All per-node signatures committed in one batch are verified through a
single batched backend call — on the device backend this joins the same
per-round dispatch as the pairing checks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import Step, absorb_child_step
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.keys import PublicKey, PublicKeySet, Signature
from hbbft_tpu_torch.protocols.change import Change, ChangeState
from hbbft_tpu_torch.protocols.honey_badger import (
    Batch as HbBatch,
    EncryptionSchedule,
    HoneyBadger,
)
from hbbft_tpu_torch.protocols.sync_key_gen import (
    Ack,
    Part,
    SyncKeyGen,
    ack_from_canonical,
    ack_to_canonical,
    part_from_canonical,
    part_to_canonical,
)
from hbbft_tpu_torch.protocols.votes import SignedVote, VoteCounter
from hbbft_tpu_torch.utils import canonical


@dataclass(frozen=True, slots=True)
class DhbMessage:
    era: int
    payload: Any  # HbMessage


@dataclass(slots=True)
class DhbBatch:
    """One committed epoch: user contributions + membership-change state."""

    era: int
    epoch: int
    contributions: Dict[Any, Any]
    change: ChangeState

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DhbBatch)
            and (self.era, self.epoch) == (other.era, other.epoch)
            and self.contributions == other.contributions
            and self.change == other.change
        )


@dataclass(frozen=True, slots=True)
class JoinPlan:
    """Everything a joining observer needs to follow era ``era``
    (reference `JoinPlan` §)."""

    era: int
    pub_key_set_bytes: bytes
    pub_keys: Tuple[Tuple[Any, bytes], ...]  # sorted (node_id, pk_bytes)
    encryption_schedule: EncryptionSchedule


class _KeyGenState:
    def __init__(
        self,
        change: Change,
        keygen: SyncKeyGen,
        pub_keys: Dict[Any, PublicKey],
    ) -> None:
        self.change = change
        self.keygen = keygen
        self.pub_keys = pub_keys


class DynamicHoneyBadgerBuilder:
    """Builder mirroring the reference `DynamicHoneyBadgerBuilder` §."""

    def __init__(self, netinfo: NetworkInfo, backend: CryptoBackend, rng) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.rng = rng
        self._max_future_epochs = 3
        self._encryption_schedule = EncryptionSchedule.always()
        self._session_id = b"dhb"

    def max_future_epochs(self, n: int) -> "DynamicHoneyBadgerBuilder":
        self._max_future_epochs = n
        return self

    def encryption_schedule(self, s: EncryptionSchedule) -> "DynamicHoneyBadgerBuilder":
        self._encryption_schedule = s
        return self

    def session_id(self, sid: bytes) -> "DynamicHoneyBadgerBuilder":
        self._session_id = sid
        return self

    def build(self) -> "DynamicHoneyBadger":
        return DynamicHoneyBadger(
            self.netinfo,
            self.backend,
            rng=self.rng,
            session_id=self._session_id,
            max_future_epochs=self._max_future_epochs,
            encryption_schedule=self._encryption_schedule,
        )


class DynamicHoneyBadger(ConsensusProtocol):
    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        rng,
        session_id: bytes = b"dhb",
        max_future_epochs: int = 3,
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        era: int = 0,
    ) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.rng = rng
        self.session_id = session_id
        self.max_future_epochs = max_future_epochs
        self.encryption_schedule = encryption_schedule
        self.era = era
        self.hb = self._new_hb()
        self.vote_counter = VoteCounter(self.era, netinfo.num_nodes())
        self._vote_num = 0
        self._pending_votes: List[SignedVote] = []
        self._pending_kg: List[Tuple[Tuple, bytes]] = []  # (msg_canonical, sig)
        self.key_gen: Optional[_KeyGenState] = None
        self._future_era: List[Tuple[Any, DhbMessage]] = []

    # -- construction helpers ------------------------------------------------

    def _new_hb(self) -> HoneyBadger:
        sid = canonical.encode(("dhb-era", self.session_id, self.era))
        return HoneyBadger(
            self.netinfo,
            self.backend,
            session_id=sid,
            max_future_epochs=self.max_future_epochs,
            encryption_schedule=self.encryption_schedule,
        )

    @staticmethod
    def builder(netinfo, backend, rng) -> DynamicHoneyBadgerBuilder:
        return DynamicHoneyBadgerBuilder(netinfo, backend, rng)

    @staticmethod
    def new_joining(
        our_id: Any,
        secret_key,
        join_plan: JoinPlan,
        backend: CryptoBackend,
        rng,
        session_id: bytes = b"dhb",
        max_future_epochs: int = 3,
    ) -> "DynamicHoneyBadger":
        """Construct an observer from a `JoinPlan` (reference §3.4)."""
        g = backend.group
        pub_keys = {
            nid: PublicKey.from_bytes(g, pkb) for nid, pkb in join_plan.pub_keys
        }
        netinfo = NetworkInfo(
            our_id=our_id,
            secret_key_share=None,
            public_key_set=PublicKeySet.from_bytes(g, join_plan.pub_key_set_bytes),
            secret_key=secret_key,
            public_keys=pub_keys,
        )
        return DynamicHoneyBadger(
            netinfo,
            backend,
            rng=rng,
            session_id=session_id,
            max_future_epochs=max_future_epochs,
            encryption_schedule=join_plan.encryption_schedule,
            era=join_plan.era,
        )

    def join_plan(self) -> JoinPlan:
        """Snapshot for an observer to join the *current* era."""
        return JoinPlan(
            era=self.era,
            pub_key_set_bytes=self.netinfo.public_key_set.to_bytes(),
            pub_keys=tuple(
                sorted(
                    (nid, pk.to_bytes())
                    for nid, pk in self.netinfo.public_key_map().items()
                )
            ),
            encryption_schedule=self.encryption_schedule,
        )

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return False

    def handle_input(self, input: Any, rng=None) -> Step:
        """Generic input: ("user", contribution) or ("change", Change)."""
        kind, payload = input
        if kind == "user":
            return self.propose(payload, rng or self.rng)
        if kind == "change":
            return self.vote_for(payload)
        raise ValueError(f"unknown input kind {kind!r}")

    # -- voting --------------------------------------------------------------

    def vote_for(self, change: Change) -> Step:
        """Sign and queue a vote; it rides in our next contribution."""
        if not self.netinfo.is_validator():
            return Step()
        self._vote_num += 1
        vote = SignedVote(
            voter=self.netinfo.our_id,
            era=self.era,
            num=self._vote_num,
            change=change,
            sig_bytes=b"",
        )
        sig = self.netinfo.secret_key.sign(vote.signed_payload())
        vote = SignedVote(vote.voter, vote.era, vote.num, vote.change, sig.to_bytes())
        self._pending_votes.append(vote)
        return Step()

    def vote_to_add(self, node_id, pub_key: PublicKey) -> Step:
        return self.vote_for(Change.add(node_id, pub_key.to_bytes()))

    def vote_to_remove(self, node_id) -> Step:
        return self.vote_for(Change.remove(node_id))

    # -- proposing -----------------------------------------------------------

    def propose(self, contribution: Any, rng=None) -> Step:
        if not self.netinfo.is_validator():
            return Step()
        rng = rng or self.rng
        votes = [v.to_canonical() for v in self._pending_votes]
        kg = [list(item) for item in self._pending_kg]
        internal = ("icontrib", contribution, votes, kg)
        return self._wrap_hb(self.era, self.hb.propose(internal, rng))

    def handle_message(self, sender_id: Any, message: DhbMessage, rng=None) -> Step:
        if not isinstance(message, DhbMessage) or not isinstance(message.era, int):
            return Step.from_fault(sender_id, "dynamic_honey_badger:malformed_message")
        if message.era < self.era:
            return Step()  # previous era: stale but benign
        if message.era > self.era + 1:
            return Step.from_fault(sender_id, "dynamic_honey_badger:era_too_far_ahead")
        if message.era > self.era:
            # Fault next-era traffic only on *provable* non-membership:
            # with a DKG in progress the era+1 member set is known
            # (current validators ∪ key_gen.pub_keys covers a joiner that
            # finished the era first).  Before the DKG-start batch is
            # processed, era+1 membership is undetermined — buffer as
            # before rather than drop an honest early sender.
            if (
                self.key_gen is not None
                and not self.netinfo.is_node_validator(sender_id)
                and sender_id not in self.key_gen.pub_keys
            ):
                return Step.from_fault(
                    sender_id, "dynamic_honey_badger:future_era_from_non_member"
                )
            self._future_era.append((sender_id, message))
            return Step()
        return self._wrap_hb(
            self.era, self.hb.handle_message(sender_id, message.payload, rng)
        )

    # -- HB wiring -----------------------------------------------------------

    def _wrap_hb(self, era: int, hb_step: Step) -> Step:
        return absorb_child_step(
            hb_step,
            wrap_msg=lambda m, _e=era: DhbMessage(_e, m),
            on_output=lambda batch, _e=era: self._on_hb_batch(_e, batch),
        )

    def _on_hb_batch(self, era: int, hb_batch: HbBatch) -> Step:
        if era != self.era:
            return Step()  # late re-entry across an era boundary
        step = Step()
        contributions: Dict[Any, Any] = {}
        votes: List[Tuple[Any, SignedVote]] = []
        kg_msgs: List[Tuple[Any, Tuple, bytes]] = []
        order = sorted(
            hb_batch.contributions.items(),
            key=lambda kv: self.netinfo.node_index(kv[0]),
        )
        for proposer, internal in order:
            try:
                tag, user, vote_list, kg_list = internal
                if tag != "icontrib":
                    raise ValueError
            except (TypeError, ValueError):
                step.add_fault(proposer, "dynamic_honey_badger:malformed_contribution")
                continue
            if user is not None:
                contributions[proposer] = user
            try:
                for vt in vote_list:
                    votes.append((proposer, SignedVote.from_canonical(vt)))
                for item in kg_list:
                    change_canonical, msg_canonical, sig = item
                    if not isinstance(sig, bytes):
                        raise ValueError
                    kg_msgs.append((proposer, change_canonical, msg_canonical, sig))
            except (TypeError, ValueError, IndexError):
                step.add_fault(proposer, "dynamic_honey_badger:malformed_contribution")
                continue

        # One batched signature verification for everything in this batch.
        sig_items = []
        g = self.backend.group
        for proposer, vote in votes:
            pk = self.netinfo.public_key(vote.voter)
            sig_items.append(
                (pk, vote.signed_payload(), _sig_or_none(g, vote.sig_bytes))
            )
        for proposer, change_canonical, msg_canonical, sig_bytes in kg_msgs:
            pk = self.netinfo.public_key(proposer)
            payload = canonical.encode(
                ("dhb-kg", self.era, change_canonical, msg_canonical)
            )
            sig_items.append((pk, payload, _sig_or_none(g, sig_bytes)))
        valid = self._verify_signatures(sig_items)

        i = 0
        valid_votes: List[Tuple[Any, SignedVote]] = []
        valid_kg: List[Tuple[Any, Any, Tuple]] = []
        for proposer, vote in votes:
            if not valid[i]:
                step.add_fault(proposer, "dynamic_honey_badger:invalid_vote_signature")
            else:
                valid_votes.append((proposer, vote))
                self.vote_counter.add_committed_vote(vote)
            i += 1
        for proposer, change_canonical, msg_canonical, sig_bytes in kg_msgs:
            if not valid[i]:
                step.add_fault(
                    proposer, "dynamic_honey_badger:invalid_keygen_signature"
                )
            else:
                valid_kg.append((proposer, change_canonical, msg_canonical))
                step.extend(
                    self._handle_committed_kg(proposer, change_canonical, msg_canonical)
                )
            i += 1

        # Prune only against *authenticated* commits: a forged (voter, num)
        # tuple must not censor our real pending vote.
        self._prune_pending(valid_votes, valid_kg)

        # Era-transition decision (identical on every node: all inputs are
        # committed batch contents).
        change_state = ChangeState.none()
        era_completed = False
        if self.key_gen is not None and self.key_gen.keygen.is_ready():
            change_state = ChangeState.complete(self.key_gen.change)
            era_completed = True
        else:
            winner = self.vote_counter.winner()
            if winner is not None:
                if winner.kind == "schedule":
                    change_state = ChangeState.complete(winner)
                    self.encryption_schedule = winner.schedule
                    era_completed = True
                    self.key_gen = None
                elif self.key_gen is None or self.key_gen.change != winner:
                    kg_step = self._start_key_gen(winner)
                    step.extend(kg_step)
                    change_state = ChangeState.in_progress(winner)
                else:
                    change_state = ChangeState.in_progress(self.key_gen.change)
            elif self.key_gen is not None:
                change_state = ChangeState.in_progress(self.key_gen.change)

        batch = DhbBatch(
            era=self.era,
            epoch=hb_batch.epoch,
            contributions=contributions,
            change=change_state,
        )
        step.with_output(batch)
        if era_completed:
            step.extend(self._finish_era())
        return step

    def _verify_signatures(self, items) -> List[bool]:
        checked = []
        for pk, payload, sig in items:
            if pk is None or sig is None:
                checked.append(False)
            else:
                checked.append(None)  # placeholder: batch-verified below
        to_verify = [
            (pk, payload, sig)
            for (pk, payload, sig), c in zip(items, checked)
            if c is None
        ]
        results = iter(self.backend.verify_signatures(to_verify))
        return [c if c is not None else next(results) for c in checked]

    def _prune_pending(self, votes, kg_msgs) -> None:
        """Drop our queued votes/key-gen messages once they commit."""
        committed_votes = {
            (v.voter, v.era, v.num) for _, v in votes
        }
        self._pending_votes = [
            v
            for v in self._pending_votes
            if (v.voter, v.era, v.num) not in committed_votes
        ]
        committed_kg = {
            canonical.encode((c, m))
            for p, c, m in kg_msgs
            if p == self.netinfo.our_id
        }
        self._pending_kg = [
            (c, m, s)
            for c, m, s in self._pending_kg
            if canonical.encode((c, m)) not in committed_kg
        ]

    # -- key generation ------------------------------------------------------

    def _next_pub_keys(self, change: Change) -> Optional[Dict[Any, PublicKey]]:
        cur = self.netinfo.public_key_map()
        if change.kind == "add":
            try:
                pk = PublicKey.from_bytes(self.backend.group, change.pub_key_bytes)
            except (ValueError, TypeError):
                return None
            cur[change.node_id] = pk
            return cur
        if change.kind == "remove":
            if change.node_id not in cur:
                return None
            del cur[change.node_id]
            return cur
        return None

    def _start_key_gen(self, change: Change) -> Step:
        pub_keys = self._next_pub_keys(change)
        if pub_keys is None:
            self.key_gen = None
            return Step()
        threshold = (len(pub_keys) - 1) // 3
        keygen, part = SyncKeyGen.new(
            self.netinfo.our_id,
            self.netinfo.secret_key,
            pub_keys,
            threshold,
            self.rng,
            self.backend.group,
        )
        self.key_gen = _KeyGenState(change, keygen, pub_keys)
        # A previous DKG's queued messages are for a dead session.
        self._pending_kg = []
        if part is not None and self.netinfo.is_validator():
            self._queue_kg(part_to_canonical(part))
        return Step()

    def _queue_kg(self, msg_canonical: Tuple) -> None:
        change_canonical = self.key_gen.change.to_canonical()
        payload = canonical.encode(
            ("dhb-kg", self.era, change_canonical, msg_canonical)
        )
        sig = self.netinfo.secret_key.sign(payload)
        self._pending_kg.append((change_canonical, msg_canonical, sig.to_bytes()))

    def _handle_committed_kg(self, proposer: Any, change_canonical, msg_canonical) -> Step:
        if self.key_gen is None:
            return Step()  # no DKG in progress: stale key-gen traffic
        try:
            change_canonical = (
                tuple(change_canonical)
                if isinstance(change_canonical, list)
                else change_canonical
            )
        except TypeError:
            return Step.from_fault(proposer, "dynamic_honey_badger:malformed_keygen")
        if change_canonical != self.key_gen.change.to_canonical():
            # Signed for a different (superseded) DKG session: ignore.
            return Step()
        kg = self.key_gen.keygen
        try:
            msg_canonical = (
                tuple(msg_canonical)
                if isinstance(msg_canonical, list)
                else msg_canonical
            )
            tag = msg_canonical[0]
            if tag == "part":
                part = part_from_canonical(self.backend.group, msg_canonical)
                outcome = kg.handle_part(proposer, part, self.rng)
                step = Step()
                if outcome.fault:
                    step.add_fault(proposer, outcome.fault)
                if outcome.ack is not None and self.netinfo.is_validator():
                    self._queue_kg(ack_to_canonical(outcome.ack))
                return step
            if tag == "ack":
                outcome = kg.handle_ack(proposer, ack_from_canonical(msg_canonical))
                if outcome.fault:
                    return Step.from_fault(proposer, outcome.fault)
                return Step()
        except (TypeError, ValueError, IndexError):
            pass
        return Step.from_fault(proposer, "dynamic_honey_badger:malformed_keygen")

    # -- era turnover --------------------------------------------------------

    def _finish_era(self) -> Step:
        if self.key_gen is not None:
            pk_set, share = self.key_gen.keygen.generate()
            pub_keys = self.key_gen.pub_keys
        else:
            # Schedule-only change: keys carry over.
            pk_set = self.netinfo.public_key_set
            share = self.netinfo.secret_key_share
            pub_keys = self.netinfo.public_key_map()
        self.netinfo = NetworkInfo(
            our_id=self.netinfo.our_id,
            secret_key_share=share if self.netinfo.our_id in pub_keys else None,
            public_key_set=pk_set,
            secret_key=self.netinfo.secret_key,
            public_keys=pub_keys,
        )
        self.era += 1
        self.key_gen = None
        self.vote_counter = VoteCounter(self.era, self.netinfo.num_nodes())
        self._pending_votes = []
        self._pending_kg = []
        self.hb = self._new_hb()
        step = Step()
        future, self._future_era = self._future_era, []
        for sender_id, message in future:
            step.extend(self.handle_message(sender_id, message))
        return step


def _sig_or_none(group, sig_bytes) -> Optional[Signature]:
    try:
        return Signature.from_bytes(group, sig_bytes)
    except (ValueError, TypeError):
        return None
