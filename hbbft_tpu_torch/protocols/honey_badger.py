"""HoneyBadger — the core atomic-broadcast epoch loop.

Rebuild of `src/honey_badger/` § (SURVEY.md §2.1): each epoch, every node
threshold-encrypts its contribution, the nodes run ACS (Subset) over the
ciphertexts, then threshold-decrypt the accepted ones; the epoch's output is
a `Batch` mapping proposer → contribution.  Encrypting *before* agreement
and decrypting *after* is what defeats transaction censorship — the
adversary commits to the subset before seeing any plaintext.

device-first deltas:
* Ciphertext validity checks and decryption-share verifications are deferred
  device work (O(N²) pairings/epoch at N=100 — SURVEY.md §3.2); HoneyBadger
  owns ciphertext-validity policy and only hands *pre-validated* ciphertexts
  to ThresholdDecrypt.
* `EncryptionSchedule` (Always / Never / EveryNth / TickTock) mirrors the
  reference's knob for trading censorship resistance against crypto load.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import CryptoWork, Step, absorb_child_step
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.keys import Ciphertext, CryptoError
from hbbft_tpu_torch.obs import critpath as _critpath
from hbbft_tpu_torch.protocols.subset import Subset, SubsetOutput
from hbbft_tpu_torch.protocols.threshold_decrypt import (
    ThresholdDecrypt,
    ThresholdDecryptMessage,
)
from hbbft_tpu_torch.utils import canonical


# ---------------------------------------------------------------------------
# Encryption schedule (reference `EncryptionSchedule` §, uncertain vintage)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class EncryptionSchedule:
    """When to threshold-encrypt contributions.

    kind ∈ {"always", "never", "every_nth", "tick_tock"}; ``every_nth``
    encrypts epochs ≡ 0 (mod n); ``tick_tock(on, off)`` encrypts ``on``
    epochs then skips ``off``.
    """

    kind: str = "always"
    n: int = 1
    m: int = 0

    @staticmethod
    def always() -> "EncryptionSchedule":
        return EncryptionSchedule("always")

    @staticmethod
    def never() -> "EncryptionSchedule":
        return EncryptionSchedule("never")

    @staticmethod
    def every_nth(n: int) -> "EncryptionSchedule":
        return EncryptionSchedule("every_nth", n=n)

    @staticmethod
    def tick_tock(on: int, off: int) -> "EncryptionSchedule":
        return EncryptionSchedule("tick_tock", n=on, m=off)

    def encrypt_in_epoch(self, epoch: int) -> bool:
        if self.kind == "always":
            return True
        if self.kind == "never":
            return False
        if self.kind == "every_nth":
            return epoch % max(self.n, 1) == 0
        period = max(self.n + self.m, 1)
        return epoch % period < self.n


# ---------------------------------------------------------------------------
# Batch — one epoch's agreed output (reference `Batch` §)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class Batch:
    epoch: int
    contributions: Dict[Any, Any]

    def iter_all(self) -> List[Tuple[Any, Any]]:
        return sorted(self.contributions.items(), key=lambda kv: repr(kv[0]))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Batch)
            and self.epoch == other.epoch
            and self.contributions == other.contributions
        )


@dataclass(frozen=True, slots=True)
class HbMessage:
    """kind ∈ {"subset", "dec_share"}; epoch-tagged envelope."""

    epoch: int
    kind: str
    proposer: Any  # only for dec_share
    payload: Any

    @staticmethod
    def subset(epoch: int, msg) -> "HbMessage":
        return HbMessage(epoch, "subset", None, msg)

    @staticmethod
    def dec_share(epoch: int, proposer, msg) -> "HbMessage":
        return HbMessage(epoch, "dec_share", proposer, msg)


class _EpochState:
    """Per-epoch Subset + per-proposer ThresholdDecrypt map
    (reference `epoch_state.rs` §)."""

    def __init__(self, subset: Subset, encrypted: bool) -> None:
        self.subset = subset
        self.encrypted = encrypted
        self.decrypt: Dict[Any, ThresholdDecrypt] = {}
        self.accepted: Dict[Any, bytes] = {}  # proposer -> raw subset payload
        self.decrypted: Dict[Any, Any] = {}  # proposer -> contribution
        self.skipped: set = set()  # proposers with invalid payloads
        self.subset_done = False
        self.batch_emitted = False


class HoneyBadgerBuilder:
    """Builder mirroring the reference `HoneyBadgerBuilder` §."""

    def __init__(self, netinfo: NetworkInfo, backend: CryptoBackend) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self._max_future_epochs = 3
        self._encryption_schedule = EncryptionSchedule.always()
        self._session_id = b"hb"

    def max_future_epochs(self, n: int) -> "HoneyBadgerBuilder":
        self._max_future_epochs = n
        return self

    def encryption_schedule(self, s: EncryptionSchedule) -> "HoneyBadgerBuilder":
        self._encryption_schedule = s
        return self

    def session_id(self, sid: bytes) -> "HoneyBadgerBuilder":
        self._session_id = sid
        return self

    def build(self) -> "HoneyBadger":
        return HoneyBadger(
            self.netinfo,
            self.backend,
            session_id=self._session_id,
            max_future_epochs=self._max_future_epochs,
            encryption_schedule=self._encryption_schedule,
        )


class HoneyBadger(ConsensusProtocol):
    """Epochs of threshold-encrypted contributions; outputs `Batch`es."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        session_id: bytes = b"hb",
        max_future_epochs: int = 3,
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
    ) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.session_id = session_id
        self.max_future_epochs = max_future_epochs
        self.encryption_schedule = encryption_schedule
        self.epoch = 0
        self.has_input = False  # proposed in the *current* epoch
        self._epoch_state = self._new_epoch_state(0)
        self._future: Dict[int, List[Tuple[Any, HbMessage]]] = {}

    @staticmethod
    def builder(netinfo, backend) -> HoneyBadgerBuilder:
        return HoneyBadgerBuilder(netinfo, backend)

    def _new_epoch_state(self, epoch: int) -> _EpochState:
        sid = canonical.encode(("hb-subset", self.session_id, epoch))
        return _EpochState(
            Subset(self.netinfo, self.backend, session_id=sid),
            encrypted=self.encryption_schedule.encrypt_in_epoch(epoch),
        )

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return False  # runs forever; the embedder stops driving it

    def handle_input(self, input: Any, rng=None) -> Step:
        return self.propose(input, rng)

    def propose(self, contribution: Any, rng) -> Step:
        """Propose our contribution for the current epoch."""
        if self.has_input:
            return Step()
        self.has_input = True
        if not self.netinfo.is_validator():
            return Step()
        payload = canonical.encode(contribution)
        if self._epoch_state.encrypted:
            if rng is None:
                raise ValueError("encrypting proposal requires an rng")
            ct = self.netinfo.public_key_set.encrypt(payload, rng)
            payload = ct.to_bytes()
        return self._wrap_subset(
            self.epoch, self._epoch_state.subset.propose(payload)
        )

    def handle_message(self, sender_id: Any, message: HbMessage, rng=None) -> Step:
        if not isinstance(message, HbMessage) or not isinstance(message.epoch, int):
            return Step.from_fault(sender_id, "honey_badger:malformed_message")
        e = message.epoch
        if e < self.epoch:
            return Step()  # obsolete epoch
        if e > self.epoch + self.max_future_epochs:
            return Step.from_fault(sender_id, "honey_badger:epoch_too_far_ahead")
        if e > self.epoch:
            if not self.netinfo.is_node_validator(sender_id):
                # Only validators may grow the future-epoch buffer: anyone
                # else could inflate it without bound (memory DoS).
                return Step.from_fault(
                    sender_id, "honey_badger:future_epoch_from_non_validator"
                )
            self._future.setdefault(e, []).append((sender_id, message))
            return Step()
        return self._handle_current(sender_id, message)

    def _handle_current(self, sender_id: Any, message: HbMessage) -> Step:
        es = self._epoch_state
        if message.kind == "subset":
            return self._wrap_subset(
                self.epoch, es.subset.handle_message(sender_id, message.payload)
            )
        if message.kind == "dec_share":
            if not es.encrypted:
                return Step.from_fault(
                    sender_id, "honey_badger:dec_share_in_plaintext_epoch"
                )
            if not self.netinfo.is_node_validator(message.proposer):
                # Unknown proposer id: would otherwise grow unbounded
                # ThresholdDecrypt state within the epoch.
                return Step.from_fault(
                    sender_id, "honey_badger:dec_share_unknown_proposer"
                )
            td = self._get_decrypt(message.proposer)
            return self._wrap_decrypt(
                self.epoch,
                message.proposer,
                td.handle_message(sender_id, message.payload),
            )
        return Step.from_fault(sender_id, "honey_badger:unknown_kind")

    # -- subset wiring -------------------------------------------------------

    def _wrap_subset(self, epoch: int, child_step: Step) -> Step:
        return absorb_child_step(
            child_step,
            wrap_msg=lambda m, _e=epoch: HbMessage.subset(_e, m),
            on_output=lambda out, _e=epoch: self._on_subset_output(_e, out),
        )

    def _on_subset_output(self, epoch: int, out: SubsetOutput) -> Step:
        if epoch != self.epoch:
            return Step()  # late re-entry from a completed epoch
        es = self._epoch_state
        if out.kind == "done":
            es.subset_done = True
            return self._try_emit_batch()
        proposer, payload = out.proposer, out.value
        es.accepted[proposer] = payload
        if not es.encrypted:
            return self._on_plaintext(epoch, proposer, payload)
        # Parse + validate the ciphertext, then decrypt.
        try:
            ct = Ciphertext.from_bytes(self.backend.group, payload)
        except (CryptoError, ValueError, IndexError):
            return self._skip_proposer(proposer, "honey_badger:unparseable_ciphertext")

        def on_valid(ok: bool, _e=epoch, _p=proposer, _ct=ct) -> Step:
            if _e != self.epoch:
                return Step()
            if not ok:
                return self._skip_proposer(_p, "honey_badger:invalid_ciphertext")
            td = self._get_decrypt(_p)
            step = self._wrap_decrypt(_e, _p, td.set_ciphertext(_ct, pre_validated=True))
            return step.extend(self._wrap_decrypt(_e, _p, td.start_decryption()))

        return Step().defer(CryptoWork("verify_ciphertext", ct, on_valid))

    def _on_plaintext(self, epoch: int, proposer: Any, payload: bytes) -> Step:
        es = self._epoch_state
        try:
            contribution = canonical.decode(payload)
        except (ValueError, IndexError):
            return self._skip_proposer(proposer, "honey_badger:invalid_contribution")
        es.decrypted[proposer] = contribution
        return self._try_emit_batch()

    def _skip_proposer(self, proposer: Any, fault_kind: str) -> Step:
        self._epoch_state.skipped.add(proposer)
        step = Step.from_fault(proposer, fault_kind)
        return step.extend(self._try_emit_batch())

    # -- decryption wiring ---------------------------------------------------

    def _get_decrypt(self, proposer: Any) -> ThresholdDecrypt:
        es = self._epoch_state
        if proposer not in es.decrypt:
            es.decrypt[proposer] = ThresholdDecrypt(self.netinfo, self.backend)
        return es.decrypt[proposer]

    def _wrap_decrypt(self, epoch: int, proposer: Any, child_step: Step) -> Step:
        return absorb_child_step(
            child_step,
            wrap_msg=lambda m, _e=epoch, _p=proposer: HbMessage.dec_share(_e, _p, m),
            on_output=lambda pt, _e=epoch, _p=proposer: self._on_decrypted(_e, _p, pt),
        )

    def _on_decrypted(self, epoch: int, proposer: Any, plaintext: bytes) -> Step:
        if epoch != self.epoch:
            return Step()
        es = self._epoch_state
        try:
            contribution = canonical.decode(plaintext)
        except (ValueError, IndexError):
            return self._skip_proposer(proposer, "honey_badger:invalid_contribution")
        es.decrypted[proposer] = contribution
        _critpath.stamp(
            "decrypt.combine",
            node=self.netinfo.our_id,
            instance=self.netinfo.node_index(proposer),
            epoch=epoch,
        )
        return self._try_emit_batch()

    # -- epoch completion ----------------------------------------------------

    def _try_emit_batch(self) -> Step:
        es = self._epoch_state
        if es.batch_emitted or not es.subset_done:
            return Step()
        pending = [
            p
            for p in es.accepted
            if p not in es.decrypted and p not in es.skipped
        ]
        if pending:
            return Step()
        es.batch_emitted = True
        _critpath.stamp("epoch.commit", node=self.netinfo.our_id, epoch=self.epoch)
        batch = Batch(epoch=self.epoch, contributions=dict(es.decrypted))
        step = Step.from_output(batch)
        return step.extend(self._advance_epoch())

    def _advance_epoch(self) -> Step:
        self.epoch += 1
        self.has_input = False
        self._epoch_state = self._new_epoch_state(self.epoch)
        step = Step()
        for sender_id, message in self._future.pop(self.epoch, []):
            step.extend(self.handle_message(sender_id, message))
        return step
