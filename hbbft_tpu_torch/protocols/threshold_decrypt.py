"""ThresholdDecrypt — collect and combine decryption shares.

Rebuild of `src/threshold_decrypt/mod.rs` § (SURVEY.md §2.1): given a
threshold ciphertext, every validator multicasts its decryption share;
f+1 pairing-verified shares Lagrange-combine in G1 to the plaintext.

Like ThresholdSign, share verification is deferred into batched
``verify_dec_share`` work items — at N=100 this is the second half of the
O(N²)-pairings-per-epoch hot loop (SURVEY.md §3.2) that the device backend
resolves in one dispatch.  Shares arriving before the ciphertext is set are
buffered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import CryptoWork, Step, Target, TargetedMessage
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.keys import Ciphertext, DecryptionShare


@dataclass(frozen=True, slots=True)
class ThresholdDecryptMessage:
    share: DecryptionShare


class ThresholdDecrypt(ConsensusProtocol):
    """Decrypt one ciphertext; outputs the plaintext bytes."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        ciphertext: Optional[Ciphertext] = None,
    ) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.ciphertext: Optional[Ciphertext] = None
        self._verified: Dict[int, DecryptionShare] = {}
        self._pending_senders = set()
        self._early: List[Tuple[Any, ThresholdDecryptMessage]] = []
        self.plaintext: Optional[bytes] = None
        self._terminated = False
        self._ct_invalid = False
        self._share_sent = False
        self._decrypt_requested = False
        if ciphertext is not None:
            # Constructor form: validate synchronously (rare path; the HB
            # epoch pipeline uses set_ciphertext + deferred validation).
            if not ciphertext.verify():
                raise ValueError("invalid ciphertext")
            self.ciphertext = ciphertext

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return self._terminated

    def set_ciphertext(self, ct: Ciphertext, pre_validated: bool = False) -> Step:
        """Install the ciphertext.  Unless ``pre_validated`` (e.g. HB already
        batch-checked it), validation is deferred to the device batch; an
        invalid ciphertext terminates the instance with no output."""
        if self.ciphertext is not None or self._ct_invalid:
            raise ValueError("ciphertext already set")
        if pre_validated:
            self.ciphertext = ct
            return self._drain_early()

        def on_valid(ok: bool) -> Step:
            if not ok:
                self._ct_invalid = True
                self._terminated = True
                return Step()
            self.ciphertext = ct
            return self._drain_early()

        return Step().defer(CryptoWork("verify_ciphertext", ct, on_valid))

    def _drain_early(self) -> Step:
        step = Step()
        if self._decrypt_requested:
            step.extend(self.start_decryption())
        early, self._early = self._early, []
        for sender_id, message in early:
            step.extend(self.handle_message(sender_id, message))
        return step

    def handle_input(self, input: Any = None, rng=None) -> Step:
        return self.start_decryption()

    def start_decryption(self) -> Step:
        """Multicast our decryption share (requires the ciphertext)."""
        if self._share_sent or self._ct_invalid:
            return Step()
        if self.ciphertext is None:
            # Validation still pending (deferred batch): fire on completion.
            self._decrypt_requested = True
            return Step()
        self._share_sent = True
        if not self.netinfo.is_validator():
            return Step()
        share = self.netinfo.secret_key_share.decrypt_share_unchecked(self.ciphertext)
        step = Step()
        step.messages.append(
            TargetedMessage(Target.all(), ThresholdDecryptMessage(share))
        )
        our_idx = self.netinfo.node_index(self.netinfo.our_id)
        self._pending_senders.add(self.netinfo.our_id)
        self._verified[our_idx] = share
        return step.extend(self._try_combine())

    def handle_message(self, sender_id: Any, message: ThresholdDecryptMessage, rng=None) -> Step:
        if self._terminated:
            return Step()
        if not isinstance(message, ThresholdDecryptMessage) or not isinstance(
            message.share, DecryptionShare
        ):
            return Step.from_fault(sender_id, "threshold_decrypt:malformed_message")
        idx = self.netinfo.node_index(sender_id)
        if idx is None:
            return Step.from_fault(sender_id, "threshold_decrypt:non_validator_share")
        if sender_id in self._pending_senders:
            return Step()
        if self.ciphertext is None:
            self._early.append((sender_id, message))
            return Step()
        self._pending_senders.add(sender_id)
        pk_share = self.netinfo.public_key_set.public_key_share(idx)
        share = message.share

        def on_verified(valid: bool, _s=sender_id, _i=idx, _sh=share) -> Step:
            if not valid:
                return Step.from_fault(_s, "threshold_decrypt:invalid_share")
            self._verified[_i] = _sh
            return self._try_combine()

        return Step().defer(
            CryptoWork(
                "verify_dec_share", (pk_share, self.ciphertext, share), on_verified
            )
        )

    # -- combination ---------------------------------------------------------

    def _try_combine(self) -> Step:
        threshold = self.netinfo.public_key_set.threshold()
        if self.plaintext is not None or len(self._verified) <= threshold:
            return Step()
        shares = dict(list(sorted(self._verified.items()))[: threshold + 1])
        self.plaintext = self.backend.combine_decryption_shares(
            self.netinfo.public_key_set, shares, self.ciphertext
        )
        self._terminated = True
        return Step.from_output(self.plaintext)
