"""ThresholdSign — the common-coin primitive.

Rebuild of `src/threshold_sign/mod.rs` § (SURVEY.md §2.1): every node BLS-signs
a canonical document with its secret key share; any f+1 valid shares
Lagrange-combine into the unique master signature, whose hash is an
unbiasable random value (the coin).

device-first delta: incoming shares are **not** verified inline.  Each share
becomes a ``verify_sig_share`` :class:`~hbbft_tpu_torch.core.types.CryptoWork`
item; the runtime batches all shares from a crank round into one device
pairing dispatch (the hottest loop — SURVEY.md §3.2).  A share is
"received-but-unverified" until the barrier; combination fires when f+1
*verified* shares are present, which yields the same unique signature
regardless of which subset verifies first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import CryptoWork, Step, Target, TargetedMessage
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.keys import Signature, SignatureShare


@dataclass(frozen=True, slots=True)
class ThresholdSignMessage:
    """Wire message: one node's signature share."""

    share: SignatureShare


class ThresholdSign(ConsensusProtocol):
    """Threshold-sign a fixed document; outputs the combined `Signature`."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        doc: Optional[bytes] = None,
    ) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.doc = doc
        self.had_input = False
        self._verified: Dict[int, SignatureShare] = {}  # node index -> share
        self._pending_senders = set()  # senders whose share is in-flight or done
        self._early = []  # (sender, share) received before the doc was set
        self.signature: Optional[Signature] = None
        self._terminated = False

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return self._terminated

    def set_document(self, doc: bytes) -> Step:
        """Set the document to sign; drains shares that arrived early."""
        if self.doc is not None and self.doc != doc:
            raise ValueError("document already set")
        self.doc = doc
        step = Step()
        early, self._early = self._early, []
        for sender_id, message in early:
            step.extend(self.handle_message(sender_id, message))
        return step

    def handle_input(self, input: Any = None, rng=None) -> Step:
        return self.sign()

    def sign(self) -> Step:
        """Multicast our signature share and record it locally."""
        if self.doc is None:
            raise ValueError("no document to sign")
        if self.had_input:
            return Step()
        self.had_input = True
        step = Step()
        if not self.netinfo.is_validator():
            return step
        share = self.netinfo.secret_key_share.sign_share(self.doc)
        step.messages.append(TargetedMessage(Target.all(), ThresholdSignMessage(share)))
        our_idx = self.netinfo.node_index(self.netinfo.our_id)
        self._pending_senders.add(self.netinfo.our_id)
        self._verified[our_idx] = share
        step.extend(self._try_combine())
        return step

    def handle_message(self, sender_id: Any, message: ThresholdSignMessage, rng=None) -> Step:
        if self._terminated:
            return Step()
        if not isinstance(message, ThresholdSignMessage) or not isinstance(
            message.share, Signature
        ):
            return Step.from_fault(sender_id, "threshold_sign:malformed_message")
        idx = self.netinfo.node_index(sender_id)
        if idx is None:
            return Step.from_fault(sender_id, "threshold_sign:non_validator_share")
        if sender_id in self._pending_senders:
            # Duplicate share: ignore (re-sends are legal under reordering).
            return Step()
        if self.doc is None:
            # Share raced ahead of set_document: buffer, drained on set.
            self._early.append((sender_id, message))
            return Step()
        self._pending_senders.add(sender_id)
        pk_share = self.netinfo.public_key_set.public_key_share(idx)
        share = message.share

        def on_verified(valid: bool, _sender=sender_id, _idx=idx, _share=share) -> Step:
            if not valid:
                return Step.from_fault(_sender, "threshold_sign:invalid_sig_share")
            self._verified[_idx] = _share
            return self._try_combine()

        return Step().defer(
            CryptoWork("verify_sig_share", (pk_share, self.doc, share), on_verified)
        )

    # -- combination ---------------------------------------------------------

    def _try_combine(self) -> Step:
        threshold = self.netinfo.public_key_set.threshold()
        if self.signature is not None or len(self._verified) <= threshold:
            return Step()
        shares = dict(list(sorted(self._verified.items()))[: threshold + 1])
        sig = self.backend.combine_signatures(
            self.netinfo.public_key_set, shares, doc=self.doc
        )
        self.signature = sig
        self._terminated = True
        return Step.from_output(sig)
