"""Signed validator votes for dynamic membership changes.

Rebuild of `src/dynamic_honey_badger/votes.rs` § (SURVEY.md §2.1): each
validator signs `(era, num, change)` with its per-node secret key; votes
ride inside committed contributions so every node counts them in the same
order.  Only a voter's *latest* vote (highest ``num``) counts; a change wins
once more than half of the current validators' latest votes name it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.crypto.keys import Signature
from hbbft_tpu_torch.protocols.change import Change
from hbbft_tpu_torch.utils import canonical


@dataclass(frozen=True, slots=True)
class SignedVote:
    voter: Any
    era: int
    num: int
    change: Change
    sig_bytes: bytes

    def signed_payload(self) -> bytes:
        return canonical.encode(
            ("dhb-vote", self.era, self.num, self.change.to_canonical())
        )

    def to_canonical(self) -> Tuple:
        return (self.voter, self.era, self.num, self.change.to_canonical(), self.sig_bytes)

    @staticmethod
    def from_canonical(t) -> "SignedVote":
        voter, era, num, change_t, sig = t
        hash(voter)  # reject unhashable (list/dict) voter ids: TypeError
        if not isinstance(era, int) or not isinstance(num, int) or not isinstance(sig, bytes):
            raise ValueError("malformed vote")
        return SignedVote(voter, era, num, Change.from_canonical(change_t), sig)


class VoteCounter:
    """Tracks committed votes for one era."""

    def __init__(self, era: int, num_validators: int) -> None:
        self.era = era
        self.num_validators = num_validators
        self._latest: Dict[Any, SignedVote] = {}  # voter -> latest vote

    def add_committed_vote(self, vote: SignedVote) -> None:
        """Record an already-signature-verified committed vote."""
        if vote.era != self.era:
            return
        cur = self._latest.get(vote.voter)
        if cur is None or vote.num > cur.num:
            self._latest[vote.voter] = vote

    def tally(self) -> Dict[Tuple, int]:
        counts: Dict[Tuple, int] = {}
        # lint: allow[determinism] vote counting is commutative; winner() sorts
        for v in self._latest.values():
            key = v.change.to_canonical()
            counts[key] = counts.get(key, 0) + 1
        return counts

    def winner(self) -> Optional[Change]:
        """The change named by a strict majority of validators, if any."""
        for key, count in sorted(self.tally().items(), key=lambda kv: repr(kv)):
            if 2 * count > self.num_validators:
                return Change.from_canonical(key)
        return None
