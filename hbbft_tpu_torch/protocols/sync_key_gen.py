"""SyncKeyGen — synchronous-round distributed key generation (no dealer).

Rebuild of `src/sync_key_gen.rs` § (SURVEY.md §2.1): Pedersen-style DKG over
symmetric bivariate polynomials.  Each proposer p commits to a random
symmetric bivariate polynomial f_p of degree t and sends node j its row
f_p(j+1, ·) encrypted; each receiver verifies its row against the public
commitment and broadcasts an Ack carrying, for every node k, the encrypted
value f_p(j+1, k+1).  By symmetry node k can cross-check each value against
the commitment and, once a part has 2t+1 Acks ("complete"), interpolate its
secret share f_p(k+1, 0) from any t+1 of them.  Summing over the first t+1
complete parts yields the master `PublicKeySet` and per-node
`SecretKeyShare`s — no party ever knows the master secret.

SyncKeyGen is *transport-agnostic* (it emits no network messages itself):
DynamicHoneyBadger commits `Part`/`Ack` messages inside batches so that all
nodes process them in the same order (SURVEY.md §3.4).  Thresholds follow
the reference: part complete at > 2t Acks, ready at > t complete parts
*(uncertain in reference — SURVEY.md marks these for verification)*.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.crypto.group import Group
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    PublicKey,
    PublicKeySet,
    SecretKey,
    SecretKeyShare,
)
from hbbft_tpu_torch.crypto.poly import BivarCommitment, BivarPoly, Commitment, Poly
from hbbft_tpu_torch.utils import canonical


@dataclass(frozen=True, slots=True)
class Part:
    """A proposer's commitment + per-node encrypted rows."""

    commit: BivarCommitment
    rows: Tuple[bytes, ...]  # rows[j] encrypts Poly f(j+1, ·) to node j

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Part)
            and self.commit == other.commit
            and self.rows == other.rows
        )


@dataclass(frozen=True, slots=True)
class Ack:
    """An acker's per-node encrypted values for one proposer's part."""

    proposer_idx: int
    values: Tuple[bytes, ...]  # values[k] encrypts f(acker+1, k+1) to node k


def part_to_canonical(part: Part) -> Tuple:
    """Stable tuple form for signing / wire transport inside contributions."""
    return ("part", part.commit.to_bytes(), list(part.rows))


def part_from_canonical(group: Group, t) -> Part:
    tag, commit_bytes, rows = t
    if tag != "part":
        raise ValueError("not a part")
    return Part(BivarCommitment.from_bytes(group, commit_bytes), tuple(rows))


def ack_to_canonical(ack: Ack) -> Tuple:
    return ("ack", ack.proposer_idx, list(ack.values))


def ack_from_canonical(t) -> Ack:
    tag, proposer_idx, values = t
    if tag != "ack":
        raise ValueError("not an ack")
    return Ack(proposer_idx, tuple(values))


@dataclass(slots=True)
class PartOutcome:
    ack: Optional[Ack] = None
    fault: Optional[str] = None


@dataclass(slots=True)
class AckOutcome:
    fault: Optional[str] = None


class _ProposalState:
    #: lazy Commitment to f(·, our_idx+1); CLASS-level default so snapshots
    #: taken before this cache existed restore cleanly (snapshot.py rebuilds
    #: via __new__ + setattr of saved attributes only)
    our_col = None

    def __init__(self, commit: BivarCommitment) -> None:
        self.commit = commit
        self.acks: set = set()  # acker indices
        self.values: Dict[int, int] = {}  # acker_idx -> our decrypted value

    def is_complete(self, threshold: int) -> bool:
        return len(self.acks) > 2 * threshold


class SyncKeyGen:
    """One node's view of a running DKG session.

    Construct with :meth:`new` (mirrors the reference's
    ``SyncKeyGen::new → (SyncKeyGen, Option<Part>)``).
    """

    def __init__(
        self,
        our_id: Any,
        secret_key: SecretKey,
        pub_keys: Dict[Any, PublicKey],
        threshold: int,
        group: Group,
    ) -> None:
        self.our_id = our_id
        self.secret_key = secret_key
        self.pub_keys = dict(pub_keys)
        self.threshold = threshold
        self.G = group
        self.ids: List[Any] = sorted(pub_keys.keys())
        self.index: Dict[Any, int] = {n: i for i, n in enumerate(self.ids)}
        self.parts: Dict[int, _ProposalState] = {}
        self._early_acks: Dict[int, List[Tuple[Any, Ack]]] = {}

    @staticmethod
    def new(
        our_id: Any,
        secret_key: SecretKey,
        pub_keys: Dict[Any, PublicKey],
        threshold: int,
        rng,
        group: Group,
    ) -> Tuple["SyncKeyGen", Optional[Part]]:
        kg = SyncKeyGen(our_id, secret_key, pub_keys, threshold, group)
        if our_id not in kg.index:
            return kg, None  # observers don't propose
        bivar = BivarPoly.random(group, threshold, rng)
        commit = bivar.commitment()
        rows = []
        for j, node in enumerate(kg.ids):
            row = bivar.row(j + 1)
            payload = canonical.encode([c for c in row.coeffs])
            rows.append(pub_keys[node].encrypt(payload, rng).to_bytes())
        return kg, Part(commit, tuple(rows))

    # -- our index helpers ---------------------------------------------------

    def our_idx(self) -> Optional[int]:
        return self.index.get(self.our_id)

    def is_node_ready(self, proposer_id: Any) -> bool:
        idx = self.index.get(proposer_id)
        return idx is not None and idx in self.parts and self.parts[idx].is_complete(
            self.threshold
        )

    def count_complete(self) -> int:
        return sum(1 for ps in self.parts.values() if ps.is_complete(self.threshold))

    def is_ready(self) -> bool:
        return self.count_complete() > self.threshold

    # -- Part ----------------------------------------------------------------

    def handle_part(self, sender_id: Any, part: Part, rng) -> PartOutcome:
        sender_idx = self.index.get(sender_id)
        if sender_idx is None:
            return PartOutcome(fault="sync_key_gen:part_from_non_member")
        if not isinstance(part, Part) or not isinstance(part.commit, BivarCommitment):
            return PartOutcome(fault="sync_key_gen:malformed_part")
        if sender_idx in self.parts:
            if self.parts[sender_idx].commit == part.commit:
                return PartOutcome()  # duplicate
            return PartOutcome(fault="sync_key_gen:multiple_parts")
        if part.commit.degree() != self.threshold or len(part.rows) != len(self.ids):
            return PartOutcome(fault="sync_key_gen:invalid_part_degree")
        state = _ProposalState(part.commit)
        self.parts[sender_idx] = state
        # Drain acks that raced ahead of this part.
        for acker_id, ack in self._early_acks.pop(sender_idx, []):
            self._apply_ack(acker_id, ack)

        our_idx = self.our_idx()
        if our_idx is None:
            return PartOutcome()  # observer: record the commitment only
        # Decrypt and verify our row.
        try:
            ct = Ciphertext.from_bytes(self.G, part.rows[our_idx])
            payload = self.secret_key.decrypt(ct)
            coeffs = canonical.decode(payload) if payload is not None else None
            if not isinstance(coeffs, list) or not all(
                isinstance(c, int) for c in coeffs
            ):
                raise ValueError
            row = Poly(self.G, coeffs)
        except (ValueError, IndexError, TypeError):
            return PartOutcome(fault="sync_key_gen:invalid_row_encryption")
        if row.degree() != self.threshold or row.commitment() != part.commit.row(
            our_idx + 1
        ):
            return PartOutcome(fault="sync_key_gen:row_commitment_mismatch")
        # Build our Ack: encrypt row(k+1) to each node k.
        values = []
        for k, node in enumerate(self.ids):
            v = row.evaluate(k + 1)
            values.append(
                self.pub_keys[node].encrypt(canonical.encode(v), rng).to_bytes()
            )
        return PartOutcome(ack=Ack(sender_idx, tuple(values)))

    # -- Ack -----------------------------------------------------------------

    def handle_ack(self, sender_id: Any, ack: Ack) -> AckOutcome:
        acker_idx = self.index.get(sender_id)
        if acker_idx is None:
            return AckOutcome(fault="sync_key_gen:ack_from_non_member")
        if (
            not isinstance(ack, Ack)
            or not isinstance(ack.proposer_idx, int)
            or not 0 <= ack.proposer_idx < len(self.ids)
            or len(ack.values) != len(self.ids)
        ):
            return AckOutcome(fault="sync_key_gen:malformed_ack")
        if ack.proposer_idx not in self.parts:
            # The part may be committed later in the same batch: buffer.
            self._early_acks.setdefault(ack.proposer_idx, []).append(
                (sender_id, ack)
            )
            return AckOutcome()
        return self._apply_ack(sender_id, ack)

    def _apply_ack(self, sender_id: Any, ack: Ack) -> AckOutcome:
        acker_idx = self.index[sender_id]
        state = self.parts[ack.proposer_idx]
        if acker_idx in state.acks:
            return AckOutcome()  # duplicate
        our_idx = self.our_idx()
        if our_idx is not None:
            try:
                ct = Ciphertext.from_bytes(self.G, ack.values[our_idx])
                payload = self.secret_key.decrypt(ct)
                v = canonical.decode(payload) if payload is not None else None
                if not isinstance(v, int):
                    raise ValueError
            except (ValueError, IndexError, TypeError):
                return AckOutcome(fault="sync_key_gen:invalid_ack_encryption")
            # Cross-check against the commitment:
            # f_p(acker+1, our+1) · G1 == commit(acker+1, our+1).
            # The receiver coordinate is fixed for every ack of this part,
            # so the column commitment is computed once and each ack costs
            # one univariate evaluation (t+1 ops, not (t+1)²).
            if state.our_col is None:
                state.our_col = state.commit.col(our_idx + 1)
            expect = state.our_col.evaluate(acker_idx + 1)
            if self.G.g1_mul(v, self.G.g1()) != expect:
                return AckOutcome(fault="sync_key_gen:ack_value_mismatch")
            state.values[acker_idx] = v
        state.acks.add(acker_idx)
        return AckOutcome()

    # -- output --------------------------------------------------------------

    def generate(self) -> Tuple[PublicKeySet, Optional[SecretKeyShare]]:
        """Produce the master public key set and (for members) our share.

        Uses the first t+1 *complete* parts in proposer-index order — the
        same deterministic choice on every node.
        """
        if not self.is_ready():
            raise ValueError("key generation not complete")
        complete = sorted(
            idx
            for idx, ps in self.parts.items()
            if ps.is_complete(self.threshold)
        )[: self.threshold + 1]
        # Master commitment: Σ_p commit_p.row(0).
        master_commit: Optional[Commitment] = None
        for idx in complete:
            row0 = self.parts[idx].commit.row(0)
            master_commit = row0 if master_commit is None else master_commit.add(row0)
        pk_set = PublicKeySet(master_commit)

        our_idx = self.our_idx()
        if our_idx is None:
            return pk_set, None
        from hbbft_tpu_torch.crypto.field import interpolate_at_zero

        share_val = 0
        for idx in complete:
            ps = self.parts[idx]
            pts = sorted(ps.values.items())[: self.threshold + 1]
            if len(pts) <= self.threshold:
                raise ValueError(
                    f"not enough verified ack values for part {idx}"
                )
            share_val = (
                share_val
                + interpolate_at_zero([(a + 1, v) for a, v in pts], self.G.r)
            ) % self.G.r
        return pk_set, SecretKeyShare(self.G, share_val)
