"""Fault evidence log (hbbft `src/fault_log.rs` §, unverified — SURVEY.md).

Every protocol records *provable* misbehaviour by peers — an invalid Merkle
proof, a second conflicting ``Value``, a decryption share that fails its
pairing check — as a :class:`Fault` with a machine-readable kind string.  The
log rides on every :class:`~hbbft_tpu_torch.core.types.Step` and is the framework's
failure-detection subsystem (SURVEY.md §5).

Fault kinds are plain strings namespaced by protocol (``"broadcast:
invalid_proof"``) rather than per-module enums: the set is open (new protocols
add kinds freely) and strings serialize canonically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, FrozenSet, Iterator, List

#: The fault-kind registry: every provable-misbehaviour kind a protocol can
#: record, keyed by namespace prefix.  This is the single enumeration that
#: (a) the handler-exhaustiveness lint rule cross-references against the
#: ``Step.from_fault`` literals in each protocol module (an unregistered
#: kind — or a registered kind no protocol emits — breaks lint), (b) the
#: scenario matrix (net/scenarios.py) draws its expected-fault assertions
#: from, and (c) tests/test_scenarios.py walks so attack-vs-fault drift
#: breaks lint and tests together.  MUST stay a pure literal: the lint rule
#: reads it via ``ast.literal_eval`` without importing this module.
FAULT_KINDS = {
    "binary_agreement": (
        "coin_in_fixed_round",
        "conflicting_conf",
        "duplicate_term",
        "far_future_round",
        "malformed_coin",
        "malformed_conf",
        "malformed_message",
        "malformed_round",
        "malformed_sbv",
        "malformed_term",
        "non_validator_sender",
        "unknown_kind",
    ),
    # crash/restart axis (net/crash.py): recovery failures are attributed
    # evidence against the crashed node — a cell whose restart could not
    # complete fails its verdict visibly instead of crashing the harness
    "crash": (
        "checkpoint_failed",
        "recovery_failed",
        "replay_divergence",
    ),
    "broadcast": (
        "bad_length_prefix",
        "conflicting_echo",
        "conflicting_ready",
        "conflicting_values",
        "echo_from_non_validator",
        "inconsistent_shard_lengths",
        "invalid_echo_proof",
        "invalid_shard_encoding",
        "invalid_value_proof",
        "malformed_message",
        "malformed_ready",
        "multiple_echos",
        "multiple_readys",
        "multiple_values",
        "ready_from_non_validator",
        "undecodable_shards",
        "unknown_kind",
        "value_from_non_proposer",
    ),
    "dynamic_honey_badger": (
        "era_too_far_ahead",
        "future_era_from_non_member",
        "invalid_keygen_signature",
        "invalid_vote_signature",
        "malformed_contribution",
        "malformed_keygen",
        "malformed_message",
    ),
    "honey_badger": (
        "dec_share_in_plaintext_epoch",
        "dec_share_unknown_proposer",
        "epoch_too_far_ahead",
        "future_epoch_from_non_validator",
        "invalid_ciphertext",
        "invalid_contribution",
        "malformed_message",
        "unknown_kind",
        "unparseable_ciphertext",
    ),
    "sbv": (
        "malformed_message",
        "non_validator_sender",
    ),
    "sender_queue": (
        "malformed_epoch",
        "malformed_message",
        "unknown_kind",
    ),
    "subset": (
        "malformed_message",
        "unknown_kind",
        "unknown_proposer",
    ),
    "sync_key_gen": (
        "ack_from_non_member",
        "ack_value_mismatch",
        "invalid_ack_encryption",
        "invalid_part_degree",
        "invalid_row_encryption",
        "malformed_ack",
        "malformed_part",
        "multiple_parts",
        "part_from_non_member",
        "row_commitment_mismatch",
    ),
    "threshold_decrypt": (
        "invalid_share",
        "malformed_message",
        "non_validator_share",
    ),
    "threshold_sign": (
        "invalid_sig_share",
        "malformed_message",
        "non_validator_share",
    ),
}


def all_fault_kinds() -> FrozenSet[str]:
    """Every registered kind as its full ``"prefix:name"`` wire string."""
    return frozenset(
        f"{prefix}:{name}" for prefix, names in FAULT_KINDS.items() for name in names
    )


@dataclass(frozen=True, slots=True)
class Fault:
    """A single piece of evidence that ``node_id`` misbehaved."""

    node_id: Any
    kind: str

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"Fault({self.node_id!r}, {self.kind})"


@dataclass(slots=True)
class FaultLog:
    """An append-only list of :class:`Fault` entries."""

    entries: List[Fault] = field(default_factory=list)

    @staticmethod
    def init(node_id, kind: str) -> "FaultLog":
        return FaultLog([Fault(node_id, kind)])

    def append(self, fault: Fault) -> None:
        self.entries.append(fault)

    def report(self, node_id, kind: str) -> None:
        self.entries.append(Fault(node_id, kind))

    def extend(self, other: "FaultLog") -> None:
        self.entries.extend(other.entries)

    def kinds_for(self, node_id) -> List[str]:
        return [f.kind for f in self.entries if f.node_id == node_id]

    def __iter__(self) -> Iterator[Fault]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)
