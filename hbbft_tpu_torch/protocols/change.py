"""Validator-set change requests and their lifecycle state.

Rebuild of `src/dynamic_honey_badger/change.rs` § (SURVEY.md §2.1):
`Change` is what validators vote on — add a node (with its public key),
remove a node, or alter the encryption schedule.  `ChangeState` is what a
`Batch` reports: no change pending, a winning change whose DKG is in
progress, or a change that completed (the era just restarted).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule


@dataclass(frozen=True, slots=True)
class Change:
    """kind ∈ {"add", "remove", "schedule"}."""

    kind: str
    node_id: Any = None
    pub_key_bytes: Optional[bytes] = None  # for "add"
    schedule: Optional[EncryptionSchedule] = None  # for "schedule"

    @staticmethod
    def add(node_id, pub_key_bytes: bytes) -> "Change":
        return Change("add", node_id=node_id, pub_key_bytes=pub_key_bytes)

    @staticmethod
    def remove(node_id) -> "Change":
        return Change("remove", node_id=node_id)

    @staticmethod
    def set_schedule(schedule: EncryptionSchedule) -> "Change":
        return Change("schedule", schedule=schedule)

    def to_canonical(self) -> Tuple:
        """Stable tuple used in vote signatures and wire encoding."""
        if self.kind == "schedule":
            s = self.schedule
            return ("schedule", s.kind, s.n, s.m)
        return (self.kind, self.node_id, self.pub_key_bytes)

    @staticmethod
    def from_canonical(t) -> "Change":
        if not isinstance(t, tuple) or not t:
            raise ValueError("malformed change")
        if t[0] == "schedule":
            _, kind, n, m = t
            if kind not in ("always", "never", "every_nth", "tick_tock") or not (
                isinstance(n, int) and isinstance(m, int)
            ):
                raise ValueError("malformed schedule change")
            return Change.set_schedule(EncryptionSchedule(kind, n, m))
        if t[0] in ("add", "remove"):
            node_id = t[1]
            hash(node_id)  # reject unhashable node ids: TypeError
            if t[0] == "add":
                if not isinstance(t[2], bytes):
                    raise ValueError("add change requires a public key")
                return Change.add(node_id, t[2])
            return Change.remove(node_id)
        raise ValueError(f"unknown change kind {t[0]!r}")


@dataclass(frozen=True, slots=True)
class ChangeState:
    """kind ∈ {"none", "in_progress", "complete"}."""

    kind: str
    change: Optional[Change] = None

    @staticmethod
    def none() -> "ChangeState":
        return ChangeState("none")

    @staticmethod
    def in_progress(change: Change) -> "ChangeState":
        return ChangeState("in_progress", change)

    @staticmethod
    def complete(change: Change) -> "ChangeState":
        return ChangeState("complete", change)
