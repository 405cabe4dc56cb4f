"""Compact boolean-set helpers for BinaryAgreement.

Rebuilds `src/binary_agreement/{bool_set,bool_multimap}.rs` § (SURVEY.md
§2.1): a set over {False, True} packed into two bits, and a map from bool to
sets of node ids (who sent which value).
"""

from __future__ import annotations

from typing import Any, Iterator, Set


class BoolSet:
    """Immutable subset of {False, True}; NONE/FALSE/TRUE/BOTH."""

    __slots__ = ("bits",)

    def __init__(self, bits: int = 0) -> None:
        self.bits = bits & 3

    @staticmethod
    def none() -> "BoolSet":
        return BoolSet(0)

    @staticmethod
    def both() -> "BoolSet":
        return BoolSet(3)

    @staticmethod
    def single(b: bool) -> "BoolSet":
        return BoolSet(2 if b else 1)

    @staticmethod
    def from_iter(vals) -> "BoolSet":
        s = BoolSet(0)
        for v in vals:
            s = s.inserted(v)
        return s

    def inserted(self, b: bool) -> "BoolSet":
        return BoolSet(self.bits | (2 if b else 1))

    def union(self, other: "BoolSet") -> "BoolSet":
        return BoolSet(self.bits | other.bits)

    def contains(self, b: bool) -> bool:
        return bool(self.bits & (2 if b else 1))

    def contains_set(self, other: "BoolSet") -> bool:
        return (self.bits | other.bits) == self.bits

    def is_subset_of(self, other: "BoolSet") -> bool:
        return (self.bits & other.bits) == self.bits

    def definite(self):
        """The single value if a singleton, else None."""
        if self.bits == 1:
            return False
        if self.bits == 2:
            return True
        return None

    def __iter__(self) -> Iterator[bool]:
        if self.bits & 1:
            yield False
        if self.bits & 2:
            yield True

    def __len__(self) -> int:
        return (self.bits & 1) + ((self.bits >> 1) & 1)

    def __bool__(self) -> bool:
        return self.bits != 0

    def __eq__(self, other) -> bool:
        return isinstance(other, BoolSet) and self.bits == other.bits

    def __hash__(self) -> int:
        return hash(("BoolSet", self.bits))

    def __repr__(self) -> str:  # pragma: no cover
        return f"BoolSet({sorted(self)})"


class BoolMultimap:
    """Map bool -> set of node ids."""

    __slots__ = ("f", "t")

    def __init__(self) -> None:
        self.f: Set[Any] = set()
        self.t: Set[Any] = set()

    def __getitem__(self, b: bool) -> Set[Any]:
        return self.t if b else self.f

    def insert(self, b: bool, node_id) -> bool:
        """Insert; returns True if newly added."""
        s = self[b]
        if node_id in s:
            return False
        s.add(node_id)
        return True

    def senders(self) -> Set[Any]:
        return self.f | self.t
