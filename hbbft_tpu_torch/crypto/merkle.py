"""SHA-256 Merkle tree over erasure-coded shards.

Replaces the reference's `src/broadcast/merkle.rs` § (SURVEY.md §2.1): the
proposer commits to the shard vector with a Merkle root; each `Value`/`Echo`
carries a shard plus its inclusion proof, so receivers can attribute a bad
shard to the proposer (FaultLog evidence) before reconstruction.

The implementation is host-side hashlib ON PURPOSE (SURVEY.md §2.2 allows
a profile-driven host fallback): profiling a full QHB epoch (N=20 mock,
round 2) puts proof validation at ~2.7% of wall time — the O(N²) Echo
verifies scale with the same N² message count that dominates the host
protocol layer, so hashing stays a constant few percent and a device/SIMD
hash kernel would not move the epoch rate.  Revisit if the host message
path gets >10x faster (see PERF.md).  The port's copy of the JAX
package's ``crypto/merkle.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


def _h_leaf(data: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + data).digest()


def _h_node(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


@dataclass(frozen=True)
class Proof:
    """Inclusion proof: a leaf value, its index, the sibling path, the root.

    Mirrors `merkle::Proof` § — carried inside Broadcast `Value`/`Echo`
    messages.
    """

    value: bytes
    index: int
    path: Tuple[bytes, ...]
    root_hash: bytes
    n_leaves: int

    def validate(self, n_leaves: int) -> bool:
        """Check the proof against its own root for a tree of ``n_leaves``."""
        if n_leaves != self.n_leaves or not 0 <= self.index < n_leaves:
            return False
        if len(self.path) != _depth(n_leaves):
            return False
        acc = _h_leaf(self.value)
        idx = self.index
        for sib in self.path:
            acc = _h_node(acc, sib) if idx % 2 == 0 else _h_node(sib, acc)
            idx //= 2
        return acc == self.root_hash

    def to_bytes(self) -> bytes:
        out = [
            self.index.to_bytes(2, "big"),
            self.n_leaves.to_bytes(2, "big"),
            self.root_hash,
            len(self.path).to_bytes(1, "big"),
            b"".join(self.path),
            len(self.value).to_bytes(4, "big"),
            self.value,
        ]
        return b"".join(out)

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        index = int.from_bytes(data[0:2], "big")
        n_leaves = int.from_bytes(data[2:4], "big")
        root = data[4:36]
        plen = data[36]
        path = tuple(data[37 + i * 32 : 37 + (i + 1) * 32] for i in range(plen))
        off = 37 + plen * 32
        vlen = int.from_bytes(data[off : off + 4], "big")
        value = data[off + 4 : off + 4 + vlen]
        return Proof(value, index, path, root, n_leaves)


def _depth(n_leaves: int) -> int:
    d = 0
    size = 1
    while size < n_leaves:
        size *= 2
        d += 1
    return d


class MerkleTree:
    """Merkle tree over a shard vector, padded to a power of two with empty
    leaves (distinct from real leaves via the 0x00/0x01 domain tags)."""

    def __init__(self, leaves: Sequence[bytes]) -> None:
        if not leaves:
            raise ValueError("empty tree")
        self.leaves = list(leaves)
        n = len(leaves)
        size = 1 << _depth(n)
        level = [_h_leaf(v) for v in self.leaves] + [
            _h_leaf(b"") for _ in range(size - n)
        ]
        self.levels: List[List[bytes]] = [level]
        while len(level) > 1:
            level = [
                _h_node(level[i], level[i + 1]) for i in range(0, len(level), 2)
            ]
            self.levels.append(level)

    @classmethod
    def from_levels(
        cls, leaves: Sequence[bytes], levels: Sequence[Sequence[bytes]]
    ) -> "MerkleTree":
        """Adopt already-computed hash levels without re-hashing — the
        device erasure/hash plane (ops/backend.py merkle_build_batch)
        hashes all trees in one batched SHA-256 dispatch and hands the
        fetched levels here.  Callers guarantee ``levels`` is exactly
        what ``__init__`` would have computed for ``leaves``."""
        t = cls.__new__(cls)
        t.leaves = list(leaves)
        t.levels = [list(lvl) for lvl in levels]
        return t

    @property
    def root_hash(self) -> bytes:
        return self.levels[-1][0]

    def proof(self, index: int) -> Proof:
        if not 0 <= index < len(self.leaves):
            raise IndexError(index)
        path = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx ^ 1
            path.append(level[sib])
            idx //= 2
        return Proof(
            value=self.leaves[index],
            index=index,
            path=tuple(path),
            root_hash=self.root_hash,
            n_leaves=len(self.leaves),
        )


class PackedProofs:
    """Every (tree, leaf-index) inclusion proof of many same-shape trees
    as rectangular arrays — the array engine's N² proof workload without
    N² ``Proof`` Python objects (value bytes + path tuples + per-proof
    validate calls dominated the round-5 "host: everything else" bucket
    at N=100; the packed form is a handful of numpy gathers per tree).

    Row order is tree-major, leaf-index minor — identical to
    ``[trees[p].proof(s) for p in ids for s in range(n_leaves)]`` — so
    :meth:`validate` returns the same boolean list the object path does.
    """

    def __init__(self, leaves, paths, indices, roots, n_leaves: int) -> None:
        self.leaves = leaves  # (T·n, leaf_len) uint8
        self.paths = paths  # (T·n, depth, 32) uint8
        self.indices = indices  # (T·n,) int32
        self.roots = roots  # (T·n, 32) uint8
        self.n_leaves = n_leaves

    def __len__(self) -> int:
        return self.leaves.shape[0]

    @classmethod
    def from_trees(
        cls, trees: Sequence["MerkleTree"], n_leaves: int
    ) -> Optional["PackedProofs"]:
        """Pack all proofs of ``trees`` (each with ``n_leaves`` real
        leaves of one uniform length).  Returns None when the native
        SHA kernel is unavailable or the shapes don't fit its limits —
        callers fall back to per-proof objects."""
        import numpy as np

        from hbbft_tpu_torch import native

        if not trees or not native.sha256_available():
            return None
        leaf_len = len(trees[0].leaves[0])
        if leaf_len + 1 > 4096:
            return None
        for t in trees:
            if len(t.leaves) != n_leaves or any(
                len(v) != leaf_len for v in t.leaves
            ):
                return None
        depth = _depth(n_leaves)
        idx = np.arange(n_leaves, dtype=np.int64)
        per_tree_paths = []
        for t in trees:
            # level d's sibling of leaf i is node (i >> d) ^ 1 — one
            # gather per level instead of n_leaves Python proof walks
            cols = []
            for d in range(depth):
                lvl = np.frombuffer(
                    b"".join(t.levels[d]), dtype=np.uint8
                ).reshape(len(t.levels[d]), 32)
                cols.append(lvl[(idx >> d) ^ 1])
            if depth:
                per_tree_paths.append(np.stack(cols, axis=1))
            else:
                per_tree_paths.append(np.zeros((n_leaves, 0, 32), np.uint8))
        leaves = np.frombuffer(
            b"".join(b"".join(t.leaves) for t in trees), dtype=np.uint8
        ).reshape(len(trees) * n_leaves, leaf_len)
        paths = np.concatenate(per_tree_paths, axis=0)
        indices = np.tile(
            np.arange(n_leaves, dtype=np.int32), len(trees)
        )
        roots = np.repeat(
            np.frombuffer(
                b"".join(t.root_hash for t in trees), dtype=np.uint8
            ).reshape(len(trees), 32),
            n_leaves,
            axis=0,
        )
        return cls(leaves, paths, indices, roots, n_leaves)

    def validate(self, reps: int = 1) -> List[bool]:
        """Validate every packed proof ``reps`` times through the C
        SHA-NI kernel — same per-proof booleans (and the same repeated
        hash WORKLOAD) as ``validate_proofs`` over the object form."""
        from hbbft_tpu_torch import native

        ok = native.merkle_validate_batch(
            self.leaves, self.paths, self.indices, self.roots, reps
        )
        if ok is None:  # kernel refused (shape limits): object fallback
            out = []
            for i in range(len(self)):
                p = Proof(
                    value=self.leaves[i].tobytes(),
                    index=int(self.indices[i]),
                    path=tuple(
                        self.paths[i, d].tobytes()
                        for d in range(self.paths.shape[1])
                    ),
                    root_hash=self.roots[i].tobytes(),
                    n_leaves=self.n_leaves,
                )
                good = True
                for _ in range(reps):
                    good = p.validate(self.n_leaves)
                out.append(good)
            return out
        return [bool(v) for v in ok]


def validate_proofs(proofs: Sequence[Proof], n_leaves: int, reps: int = 1) -> List[bool]:
    """Batched proof validation: the array engine's hash entry point.

    Validates each distinct proof ``reps`` times (N receivers each check
    the same honest echo — the repetition keeps the measured hash workload
    equal to N independent nodes without materializing N× Python objects).
    Returns one bool per distinct proof (identical across repetitions).

    Dispatches to the C SHA-NI batch kernel (hbbft_tpu_torch/native) when
    available, falling back to the hashlib loop.  Proofs are grouped by
    (value length, path depth) so each group packs into rectangular
    arrays; structural checks (leaf count, index range, depth) mirror
    Proof.validate and fail fast without hashing.
    """
    import numpy as np

    from hbbft_tpu_torch import native

    out = [False] * len(proofs)
    depth = _depth(n_leaves)
    groups: dict = {}
    for i, p in enumerate(proofs):
        if (
            p.n_leaves != n_leaves
            or not 0 <= p.index < n_leaves
            or len(p.path) != depth
            or len(p.root_hash) != 32
            or any(len(s) != 32 for s in p.path)
        ):
            continue  # structurally invalid: stays False, no hashing
        groups.setdefault(len(p.value), []).append(i)

    for leaf_len, idxs in groups.items():
        sub = [proofs[i] for i in idxs]
        ok = None
        if native.sha256_available() and leaf_len + 1 <= 4096:
            lv = np.frombuffer(
                b"".join(p.value for p in sub), dtype=np.uint8
            ).reshape(len(sub), leaf_len)
            if depth:
                paths = np.frombuffer(
                    b"".join(b"".join(p.path) for p in sub), dtype=np.uint8
                ).reshape(len(sub), depth, 32)
            else:
                paths = np.zeros((len(sub), 0, 32), dtype=np.uint8)
            indices = np.array([p.index for p in sub], dtype=np.int32)
            roots = np.frombuffer(
                b"".join(p.root_hash for p in sub), dtype=np.uint8
            ).reshape(len(sub), 32)
            ok = native.merkle_validate_batch(lv, paths, indices, roots, reps)
        if ok is None:  # hashlib fallback
            ok = []
            for p in sub:
                good = True
                for _ in range(reps):
                    good = p.validate(n_leaves)
                ok.append(good)
        for i, good in zip(idxs, ok):
            out[i] = bool(good)
    return out
