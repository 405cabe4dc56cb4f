"""Broadcast — Bracha reliable broadcast with AVID-style erasure coding.

Rebuild of `src/broadcast/{broadcast,message}.rs` § (SURVEY.md §2.1): a
designated proposer disseminates a value; every correct node outputs the same
value or none, tolerating f Byzantine nodes among N > 3f.

Protocol: the proposer Reed–Solomon-encodes the (length-prefixed) value into
N−2f data + 2f parity shards, commits with a Merkle tree, and sends each node
its shard + proof as ``Value``.  Nodes re-multicast their shard as ``Echo``;
N−f matching Echoes trigger ``Ready(root)``; f+1 Readys trigger Ready
re-multicast (amplification); 2f+1 Readys + N−2f stored Echo shards allow
reconstruction.  The reconstructed value's re-computed Merkle root must match
— otherwise the *proposer* provably equivocated and is logged.

The RS encode/decode rides the matmul-shaped GF(2⁸) codec
(hbbft_tpu_torch/crypto/erasure.py) — on device this is an int8 matmul kernel
(BASELINE.json: "Reed–Solomon RBC as GF(2^8) matmul").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Set, Tuple

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import Step, Target, TargetedMessage
from hbbft_tpu_torch.crypto.erasure import RSCodec, rs_codec
from hbbft_tpu_torch.crypto.merkle import MerkleTree, Proof
from hbbft_tpu_torch.obs import critpath as _critpath


@dataclass(frozen=True, slots=True)
class BroadcastMessage:
    """kind ∈ {"value", "echo", "ready"}; payload: Proof | Proof | root bytes."""

    kind: str
    payload: Any

    @staticmethod
    def value(proof: Proof) -> "BroadcastMessage":
        return BroadcastMessage("value", proof)

    @staticmethod
    def echo(proof: Proof) -> "BroadcastMessage":
        return BroadcastMessage("echo", proof)

    @staticmethod
    def ready(root: bytes) -> "BroadcastMessage":
        return BroadcastMessage("ready", root)


class Broadcast(ConsensusProtocol):
    """One reliable-broadcast instance for a fixed ``proposer_id``."""

    def __init__(self, netinfo: NetworkInfo, proposer_id: Any) -> None:
        self.netinfo = netinfo
        self.proposer_id = proposer_id
        n = netinfo.num_nodes()
        f = netinfo.num_faulty()
        self.data_shards = n - 2 * f
        self.parity_shards = 2 * f
        self.codec = rs_codec(self.data_shards, self.parity_shards)
        self.echo_sent = False
        self.ready_sent = False
        self.has_value = False  # got proposer's Value (or we are proposer)
        self._value_proof: Optional[Proof] = None  # the Value we accepted
        self.echos: Dict[Any, Proof] = {}
        self.readys: Dict[Any, bytes] = {}
        self.output: Optional[bytes] = None
        self._decided = False

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.netinfo.our_id

    def terminated(self) -> bool:
        return self._decided

    def handle_input(self, input: bytes, rng=None) -> Step:
        return self.broadcast(input)

    def broadcast(self, value: bytes) -> Step:
        """Proposer entry point: shard, commit, disseminate."""
        if self.netinfo.our_id != self.proposer_id:
            raise ValueError("only the proposer can broadcast")
        if self.has_value:
            return Step()
        self.has_value = True
        framed = len(value).to_bytes(4, "big") + bytes(value)
        shards = self.codec.encode(framed)
        tree = MerkleTree(shards)
        step = Step()
        for i, node_id in enumerate(self.netinfo.all_ids()):
            proof = tree.proof(i)
            if node_id == self.netinfo.our_id:
                step.extend(self._handle_value(self.netinfo.our_id, proof))
            else:
                step.messages.append(
                    TargetedMessage(Target.node(node_id), BroadcastMessage.value(proof))
                )
        return step

    def handle_message(self, sender_id: Any, message: BroadcastMessage, rng=None) -> Step:
        if not isinstance(message, BroadcastMessage):
            return Step.from_fault(sender_id, "broadcast:malformed_message")
        if message.kind == "value":
            return self._handle_value(sender_id, message.payload)
        if message.kind == "echo":
            return self._handle_echo(sender_id, message.payload)
        if message.kind == "ready":
            return self._handle_ready(sender_id, message.payload)
        return Step.from_fault(sender_id, "broadcast:unknown_kind")

    # -- phases --------------------------------------------------------------

    def _validate_proof(self, proof: Any, expect_index: Optional[int]) -> bool:
        if not isinstance(proof, Proof):
            return False
        if expect_index is not None and proof.index != expect_index:
            return False
        return proof.validate(self.netinfo.num_nodes())

    def _handle_value(self, sender_id: Any, proof: Any) -> Step:
        if sender_id != self.proposer_id:
            return Step.from_fault(sender_id, "broadcast:value_from_non_proposer")
        if self.has_value and sender_id != self.netinfo.our_id:
            # Second Value under exactly-once delivery is provable either
            # way; a *different* proof is equivocation (two commitments
            # for one instance — the EquivocatingAdversary signature),
            # split from a plain re-send exactly like Echo/Ready.
            if self._value_proof is not None and proof != self._value_proof:
                return Step.from_fault(sender_id, "broadcast:conflicting_values")
            return Step.from_fault(sender_id, "broadcast:multiple_values")
        our_idx = self.netinfo.node_index(self.netinfo.our_id)
        if not self._validate_proof(proof, our_idx):
            return Step.from_fault(self.proposer_id, "broadcast:invalid_value_proof")
        # lint: allow[byzantine-input] the sender gate above is IDENTITY
        # equality against the instance's proposer (only the proposer may
        # send Value) — strictly stronger than set membership
        self.has_value = True
        self._value_proof = proof
        return self._send_echo(proof)

    def _send_echo(self, proof: Proof) -> Step:
        if self.echo_sent:
            return Step()
        self.echo_sent = True
        step = Step()
        step.messages.append(
            TargetedMessage(Target.all(), BroadcastMessage.echo(proof))
        )
        step.extend(self._handle_echo(self.netinfo.our_id, proof))
        return step

    def _handle_echo(self, sender_id: Any, proof: Any) -> Step:
        sender_idx = self.netinfo.node_index(sender_id)
        if sender_idx is None:
            return Step.from_fault(sender_id, "broadcast:echo_from_non_validator")
        if sender_id in self.echos:
            if self.echos[sender_id] == proof:
                # Re-sent Echo: provable misbehaviour under exactly-once
                # delivery (reference `Fault::MultipleEchos`), not a drop.
                return Step.from_fault(sender_id, "broadcast:multiple_echos")
            return Step.from_fault(sender_id, "broadcast:conflicting_echo")
        # An Echo must carry the *sender's* shard (AVID dispersal).
        if not self._validate_proof(proof, sender_idx):
            return Step.from_fault(sender_id, "broadcast:invalid_echo_proof")
        self.echos[sender_id] = proof
        step = Step()
        root = proof.root_hash
        if (
            self._count_echos(root) >= self.netinfo.num_correct()
            and not self.ready_sent
        ):
            step.extend(self._send_ready(root))
        return step.extend(self._try_decode())

    def _send_ready(self, root: bytes) -> Step:
        if self.ready_sent:
            return Step()
        self.ready_sent = True
        step = Step()
        step.messages.append(
            TargetedMessage(Target.all(), BroadcastMessage.ready(root))
        )
        step.extend(self._handle_ready(self.netinfo.our_id, root))
        return step

    def _handle_ready(self, sender_id: Any, root: Any) -> Step:
        if not isinstance(root, bytes) or len(root) != 32:
            return Step.from_fault(sender_id, "broadcast:malformed_ready")
        if self.netinfo.node_index(sender_id) is None:
            return Step.from_fault(sender_id, "broadcast:ready_from_non_validator")
        if sender_id in self.readys:
            if self.readys[sender_id] == root:
                # Re-sent Ready (reference `Fault::MultipleReadys`).
                return Step.from_fault(sender_id, "broadcast:multiple_readys")
            return Step.from_fault(sender_id, "broadcast:conflicting_ready")
        self.readys[sender_id] = root
        step = Step()
        f = self.netinfo.num_faulty()
        if self._count_readys(root) > f and not self.ready_sent:
            # Ready amplification: f+1 Readys imply a correct node saw N-f Echoes.
            step.extend(self._send_ready(root))
        return step.extend(self._try_decode())

    # -- decoding ------------------------------------------------------------

    def _count_echos(self, root: bytes) -> int:
        return sum(1 for p in self.echos.values() if p.root_hash == root)

    def _count_readys(self, root: bytes) -> int:
        return sum(1 for r in self.readys.values() if r == root)

    def _try_decode(self) -> Step:
        if self._decided:
            return Step()
        f = self.netinfo.num_faulty()
        # Find a root with ≥ 2f+1 Readys and ≥ N-2f stored Echo shards.
        # (sorted: at most one root can reach a Ready quorum — conflicting
        # Readys are rejected per sender — but candidate order must still be
        # replica-independent for the fault-evidence path below.)
        candidates: Set[bytes] = {r for r in self.readys.values()}
        for root in sorted(candidates):
            if self._count_readys(root) <= 2 * f:
                continue
            proofs = {
                self.netinfo.node_index(nid): p
                for nid, p in self.echos.items()
                if p.root_hash == root
            }
            if len(proofs) < self.data_shards:
                continue
            shard_slots = [proofs.get(i) for i in range(self.netinfo.num_nodes())]
            shards = [p.value if p is not None else None for p in shard_slots]
            # A Byzantine proposer can Merkle-commit to unequal-length shards;
            # every proof then validates individually.  Mismatched lengths
            # under a ready-quorum root are proof of proposer misbehaviour.
            lengths = {len(s) for s in shards if s is not None}
            if len(lengths) != 1:
                self._decided = True
                return Step.from_fault(
                    self.proposer_id, "broadcast:inconsistent_shard_lengths"
                )
            try:
                full = self.codec.reconstruct(shards)
            except ValueError:
                self._decided = True
                return Step.from_fault(self.proposer_id, "broadcast:undecodable_shards")
            # Re-commit: the reconstructed shard vector must hash to `root`,
            # otherwise the proposer encoded inconsistently.
            tree = MerkleTree(full)
            self._decided = True
            if tree.root_hash != root:
                return Step.from_fault(self.proposer_id, "broadcast:invalid_shard_encoding")
            framed = b"".join(full[: self.data_shards])
            length = int.from_bytes(framed[:4], "big")
            if length > len(framed) - 4:
                return Step.from_fault(self.proposer_id, "broadcast:bad_length_prefix")
            self.output = framed[4 : 4 + length]
            _critpath.stamp(
                "rbc.output",
                node=self.netinfo.our_id,
                instance=self.netinfo.node_index(self.proposer_id),
            )
            return Step.from_output(self.output)
        return Step()
