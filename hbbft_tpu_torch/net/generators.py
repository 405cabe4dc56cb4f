"""Random well-typed message generators for :class:`RandomAdversary`.

Rebuild of the reference `RandomAdversary`'s message generation (SURVEY.md
§4: "tampers faulty nodes' traffic with random *well-typed* messages" via
proptest strategies).  Each generator produces a syntactically valid wire
message with adversarial content — valid types, garbage semantics — so the
receiving protocol exercises its validation / fault-attribution paths
rather than its `isinstance` guard.

All randomness comes from the net's seeded RNG: runs stay reproducible.
"""

from __future__ import annotations

import random
from typing import Any, Callable, List

from hbbft_tpu_torch.protocols.binary_agreement import BaMessage
from hbbft_tpu_torch.protocols.bool_set import BoolSet
from hbbft_tpu_torch.protocols.broadcast import BroadcastMessage
from hbbft_tpu_torch.protocols.honey_badger import HbMessage
from hbbft_tpu_torch.protocols.sbv_broadcast import SbvMessage
from hbbft_tpu_torch.protocols.subset import SubsetMessage
from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecryptMessage
from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSignMessage


def _rand_bytes(rng: random.Random, n: int = 32) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(n))


def random_proof(rng: random.Random, n_leaves: int):
    """A structurally valid Merkle proof with random content."""
    from hbbft_tpu_torch.crypto.merkle import Proof

    depth = max(1, (n_leaves - 1).bit_length())
    return Proof(
        value=_rand_bytes(rng, rng.randrange(1, 64)),
        index=rng.randrange(n_leaves),
        path=tuple(_rand_bytes(rng) for _ in range(depth)),
        root_hash=_rand_bytes(rng),
        n_leaves=n_leaves,
    )


def random_broadcast_message(rng: random.Random, n_nodes: int) -> BroadcastMessage:
    kind = rng.choice(["value", "echo", "ready"])
    if kind == "ready":
        return BroadcastMessage.ready(_rand_bytes(rng))
    proof = random_proof(rng, n_leaves=n_nodes)
    return BroadcastMessage(kind, proof)


def random_sig_share_message(rng: random.Random, group) -> ThresholdSignMessage:
    """A well-typed signature share whose element is random (won't verify)."""
    from hbbft_tpu_torch.crypto.keys import SignatureShare

    el = group.g2_mul(rng.randrange(1, 1 << 64), group.g2())
    return ThresholdSignMessage(SignatureShare(group, el))


def random_dec_share_message(rng: random.Random, group) -> ThresholdDecryptMessage:
    from hbbft_tpu_torch.crypto.keys import DecryptionShare

    el = group.g1_mul(rng.randrange(1, 1 << 64), group.g1())
    return ThresholdDecryptMessage(DecryptionShare(group, el))


def random_ba_message(rng: random.Random, group) -> BaMessage:
    rnd = rng.randrange(0, 4)
    kind = rng.choice(["sbv", "conf", "coin", "term"])
    if kind == "sbv":
        payload: Any = SbvMessage(rng.choice(["bval", "aux"]), rng.random() < 0.5)
    elif kind == "conf":
        payload = BoolSet(rng.randrange(4))
    elif kind == "coin":
        payload = random_sig_share_message(rng, group)
    else:
        payload = rng.random() < 0.5
    return BaMessage(rnd, kind, payload)


def random_subset_message(
    rng: random.Random, proposers: List[Any], n_nodes: int, group
) -> SubsetMessage:
    proposer = rng.choice(proposers)
    if rng.random() < 0.5:
        return SubsetMessage(
            proposer, "broadcast", random_broadcast_message(rng, n_nodes)
        )
    return SubsetMessage(proposer, "agreement", random_ba_message(rng, group))


def random_hb_message(
    rng: random.Random, proposers: List[Any], n_nodes: int, group
) -> HbMessage:
    epoch = rng.randrange(0, 3)
    if rng.random() < 0.5:
        return HbMessage.subset(
            epoch, random_subset_message(rng, proposers, n_nodes, group)
        )
    return HbMessage(
        epoch,
        "dec_share",
        rng.choice(proposers),
        random_dec_share_message(rng, group),
    )


def generator_for(protocol: str) -> Callable:
    """``RandomAdversary`` generator for a protocol name.

    The returned callable has the adversary's ``(net, msg) -> payload``
    shape; node ids and the group come from the live net.
    """

    def gen(net, msg):
        rng = net.rng
        ids = sorted(net.nodes)
        group = net.backend.group
        if protocol == "broadcast":
            return random_broadcast_message(rng, len(ids))
        if protocol == "binary_agreement":
            return random_ba_message(rng, group)
        if protocol == "subset":
            return random_subset_message(rng, ids, len(ids), group)
        if protocol == "honey_badger":
            return random_hb_message(rng, ids, len(ids), group)
        raise ValueError(f"no generator for {protocol!r}")

    return gen
