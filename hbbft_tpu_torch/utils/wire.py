"""Wire serialization for every protocol message type.

The reference serializes all wire messages with `bincode`+serde
(SURVEY.md §2.2) — canonical bytes on the network, no code execution on
decode.  This module is that discipline for the whole message hierarchy:

    QHB/DHB msg ⊃ HB msg ⊃ Subset msg ⊃ {Broadcast | BA msg ⊃ Coin msg}

``encode_message`` lowers a message object to a tagged canonical tree
(utils/canonical.py) and returns bytes; ``decode_message`` parses bytes
back into message objects, validating shapes as it goes — malformed input
raises :class:`WireError`, never executes code (unlike pickle).

Crypto payloads (signature/decryption shares, Merkle proofs) travel as
their own fixed to_bytes forms; decoding needs the ambient crypto
``group`` to reconstruct curve elements.
"""

from __future__ import annotations

from typing import Any

from hbbft_tpu_torch.crypto.keys import DecryptionShare, SignatureShare
from hbbft_tpu_torch.crypto.merkle import Proof
from hbbft_tpu_torch.protocols.binary_agreement import BaMessage
from hbbft_tpu_torch.protocols.bool_set import BoolSet
from hbbft_tpu_torch.protocols.broadcast import BroadcastMessage
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbMessage
from hbbft_tpu_torch.protocols.honey_badger import HbMessage
from hbbft_tpu_torch.protocols.sbv_broadcast import SbvMessage
from hbbft_tpu_torch.protocols.sender_queue import SqMessage
from hbbft_tpu_torch.protocols.subset import SubsetMessage
from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecryptMessage
from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSignMessage
from hbbft_tpu_torch.utils import canonical


class WireError(ValueError):
    """Malformed or unknown wire bytes."""


#: The wire-variant registry: every message class the codec speaks, mapped to
#: its (wire tag, kind-variant tuple), equal to the JAX package's.  The codec
#: below must speak every registered kind, and tests/test_torch_wire.py walks
#: the registry to prove canonical encode/decode round-trips byte-equal to
#: the JAX package's codec.
WIRE_VARIANTS = {
    "SbvMessage": ("sbv", ("bval", "aux")),
    "ThresholdSignMessage": ("tsig", ()),
    "ThresholdDecryptMessage": ("tdec", ()),
    "BroadcastMessage": ("bc", ("value", "echo", "ready")),
    "BaMessage": ("ba", ("sbv", "conf", "coin", "term")),
    "SubsetMessage": ("ss", ("broadcast", "agreement")),
    "HbMessage": ("hb", ("subset", "dec_share")),
    "DhbMessage": ("dhb", ()),
    "SqMessage": ("sq", ("epoch_started", "algo")),
}


def _to_tree(msg: Any) -> Any:
    if isinstance(msg, SbvMessage):
        if msg.kind not in ("bval", "aux"):
            raise WireError(f"bad sbv kind {msg.kind!r}")
        return ("sbv", msg.kind, bool(msg.value))
    if isinstance(msg, ThresholdSignMessage):
        return ("tsig", msg.share.to_bytes())
    if isinstance(msg, ThresholdDecryptMessage):
        return ("tdec", msg.share.to_bytes())
    if isinstance(msg, BroadcastMessage):
        if msg.kind in ("value", "echo"):
            return ("bc", msg.kind, msg.payload.to_bytes())
        if msg.kind == "ready":
            return ("bc", "ready", bytes(msg.payload))
        raise WireError(f"bad broadcast kind {msg.kind!r}")
    if isinstance(msg, BaMessage):
        if msg.kind == "sbv":
            inner: Any = _to_tree(msg.payload)
        elif msg.kind == "conf":
            inner = msg.payload.bits
        elif msg.kind == "coin":
            inner = _to_tree(msg.payload)
        elif msg.kind == "term":
            inner = bool(msg.payload)
        else:
            raise WireError(f"bad ba kind {msg.kind!r}")
        return ("ba", msg.round, msg.kind, inner)
    if isinstance(msg, SubsetMessage):
        return ("ss", msg.proposer, msg.kind, _to_tree(msg.payload))
    if isinstance(msg, HbMessage):
        return ("hb", msg.epoch, msg.kind, msg.proposer, _to_tree(msg.payload))
    if isinstance(msg, DhbMessage):
        return ("dhb", msg.era, _to_tree(msg.payload))
    if isinstance(msg, SqMessage):
        if msg.kind == "epoch_started":
            era, epoch = msg.payload
            return ("sq", "epoch_started", (int(era), int(epoch)))
        if msg.kind == "algo":
            return ("sq", "algo", _to_tree(msg.payload))
        raise WireError(f"bad sender-queue kind {msg.kind!r}")
    raise WireError(f"unencodable message type {type(msg).__name__}")


def encode_message(msg: Any) -> bytes:
    """Message object → canonical wire bytes."""
    return canonical.encode(_to_tree(msg))


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise WireError(f"malformed {what}")


def _valid_id(x: Any) -> bool:
    """Node ids on the wire must be hashable canonical scalars (or tuples
    of them) — anything else is rejected before it can reach protocol
    dict lookups."""
    if x is None or isinstance(x, (bool, int, bytes, str)):
        return True
    return isinstance(x, tuple) and all(_valid_id(e) for e in x)


def _from_tree(t: Any, group) -> Any:
    _need(isinstance(t, tuple) and len(t) >= 2 and isinstance(t[0], str), "message")
    tag = t[0]
    if tag == "sbv":
        _need(len(t) == 3 and t[1] in ("bval", "aux") and isinstance(t[2], bool), "sbv")
        return SbvMessage(t[1], t[2])
    if tag == "tsig":
        _need(len(t) == 2 and isinstance(t[1], bytes), "tsig")
        return ThresholdSignMessage(SignatureShare.from_bytes(group, t[1]))
    if tag == "tdec":
        _need(len(t) == 2 and isinstance(t[1], bytes), "tdec")
        return ThresholdDecryptMessage(DecryptionShare.from_bytes(group, t[1]))
    if tag == "bc":
        _need(len(t) == 3 and isinstance(t[2], bytes), "broadcast")
        if t[1] in ("value", "echo"):
            try:
                proof = Proof.from_bytes(t[2])
            except Exception as e:
                raise WireError(f"bad proof bytes: {e}") from e
            return BroadcastMessage(t[1], proof)
        _need(t[1] == "ready" and len(t[2]) == 32, "ready")
        return BroadcastMessage("ready", t[2])
    if tag == "ba":
        _need(len(t) == 4 and isinstance(t[1], int) and t[1] >= 0, "ba")
        kind, inner = t[2], t[3]
        if kind == "sbv":
            payload: Any = _from_tree(inner, group)
            _need(isinstance(payload, SbvMessage), "ba sbv payload")
        elif kind == "conf":
            _need(isinstance(inner, int) and 0 <= inner <= 3, "ba conf")
            payload = BoolSet(inner)
        elif kind == "coin":
            payload = _from_tree(inner, group)
            _need(isinstance(payload, ThresholdSignMessage), "ba coin payload")
        elif kind == "term":
            _need(isinstance(inner, bool), "ba term")
            payload = inner
        else:
            raise WireError(f"bad ba kind {kind!r}")
        return BaMessage(t[1], kind, payload)
    if tag == "ss":
        _need(len(t) == 4 and t[2] in ("broadcast", "agreement"), "subset")
        _need(_valid_id(t[1]), "subset proposer")
        payload = _from_tree(t[3], group)
        if t[2] == "broadcast":
            _need(isinstance(payload, BroadcastMessage), "subset payload")
        else:
            _need(isinstance(payload, BaMessage), "subset payload")
        return SubsetMessage(t[1], t[2], payload)
    if tag == "hb":
        _need(len(t) == 5 and isinstance(t[1], int) and t[1] >= 0, "hb")
        _need(t[2] in ("subset", "dec_share"), "hb kind")
        _need(_valid_id(t[3]), "hb proposer")
        payload = _from_tree(t[4], group)
        if t[2] == "subset":
            _need(isinstance(payload, SubsetMessage), "hb payload")
        else:
            _need(isinstance(payload, ThresholdDecryptMessage), "hb payload")
        return HbMessage(t[1], t[2], t[3], payload)
    if tag == "dhb":
        _need(len(t) == 3 and isinstance(t[1], int) and t[1] >= 0, "dhb")
        payload = _from_tree(t[2], group)
        _need(isinstance(payload, HbMessage), "dhb payload")
        return DhbMessage(t[1], payload)
    if tag == "sq":
        _need(len(t) == 3, "sq")
        if t[1] == "epoch_started":
            _need(
                isinstance(t[2], tuple)
                and len(t[2]) == 2
                and all(isinstance(x, int) and x >= 0 for x in t[2]),
                "sq epoch_started",
            )
            return SqMessage("epoch_started", (t[2][0], t[2][1]))
        _need(t[1] == "algo", "sq kind")
        return SqMessage("algo", _from_tree(t[2], group))
    raise WireError(f"unknown wire tag {tag!r}")


def decode_message(data: bytes, group) -> Any:
    """Canonical wire bytes → message object (never executes code)."""
    try:
        tree = canonical.decode(data)
    except Exception as e:
        raise WireError(f"bad canonical bytes: {e}") from e
    return _from_tree(tree, group)
