"""The port's wire codec against the JAX package's: the same registry, and
for every ``WIRE_VARIANTS`` example (the table of
``test_wire_properties.py`` and the envelopes of ``test_wire.py``), built in
both packages from the same seed, the port's bytes equal the reference's,
each package decodes the other's bytes back to the same encoding, and
malformed or tampered bytes are rejected alike."""

import importlib
import random

import pytest


class Pkg:
    def __init__(self, root):
        def imp(path):
            return importlib.import_module(f"{root}.{path}")

        self.backend = imp("crypto.backend")
        self.keys = imp("crypto.keys")
        self.merkle = imp("crypto.merkle")
        self.ba = imp("protocols.binary_agreement")
        self.bs = imp("protocols.bool_set")
        self.bc = imp("protocols.broadcast")
        self.dhb = imp("protocols.dynamic_honey_badger")
        self.hb = imp("protocols.honey_badger")
        self.sbv = imp("protocols.sbv_broadcast")
        self.sq = imp("protocols.sender_queue")
        self.ss = imp("protocols.subset")
        self.td = imp("protocols.threshold_decrypt")
        self.ts = imp("protocols.threshold_sign")
        self.wire = imp("utils.wire")
        self.canonical = imp("utils.canonical")
        self.group = self.backend.MockBackend().group


REF, PORT = Pkg("hbbft_tpu"), Pkg("hbbft_tpu_torch")


def examples(P):
    """Representative messages for every (class, kind) of the registry."""
    rng = random.Random(11)
    sks = P.keys.SecretKeySet.random(P.group, 1, rng)
    sig = sks.secret_key_share(0).sign_share(b"doc")
    ct = sks.public_keys().public_key().encrypt(b"wire-prop-plaintext!", rng)
    dec = sks.secret_key_share(1).decrypt_share_unchecked(ct)
    tree = P.merkle.MerkleTree([bytes([i]) * 8 for i in range(6)])
    sbv, ba, bc, ss, hb = P.sbv.SbvMessage, P.ba.BaMessage, P.bc.BroadcastMessage, P.ss, P.hb
    tsig, tdec = P.ts.ThresholdSignMessage(sig), P.td.ThresholdDecryptMessage(dec)
    ready = bc.ready(tree.root_hash)
    hb_msg = hb.HbMessage.subset(1, ss.SubsetMessage(2, "agreement", ba.term(0, False)))
    deep = hb.HbMessage.subset(4, ss.SubsetMessage(3, "broadcast", bc.ready(b"\x07" * 32)))
    return {
        ("SbvMessage", "bval"): [sbv.bval(False), sbv.bval(True)],
        ("SbvMessage", "aux"): [sbv.aux(True), sbv.aux(False)],
        ("ThresholdSignMessage", None): [tsig],
        ("ThresholdDecryptMessage", None): [tdec],
        ("BroadcastMessage", "value"): [bc.value(tree.proof(1)), bc.value(tree.proof(2))],
        ("BroadcastMessage", "echo"): [bc.echo(tree.proof(3)), bc.echo(tree.proof(5))],
        ("BroadcastMessage", "ready"): [ready],
        ("BaMessage", "sbv"): [ba.sbv(4, sbv.bval(True)), ba.sbv(0, sbv.bval(False))],
        ("BaMessage", "conf"): [ba.conf(2, P.bs.BoolSet.both())],
        ("BaMessage", "coin"): [ba.coin(5, tsig)],
        ("BaMessage", "term"): [ba.term(0, False), ba.term(7, True), ba.term(1, True)],
        ("SubsetMessage", "broadcast"): [ss.SubsetMessage(0, "broadcast", ready)],
        ("SubsetMessage", "agreement"): [ss.SubsetMessage(2, "agreement", ba.term(0, False))],
        ("HbMessage", "subset"): [hb_msg, deep],
        ("HbMessage", "dec_share"): [hb.HbMessage.dec_share(3, 1, tdec),
                                     hb.HbMessage.dec_share(9, 2, tdec)],
        ("DhbMessage", None): [P.dhb.DhbMessage(0, hb_msg),
                               P.dhb.DhbMessage(0, hb.HbMessage.dec_share(9, 2, tdec))],
        ("SqMessage", "epoch_started"): [P.sq.SqMessage.epoch_started(2, 9),
                                         P.sq.SqMessage.epoch_started(2, 7)],
        ("SqMessage", "algo"): [P.sq.SqMessage.algo(P.dhb.DhbMessage(1, hb_msg)),
                                P.sq.SqMessage.algo(P.dhb.DhbMessage(1, deep))],
    }


def test_registry_equals_the_reference():
    assert PORT.wire.WIRE_VARIANTS == REF.wire.WIRE_VARIANTS
    registered = {(cls, k) for cls, (_t, kinds) in PORT.wire.WIRE_VARIANTS.items()
                  for k in (kinds or (None,))}
    assert set(examples(PORT)) == registered == set(examples(REF))


VARIANTS = sorted(examples(REF), key=lambda k: (k[0], str(k[1])))


@pytest.mark.parametrize("variant", VARIANTS, ids=[f"{c}-{k}" for c, k in VARIANTS])
def test_variant_bytes_equal_the_reference(variant):
    ref_msgs, port_msgs = examples(REF)[variant], examples(PORT)[variant]
    for ref_msg, port_msg in zip(ref_msgs, port_msgs, strict=True):
        data = REF.wire.encode_message(ref_msg)
        assert PORT.wire.encode_message(port_msg) == data
        # each package decodes the other's bytes to the same message
        out = PORT.wire.decode_message(data, PORT.group)
        assert type(out).__name__ == variant[0] and type(out).__module__.startswith(
            "hbbft_tpu_torch.")
        assert getattr(out, "kind", None) == variant[1] or variant[1] is None
        assert PORT.wire.encode_message(out) == data
        back = REF.wire.decode_message(PORT.wire.encode_message(out), REF.group)
        assert REF.wire.encode_message(back) == data


def malformed(P):
    c = P.canonical.encode
    return [
        b"\xff\x00garbage",
        c(("sbv", "bval", 1)),
        c(("ba", -1, "term", True)),
        c(("ba", 0, "conf", 9)),
        c(("bc", "ready", b"short")),
        c(("hb", 0, "subset", 1, ("sbv", "bval", True))),
        c(("nope", 1)),
        c(("dhb", -1, ("sbv", "bval", True))),
        c(("sq", "epoch_started", (-1, 0))),
        c(("sq", "other", 1)),
        b"",
    ]


def outcome(P, data):
    try:
        return ("ok", P.wire.encode_message(P.wire.decode_message(data, P.group)))
    except P.wire.WireError as e:
        return ("WireError", str(e))
    except Exception as e:  # the reference's own outcome, whatever it is
        return (type(e).__name__, str(e))


def test_malformed_bytes_rejected_alike():
    ref, port = malformed(REF), malformed(PORT)
    assert port == ref
    got = [(outcome(REF, d), outcome(PORT, d)) for d in ref]
    assert [p for _, p in got] == [r for r, _ in got]
    assert all(p[0] == "WireError" for _, p in got[:7])


def test_tampered_bytes_rejected_alike():
    """Every single-byte flip of every example's encoding: both codecs give
    the same outcome (the same re-encoding, or the same rejection)."""
    n = 0
    for variant in VARIANTS:
        for msg in examples(REF)[variant]:
            data = REF.wire.encode_message(msg)
            for pos in range(0, len(data), max(1, len(data) // 24)):
                broken = bytearray(data)
                broken[pos] ^= 0xFF
                assert outcome(PORT, bytes(broken)) == outcome(REF, bytes(broken)), (variant, pos)
                n += 1
    assert n > 300
