"""The port's object-runtime core against the JAX package's: the fault
registry, ``Target`` routing, ``Step`` and ``absorb_child_step`` (the cases
of ``tests/test_core.py`` and the deferred-work re-wrapping under them),
the ``ConsensusProtocol`` contract, and the ``MockBackend`` seam (its key
generation draws the net's RNG alike, its verdicts and counters)."""

import random

import pytest

from hbbft_tpu.core import fault_log as RF, protocol as RP, types as RT
from hbbft_tpu.core.network_info import NetworkInfo as RefNetworkInfo
from hbbft_tpu.crypto import backend as RB
from hbbft_tpu_torch.core import fault_log as PF, protocol as PP, types as PT
from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.crypto import backend as PB

SIDES = {"ref": (RT, RF), "port": (PT, PF)}


def test_fault_kinds_equal_the_reference():
    assert PF.FAULT_KINDS == RF.FAULT_KINDS
    assert PF.all_fault_kinds() == RF.all_fault_kinds()
    assert len(PF.all_fault_kinds()) == sum(len(v) for v in PF.FAULT_KINDS.values())


@pytest.mark.parametrize("form, arg", [("all", None), ("node", 2), ("nodes", [0, 3]),
                                       ("all_except", [2]), ("nodes", []), ("node", "x")])
@pytest.mark.parametrize("our_id", [0, 1, None])
def test_target_routing_equals_the_reference(form, arg, our_id):
    ids = [0, 1, 2, 3]
    got = {}
    for side, (T, _) in SIDES.items():
        t = getattr(T.Target, form)() if arg is None else getattr(T.Target, form)(arg)
        got[side] = (t.kind, t.ids, t.recipients(ids, our_id=our_id),
                     [t.contains(i, our_id=our_id) for i in ids + ["x"]])
    assert got["port"] == got["ref"]


def _step_case(T, F):
    """test_core.py's test_step_extend_and_absorb, with deferred work whose
    follow-up re-enters through the parent's wrapping."""
    s1 = T.Step.from_output("a")
    s2 = T.Step.from_msg(T.Target.all(), "m").add_fault(7, "k")
    s1.extend(s2)
    child = T.Step.from_output(10)
    child.messages.append(T.TargetedMessage(T.Target.node(1), "inner"))
    child.add_fault(3, "child-fault")

    def on_result(ok):
        follow = T.Step.from_output(21 if ok else 0)
        follow.messages.append(T.TargetedMessage(T.Target.nodes([2]), "late"))
        return follow.defer(T.CryptoWork("verify_dec_share", "again", lambda r: T.Step()))

    child.defer(T.CryptoWork("verify_sig_share", ("pk", "doc"), on_result, owner=5))
    parent = T.absorb_child_step(child, wrap_msg=lambda m: ("wrapped", m),
                                 on_output=lambda o: T.Step.from_output(o * 2))
    follow = parent.work[0].on_result(True)

    def flat(step):
        return (step.output, [(tm.target.kind, sorted(tm.target.ids, key=repr), tm.message)
                              for tm in step.messages],
                [(f.node_id, f.kind) for f in step.fault_log],
                [(w.kind, w.payload, w.owner) for w in step.work], bool(step))

    log = F.FaultLog.init(1, "a")
    log.report(2, "b")
    log.append(F.Fault(1, "c"))
    return (flat(s1), flat(parent), flat(follow), flat(T.Step()), flat(T.Step.from_fault(4, "x")),
            flat(s1.map_messages(lambda m: m + "!")), log.kinds_for(1), len(log), bool(log),
            flat(T.absorb_child_step(T.Step(), lambda m: m, lambda o: T.Step.from_output(o))))


def test_step_and_absorb_equal_the_reference():
    got = {side: _step_case(*mods) for side, mods in SIDES.items()}
    assert got["port"] == got["ref"]
    s1, parent, follow = got["port"][:3]
    assert s1[0] == ["a"] and parent[0] == [20] and follow[0] == [42]
    assert parent[1][0][2] == ("wrapped", "inner") and follow[1][0][2] == ("wrapped", "late")
    assert parent[3] == [("verify_sig_share", ("pk", "doc"), 5)]


def test_consensus_protocol_contract_equals_the_reference():
    assert (PP.ConsensusProtocol.__abstractmethods__
            == RP.ConsensusProtocol.__abstractmethods__
            == {"handle_input", "handle_message", "terminated", "our_id"})


def _mock_items(ni, backend, rng):
    """Sig-share and dec-share verify items from node 0's view, one of
    each tampered."""
    pks = ni[0].public_key_set
    doc = b"doc"
    sig_items = [(pks.public_key_share(i), doc, ni[i].secret_key_share.sign_share(doc))
                 for i in range(4)]
    sig_items.append((pks.public_key_share(0), doc, ni[1].secret_key_share.sign_share(doc)))
    ct = pks.encrypt(b"payload bytes", rng)
    dec_items = [(pks.public_key_share(i), ct, ni[i].secret_key_share.decrypt_share(ct))
                 for i in range(4)]
    dec_items.append((pks.public_key_share(2), ct, ni[3].secret_key_share.decrypt_share(ct)))
    return sig_items, dec_items, ct


@pytest.mark.parametrize("deferred", [False, True])
def test_mock_backend_equals_the_reference(deferred):
    """Both MockBackends from one seed: the same key material and RNG
    state after ``NetworkInfo.generate_map``, the same verdicts (through
    the synchronous or the deferred entry points), counters and
    combines."""
    got = {}
    for side, (mod, NI) in {"ref": (RB, RefNetworkInfo), "port": (PB, NetworkInfo)}.items():
        be = mod.MockBackend()
        rng = random.Random(6)
        ni = NI.generate_map(list(range(4)), rng, be)
        sig_items, dec_items, ct = _mock_items(ni, be, rng)
        pks = ni[0].public_key_set
        if deferred:
            verdicts = (be.verify_sig_shares_deferred(sig_items)(),
                        be.verify_dec_shares_deferred(dec_items)(),
                        be.verify_ciphertexts_deferred([ct])())
        else:
            verdicts = (be.verify_sig_shares(sig_items), be.verify_dec_shares(dec_items),
                        be.verify_ciphertexts([ct]))
        plain = be.combine_decryption_shares(pks, {i: dec_items[i][2] for i in (0, 2)}, ct)
        sig = be.combine_signatures(pks, {i: sig_items[i][2] for i in (1, 3)})
        counters = {k: v for k, v in be.counters.snapshot().items() if "seconds" not in k
                    and not k.startswith("host_bucket_")}
        got[side] = (pks.to_bytes(), [ni[i].secret_key_share.x for i in range(4)],
                     rng.random(), verdicts, plain, sig.to_bytes(), counters, be.name)
    assert got["port"][:-1] == got["ref"][:-1]
    assert got["port"][-1] == "MockBackend"
    verdicts = got["port"][3]
    assert verdicts[0] == [True] * 4 + [False]
    assert verdicts[1] == [True] * 4 + [False]
    assert verdicts[2] == [True]
    assert got["port"][4] == b"payload bytes"


def test_cpu_backend_is_the_golden_group():
    be = PB.CpuBackend()
    assert type(be.group).__name__ == type(RB.CpuBackend().group).__name__ == "BLS381Group"
    assert be.group.r == RB.CpuBackend().group.r
