"""The port's ``net/generators.py`` and ``net/test_network.py`` against the
JAX package's: the generators draw the same messages from the same rng, the
legacy ``TestNetwork`` harness gives the same outputs, and every case of the
reference's ``test_adversarial.py`` (garbage injection into each protocol
layer, and the forged DynamicHoneyBadger vote) gives the same decisions,
faults, deliveries and counters, each package on its own ``MockBackend``."""

import dataclasses
import random
import types

import pytest

from test_torch_protocols import PORT, REF, summary

PROTOCOLS = ["broadcast", "binary_agreement", "subset", "honey_badger"]


def draws(P, protocol, seed, n=7, k=40):
    net = types.SimpleNamespace(rng=random.Random(seed), nodes=dict.fromkeys(range(n)),
                                backend=P.backend.MockBackend())
    gen = P.gen.generator_for(protocol)
    out = [P.wire.encode_message(gen(net, None)) for _ in range(k)]
    return out + [net.rng.random()]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_generator_draws_equal_the_reference(protocol):
    for seed in range(3):
        assert draws(PORT, protocol, seed) == draws(REF, protocol, seed)
    with pytest.raises(ValueError, match="no generator"):
        draws(PORT, "nope", 0)


# -- TestNetwork (test_test_network.py) ----------------------------------------------


def legacy(P, n, adv, sched, adversary, seed, value):
    ba = lambda ni, be: P.ba.BinaryAgreement(ni, be, session_id=b"legacy")  # noqa: E731
    tn = P.tn.TestNetwork(n - adv, adv, ba, backend=P.backend.MockBackend(),
                          scheduler=getattr(P.tn.MessageScheduler, sched),
                          adversary=adversary(P) if adversary else None, seed=seed)
    stepped = None
    if value is None:
        for i in range(n):
            tn.input(i, i % 2 == 0)
    else:
        tn.input_all(value)
        before = tn.net.messages_delivered
        got = tn.step()
        stepped = (got is not None, tn.net.messages_delivered - before)
    outs = tn.run()
    assert len({tuple(v) for v in outs.values()}) == 1
    return outs, stepped, summary(tn.net)


LEGACY = {
    "ba-random": (4, 0, "RANDOM", None, 11, None),
    "ba-first": (4, 0, "FIRST", None, 11, None),
    "stepwise-first": (4, 0, "FIRST", None, 3, True),
    "silent": (6, 1, "RANDOM", lambda P: P.tn.SilentAdversary(), 5, True),
    "flip-bool": (6, 1, "RANDOM", lambda P: P.tn.FlipBoolAdversary(), 9, False),
}


@pytest.mark.parametrize("name", list(LEGACY))
def test_test_network_equals_the_reference(name):
    ref, port = legacy(REF, *LEGACY[name]), legacy(PORT, *LEGACY[name])
    assert port == ref
    assert port[1] in (None, (True, 1))


def test_flip_bool_payload_equals_the_reference():
    @dataclasses.dataclass(frozen=True)
    class Inner:
        b: bool
        n: int

    @dataclasses.dataclass(frozen=True)
    class Msg:
        kind: str
        flag: bool
        inner: Inner

    msg, raw = Msg("x", True, Inner(False, 3)), object()
    got = []
    for P in (REF, PORT):
        adv = P.tn.FlipBoolAdversary()
        got.append((adv._flip_payload(msg), adv._flip_payload(raw) is raw))
    assert got[1] == got[0] == (Msg("x", False, Inner(True, 3)), True)


# -- garbage injection (test_adversarial.py) -----------------------------------------


def garbage(P, protocol, n, f, seed, make, value):
    net = (P.net(range(n)).num_faulty(f)
           .adversary(P.adv.RandomAdversary(P.gen.generator_for(protocol), p_replace=1.0))
           .crank_limit(2_000_000).using(make(P)).build(seed=seed))
    for i in sorted(net.nodes):
        v = value(i)
        if v is not None:
            net.send_input(i, v)
    net.crank_to_quiescence()
    return net


GARBAGE = {
    "broadcast": (7, 2, lambda P: lambda ni, be: P.bc.Broadcast(ni, proposer_id=0),
                  lambda i: b"garbage-resistant payload" if i == 0 else None, 3),
    "binary_agreement": (7, 2, lambda P: lambda ni, be: P.ba.BinaryAgreement(
        ni, be, session_id=b"adv-ba"), lambda i: i % 2 == 0, 3),
    "subset": (7, 2, lambda P: lambda ni, be: P.ss.Subset(ni, be, session_id=b"adv-subset"),
               lambda i: b"contribution-%d" % i, 3),
    "honey_badger": (4, 1, lambda P: lambda ni, be: P.hb.HoneyBadger(
        ni, be, session_id=b"adv-hb"), lambda i: ("tx", i), 2),
}
GARBAGE_CASES = [(p, s) for p, (*_, seeds) in GARBAGE.items() for s in range(seeds)]


@pytest.mark.parametrize("protocol, seed", GARBAGE_CASES,
                         ids=[f"{p}-s{s}" for p, s in GARBAGE_CASES])
def test_garbage_injection_equals_the_reference(protocol, seed):
    n, f, make, value, _ = GARBAGE[protocol]
    ref = summary(garbage(REF, protocol, n, f, seed, make, value))
    port = summary(garbage(PORT, protocol, n, f, seed, make, value))
    assert port == ref
    outs = [v for i, v in port["outputs"].items() if i not in port["faulty"]]
    if protocol == "subset":  # the same contribution set, in any order
        outs = [sorted(o[2:] for o in v if o[1] == "contribution") for v in outs]
        assert len(outs[0]) >= 5
    assert all(o == outs[0] for o in outs)
    if not (protocol == "broadcast" and 0 in port["faulty"]):
        assert outs[0]


def forged_vote(P):
    net = (P.net(range(4)).num_faulty(0).crank_limit(5_000_000)
           .using(lambda ni, be, rng: P.dhb.DynamicHoneyBadger(ni, be, rng=rng,
                                                               session_id=b"adv-dhb"))
           .build(seed=1))
    forger = 2
    algo = net.nodes[forger].algorithm
    algo.vote_for(P.change.Change.remove(3))
    v = algo._pending_votes[-1]
    algo._pending_votes[-1] = P.votes.SignedVote(v.voter, v.era, v.num, v.change,
                                                 b"\x00" * len(v.sig_bytes))
    for i in sorted(net.nodes):
        net._process_step(net.nodes[i], net.nodes[i].algorithm.propose(("tx", i)))
    net.crank_until(lambda n: all(len(node.outputs) >= 1 for node in n.correct_nodes()))
    for node in net.correct_nodes():
        if node.id != forger:
            assert [(f.node_id, f.kind) for f in node.faults_observed
                    if f.kind == "dynamic_honey_badger:invalid_vote_signature"] == [
                (forger, "dynamic_honey_badger:invalid_vote_signature")]
            assert not node.algorithm.vote_counter.tally()
    return net


def test_dhb_forged_vote_equals_the_reference():
    assert summary(forged_vote(PORT)) == summary(forged_vote(REF))


def test_test_network_defaults_to_the_card():
    """Without a backend the port's ``TestNetwork`` builds on
    ``TorchBackend()``, which asks for the card: without one it raises
    instead of running on the CPU or on the mock."""
    import torch

    ba = lambda ni, be: PORT.ba.BinaryAgreement(ni, be, session_id=b"legacy")  # noqa: E731
    if torch.cuda.is_available():
        tn = PORT.tn.TestNetwork(4, 0, ba)
        assert type(tn.net.backend).__name__ == "TorchBackend"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.tn.TestNetwork(4, 0, ba)
