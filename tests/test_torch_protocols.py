"""The port's object-runtime protocols against the JAX package's.

Every parametrised case of the reference's protocol tests
(``test_binary_agreement.py``, ``test_threshold_sign.py``,
``test_threshold_decrypt.py``, ``test_broadcast.py``, ``test_subset.py``,
``test_honey_badger.py``) is built here twice: once from ``hbbft_tpu`` and
once from ``hbbft_tpu_torch``, each package's ``NetBuilder`` on its own
``MockBackend``, with the case's N, f, adversary, defer mode and seed, driven
by the same code.  The two runs must agree on each node's outputs (a Batch
as ``(epoch, contributions)``, a signature by its bytes: the classes differ
across packages), the fault logs as ``(node_id, kind)``, the faulty set,
``messages_delivered``, ``cranks``, the virtual clock, the net's and the
backend's counters (timings aside) and the net's next RNG draw.
"""

import importlib
import random

import pytest

MSG = b"the secret plaintext payload"  # test_threshold_decrypt.py
DOC = b"sign me"  # test_threshold_sign.py
PAYLOAD = b"broadcast me " * 10  # test_broadcast.py


class Pkg:
    """One package's object runtime, by module."""

    def __init__(self, root: str) -> None:
        def imp(path):
            return importlib.import_module(f"{root}.{path}")

        self.vn = imp("net.virtual_net")
        self.adv = imp("net.adversary")
        self.ba = imp("protocols.binary_agreement")
        self.ts = imp("protocols.threshold_sign")
        self.td = imp("protocols.threshold_decrypt")
        self.bc = imp("protocols.broadcast")
        self.ss = imp("protocols.subset")
        self.hb = imp("protocols.honey_badger")
        self.backend = imp("crypto.backend")
        self.keys = imp("crypto.keys")
        self.merkle = imp("crypto.merkle")
        self.tracer = imp("obs.tracer")
        self.health = imp("obs.health")
        self.metrics = imp("utils.metrics")

    def net(self, node_ids):
        """A ``NetBuilder`` on this package's ``MockBackend`` (the port's
        builder defaults to the card)."""
        return self.vn.NetBuilder(node_ids).backend(self.backend.MockBackend())


REF, PORT = Pkg("hbbft_tpu"), Pkg("hbbft_tpu_torch")


def norm(o):
    """A package-free form of one output."""
    name = type(o).__name__
    if name == "Batch":
        return ("Batch", o.epoch, o.contributions)
    if name == "SubsetOutput":
        return (name, o.kind, o.proposer, o.value)
    if hasattr(o, "to_bytes"):
        return (name, o.to_bytes())
    return o


def summary(net) -> dict:
    def plain(counters):
        return {k: v for k, v in counters.snapshot().items()
                if "seconds" not in k and not k.startswith("host_bucket_")}

    return {
        "outputs": {i: [norm(o) for o in n.outputs] for i, n in sorted(net.nodes.items())},
        "faults": {i: [(f.node_id, f.kind) for f in n.faults_observed]
                   for i, n in sorted(net.nodes.items())},
        "faulty": sorted(n.id for n in net.faulty_nodes()),
        "delivered": net.messages_delivered,
        "cranks": net.cranks,
        "dropped": net.dropped_messages,
        "now": net.now,
        "net_counters": plain(net.counters),
        "backend_counters": plain(net.backend.counters),
        "next_draw": net.rng.random(),
    }


def run_rounds(net) -> None:
    while net.queue or net._pending_work:
        net.crank_round()


def run(net, defer_mode) -> None:
    if defer_mode == "round":
        run_rounds(net)
    else:
        net.crank_to_quiescence()


# -- BinaryAgreement (test_binary_agreement.py) --------------------------------------


def ba_net(P, n, f=0, adversary=None, defer_mode="eager", seed=0):
    b = (P.net(range(n)).num_faulty(f).defer_mode(defer_mode).crank_limit(200_000)
         .using(lambda ni, be: P.ba.BinaryAgreement(ni, be, session_id=b"test-ba")))
    if adversary:
        b = b.adversary(getattr(P.adv, adversary)())
    return b.build(seed=seed)


def ba_unanimous(P, n, value):
    net = ba_net(P, n)
    net.broadcast_input(value)
    net.crank_to_quiescence()
    return [net]


def ba_mixed(P, seed, defer_mode):
    net = ba_net(P, 4, 1, defer_mode=defer_mode, seed=seed)
    for i in sorted(net.nodes):
        net.send_input(i, i % 2 == 0)
    run(net, defer_mode)
    return [net]


def ba_inputs(P, n, f, adversary, seed, value):
    net = ba_net(P, n, f, adversary=adversary, seed=seed)
    for i in sorted(net.nodes):
        net.send_input(i, value(i))
    net.crank_to_quiescence()
    return [net]


BA_CASES = (
    [(f"ba-unanimous-n{n}-{v}", ba_unanimous, (n, v)) for v in (True, False) for n in (1, 2, 4)]
    + [(f"ba-mixed-{m}-s{s}", ba_mixed, (s, m)) for m in ("eager", "round") for s in range(6)]
    + [(f"ba-{a}-s{s}", ba_inputs, (7, 2, a, s, lambda i: i % 3 == 0))
       for s in range(4) for a in ("ReorderingAdversary", "NodeOrderAdversary")]
    + [(f"ba-silent-s{s}", ba_inputs, (7, 2, "SilentAdversary", s, lambda i: i % 2 == 1))
       for s in range(4)]
    + [("ba-larger-net", ba_inputs, (10, 3, "ReorderingAdversary", 13, lambda i: i < 5))]
)


# -- ThresholdSign (test_threshold_sign.py) ------------------------------------------


def ts_net(P, n, f=0, adversary=None, defer_mode="eager", seed=0):
    b = (P.net(range(n)).num_faulty(f).defer_mode(defer_mode)
         .using(lambda ni, be: P.ts.ThresholdSign(ni, be, doc=DOC)))
    if adversary:
        b = b.adversary(adversary)
    return b.build(seed=seed)


def ts_all_sign(P, n, defer_mode):
    net = ts_net(P, n, defer_mode=defer_mode)
    net.broadcast_input(None)
    net.crank_to_quiescence()
    sig = net.correct_nodes()[0].outputs[0]
    assert net.nodes[0].algorithm.netinfo.public_key_set.public_key().verify(sig, DOC)
    return [net]


def ts_adversary(P, adversary, seed):
    net = ts_net(P, 4, 1, adversary=getattr(P.adv, adversary)(), seed=seed)
    net.broadcast_input(None)
    net.crank_to_quiescence()
    return [net]


def ts_modes(P, defer_mode):
    net = ts_net(P, 4, defer_mode=defer_mode, seed=9)
    net.broadcast_input(None)
    run(net, defer_mode)
    return [net]


def ts_corrupted(P):
    def garbage(net, msg):
        el = net.backend.group.hash_to_g2(b"garbage" + bytes([net.rng.randrange(256)]))
        return P.ts.ThresholdSignMessage(P.keys.SignatureShare(net.backend.group, el))

    net = ts_net(P, 4, 1, adversary=P.adv.RandomAdversary(garbage, p_replace=1.0), seed=11)
    net.broadcast_input(None)
    net.crank_to_quiescence()
    return [net]


TS_CASES = (
    [(f"ts-all-n{n}-{m}", ts_all_sign, (n, m)) for m in ("eager", "round") for n in (1, 2, 4, 7)]
    + [(f"ts-reorder-s{s}", ts_adversary, ("ReorderingAdversary", s)) for s in range(4)]
    + [("ts-silent", ts_adversary, ("SilentAdversary", 5))]
    + [(f"ts-mode-{m}", ts_modes, (m,)) for m in ("eager", "round")]
    + [("ts-corrupted-share", ts_corrupted, ())]
)


# -- ThresholdDecrypt (test_threshold_decrypt.py) ------------------------------------


def td_net(P, n, f=0, adversary=None, defer_mode="eager", seed=0, backend=None):
    b = (P.net(range(n)).num_faulty(f).defer_mode(defer_mode)
         .using(lambda ni, be: P.td.ThresholdDecrypt(ni, be)))
    if adversary:
        b = b.adversary(adversary)
    if backend:
        b = b.backend(backend)
    return b.build(seed=seed)


def td_with_ct(P, n, f, adversary=None, defer_mode="eager", seed=0):
    net = td_net(P, n, f, adversary, defer_mode, seed)
    ct = net.nodes[0].algorithm.netinfo.public_key_set.encrypt(MSG, random.Random(seed + 1000))
    for nid in sorted(net.nodes):
        node = net.nodes[nid]
        net._process_step(node, node.algorithm.set_ciphertext(ct))
    return net


def td_all_decrypt(P, n, f, defer_mode):
    net = td_with_ct(P, n, f, defer_mode=defer_mode)
    net.broadcast_input(None)
    run(net, defer_mode)
    return [net]


def td_silent(P, seed):
    net = td_with_ct(P, 7, 2, adversary=P.adv.SilentAdversary(), seed=seed)
    net.broadcast_input(None)
    net.crank_to_quiescence()
    return [net]


def td_late_ciphertext(P):
    net = td_net(P, 4, 1, seed=3)
    ct = net.nodes[0].algorithm.netinfo.public_key_set.encrypt(MSG, random.Random(7))
    for nid in [0, 1, 2]:
        node = net.nodes[nid]
        net._process_step(node, node.algorithm.set_ciphertext(ct))
        net._process_step(node, node.algorithm.start_decryption())
    net.crank_to_quiescence()
    assert net.nodes[3].outputs == []
    node3 = net.nodes[3]
    net._process_step(node3, node3.algorithm.set_ciphertext(ct))
    net._process_step(node3, node3.algorithm.start_decryption())
    net.crank_to_quiescence()
    return [net]


def td_invalid_ciphertext(P):
    backend = P.backend.MockBackend()
    net = td_net(P, 4, 1, seed=5, backend=backend)
    good = net.nodes[0].algorithm.netinfo.public_key_set.encrypt(MSG, random.Random(1))
    bad = P.keys.Ciphertext(backend.group, good.u, good.v, backend.group.g2_mul(3, good.w))
    node = net.nodes[0]
    net._process_step(node, node.algorithm.set_ciphertext(bad))
    assert node.algorithm.terminated()
    return [net]


def td_corrupted(P):
    def garbage(net, msg):
        el = net.backend.group.hash_to_g1(bytes([net.rng.randrange(256)]))
        return P.td.ThresholdDecryptMessage(P.keys.DecryptionShare(net.backend.group, el))

    net = td_net(P, 4, 1, adversary=P.adv.RandomAdversary(garbage, p_replace=1.0), seed=11)
    ct = net.nodes[0].algorithm.netinfo.public_key_set.encrypt(MSG, random.Random(2))
    for nid in sorted(net.nodes):
        node = net.nodes[nid]
        net._process_step(node, node.algorithm.set_ciphertext(ct))
    net.broadcast_input(None)
    net.crank_to_quiescence()
    return [net]


TD_CASES = (
    [(f"td-all-n{n}-{m}", td_all_decrypt, (n, f, m))
     for m in ("eager", "round") for n, f in ((1, 0), (4, 1), (7, 2))]
    + [(f"td-silent-s{s}", td_silent, (s,)) for s in range(4)]
    + [("td-late-ciphertext", td_late_ciphertext, ()),
       ("td-invalid-ciphertext", td_invalid_ciphertext, ()),
       ("td-corrupted-share", td_corrupted, ())]
)


# -- Broadcast (test_broadcast.py) ---------------------------------------------------


def bc_net(P, n, f=0, adversary=None, seed=0, proposer=0):
    b = (P.net(range(n)).num_faulty(f)
         .using(lambda ni, be: P.bc.Broadcast(ni, proposer_id=proposer)).crank_limit(500_000))
    if adversary:
        b = b.adversary(getattr(P.adv, adversary)())
    return b.build(seed=seed)


def bc_send(P, n, f, payload, adversary=None, seed=0):
    net = bc_net(P, n, f, adversary, seed)
    net.send_input(0, payload)
    net.crank_to_quiescence()
    return [net]


def bc_silent(P, seed, proposer_faulty):
    """The reference's seed search: the first seed whose proposer is (not)
    faulty."""
    n, f, step = (4, 1, 1) if proposer_faulty else (7, 2, 100)
    while True:
        net = bc_net(P, n, f, adversary="SilentAdversary", seed=seed)
        if net.nodes[0].faulty == proposer_faulty:
            break
        seed += step
    net.send_input(0, PAYLOAD)
    net.crank_to_quiescence()
    return [net]


def bc_equivocating(P):
    nets = []
    for seed in range(8):
        net = bc_net(P, 4, 0, seed=seed)
        proposer = net.nodes[0].algorithm
        step_a = proposer.broadcast(b"value A" * 5)
        proposer.has_value = False
        proposer.echo_sent = False
        step_b = proposer.broadcast(b"value B" * 5)
        for step, tos in ((step_a, (1, 2)), (step_b, (3,))):
            for tm in step.messages:
                for to in tm.target.recipients(sorted(net.nodes), our_id=0):
                    if to in tos:
                        net.queue.append(P.vn.NetMessage(0, to, tm.message))
        net.crank_to_quiescence()
        nets.append(net)
    return nets


BC_CASES = (
    [(f"bc-n{n}-f{f}", bc_send, (n, f, PAYLOAD))
     for n, f in ((1, 0), (2, 0), (4, 1), (7, 2), (10, 3))]
    + [(f"bc-size-{k}", bc_send, (4, 1, bytes(i % 256 for i in range(k))))
       for k in (0, 1, 3, 100, 10_000)]
    + [(f"bc-{a}-s{s}", bc_send, (7, 2, PAYLOAD, a, s))
       for s in range(3) for a in ("ReorderingAdversary", "NodeOrderAdversary")]
    + [(f"bc-silent-s{s}", bc_silent, (s, False)) for s in range(3)]
    + [("bc-silent-proposer", bc_silent, (0, True)),
       ("bc-equivocating-proposer", bc_equivocating, ())]
)


# -- Subset (test_subset.py) ---------------------------------------------------------


def ss_run(P, n, f, contribution, adversary=None, defer_mode="eager", seed=0):
    b = (P.net(range(n)).num_faulty(f).defer_mode(defer_mode).crank_limit(2_000_000)
         .using(lambda ni, be: P.ss.Subset(ni, be, session_id=b"test-subset")))
    if adversary:
        b = b.adversary(getattr(P.adv, adversary)())
    net = b.build(seed=seed)
    for i in sorted(net.nodes):
        net.send_input(i, contribution % i)
    run(net, defer_mode)
    return [net]


SS_CASES = (
    [(f"ss-n{n}-{m}", ss_run, (n, f, b"contribution-%d", None, m))
     for m in ("eager", "round") for n, f in ((1, 0), (2, 0), (4, 1), (7, 2))]
    + [(f"ss-reorder-s{s}", ss_run, (4, 1, b"c%d", "ReorderingAdversary", "eager", s))
       for s in range(4)]
    + [(f"ss-silent-s{s}", ss_run, (7, 2, b"c%d", "SilentAdversary", "eager", s))
       for s in range(4)]
)


# -- HoneyBadger (test_honey_badger.py) ----------------------------------------------


def hb_net(P, n, f=0, adversary=None, defer_mode="eager", seed=0, schedule=None):
    schedule = schedule or P.hb.EncryptionSchedule.always()
    b = (P.net(range(n)).num_faulty(f).defer_mode(defer_mode).crank_limit(5_000_000)
         .using(lambda ni, be: P.hb.HoneyBadger(ni, be, session_id=b"test-hb",
                                                encryption_schedule=schedule)))
    if adversary:
        b = b.adversary(adversary)
    return b.build(seed=seed)


def hb_epochs(net, n_epochs):
    for e in range(n_epochs):
        for i in sorted(net.nodes):
            net.send_input(i, {"from": i, "epoch": e})
        net.crank_until(lambda net: all(len(node.outputs) >= e + 1
                                        for node in net.correct_nodes()))


def hb_identical(P, n, f):
    net = hb_net(P, n, f)
    hb_epochs(net, 3)
    return [net]


def hb_mode(P, defer_mode):
    net = hb_net(P, 4, 1, defer_mode=defer_mode, seed=42)
    for i in sorted(net.nodes):
        net.send_input(i, (i, "x"))
    run(net, defer_mode)
    return [net]


def hb_schedule(P, kind, args):
    net = hb_net(P, 4, 1, schedule=getattr(P.hb.EncryptionSchedule, kind)(*args), seed=3)
    hb_epochs(net, 3)
    return [net]


def hb_reorder(P, seed):
    net = hb_net(P, 4, 1, adversary=P.adv.ReorderingAdversary(), seed=seed)
    hb_epochs(net, 2)
    return [net]


def hb_first_batch(net, proposal):
    for i in sorted(net.nodes):
        net.send_input(i, proposal(i))
    net.crank_until(lambda net: all(len(n.outputs) >= 1 for n in net.correct_nodes()))
    return [net]


def hb_silent(P, seed):
    return hb_first_batch(hb_net(P, 7, 2, adversary=P.adv.SilentAdversary(), seed=seed),
                          lambda i: ("tx", i))


def hb_garbage(P):
    class GarbageProposal(P.adv.Adversary):
        """test_honey_badger.py's: a faulty proposer's RBC Value replaced
        by a proof of garbage shards."""

        def tamper(self, net, msg):
            m = msg.payload
            if (isinstance(m, P.hb.HbMessage) and m.kind == "subset"
                    and isinstance(m.payload, P.ss.SubsetMessage)
                    and m.payload.proposer == msg.sender
                    and isinstance(m.payload.payload, P.bc.BroadcastMessage)
                    and m.payload.payload.kind == "value"):
                proof = m.payload.payload.payload
                n = net.nodes[msg.sender].algorithm.netinfo.num_nodes()
                tree = P.merkle.MerkleTree([b"garbage!" for _ in range(n)])
                new_msg = P.hb.HbMessage.subset(m.epoch, P.ss.SubsetMessage(
                    m.payload.proposer, "broadcast",
                    P.bc.BroadcastMessage.value(tree.proof(proof.index))))
                return [type(msg)(msg.sender, msg.to, new_msg)]
            return [msg]

    return hb_first_batch(hb_net(P, 4, 1, adversary=GarbageProposal(), seed=2),
                          lambda i: ("c", i))


HB_CASES = (
    [(f"hb-identical-n{n}", hb_identical, (n, f)) for n, f in ((1, 0), (4, 1))]
    + [(f"hb-mode-{m}", hb_mode, (m,)) for m in ("eager", "round")]
    + [(f"hb-schedule-{k}", hb_schedule, (k, a))
       for k, a in (("never", ()), ("every_nth", (2,)), ("tick_tock", (1, 1)))]
    + [(f"hb-reorder-s{s}", hb_reorder, (s,)) for s in range(3)]
    + [(f"hb-silent-s{s}", hb_silent, (s,)) for s in range(3)]
    + [("hb-garbage-ciphertext", hb_garbage, ())]
)


CASES = BA_CASES + TS_CASES + TD_CASES + BC_CASES + SS_CASES + HB_CASES


def test_every_reference_case_is_here():
    """One case per parametrised case of the six reference files."""
    assert [len(c) for c in (BA_CASES, TS_CASES, TD_CASES, BC_CASES, SS_CASES, HB_CASES)] == [
        31, 16, 13, 21, 16, 14]
    assert len({name for name, _, _ in CASES}) == len(CASES)


@pytest.mark.parametrize("name, case, args", CASES, ids=[c[0] for c in CASES])
def test_port_equals_the_reference(name, case, args):
    ref = [summary(net) for net in case(REF, *args)]
    port = [summary(net) for net in case(PORT, *args)]
    assert port == ref
    assert any(out for s in port for out in s["outputs"].values()) or name in (
        "bc-silent-proposer", "td-invalid-ciphertext")
