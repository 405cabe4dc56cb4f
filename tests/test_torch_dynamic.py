"""The port's dynamic protocols (DynamicHoneyBadger, QueueingHoneyBadger,
SenderQueue) against the JAX package's.

Every case of the reference's ``test_dynamic_honey_badger.py``,
``test_queueing_honey_badger.py`` and ``test_sender_queue.py`` is built
twice, once from each package, on each one's ``MockBackend`` with the same
N, f, adversary and seed, and driven by the same code.  The two runs must
agree on each node's batches (era, epoch, contributions, change state), the
fault logs, ``messages_delivered``, ``cranks``, the counters and the net's
next RNG draw, and each run must also pass the reference test's own checks.
"""

import random

import pytest

from test_torch_protocols import PORT, REF, summary


def committed_txs(node):
    out = []
    for batch in node.outputs:
        for p, txs in sorted(batch.contributions.items(), key=lambda kv: repr(kv[0])):
            if isinstance(txs, list):
                out.extend(tx for tx in txs if tx not in out)
    return out


def step(net, i, s):
    net._process_step(net.nodes[i], s)


def agreed_batches(net):
    nodes = net.correct_nodes()
    n_common = min(len(n.outputs) for n in nodes)
    ref = nodes[0].outputs[:n_common]
    for n in nodes[1:]:
        assert n.outputs[:n_common] == ref, f"node {n.id} diverged"
    return ref


# -- DynamicHoneyBadger (test_dynamic_honey_badger.py) -------------------------------


def dhb_net(P, n, f=0, adversary=None, seed=0):
    b = (P.net(range(n)).num_faulty(f).crank_limit(5_000_000)
         .using(lambda ni, be, rng: P.dhb.DynamicHoneyBadger(ni, be, rng=rng,
                                                             session_id=b"test-dhb")))
    if adversary:
        b = b.adversary(getattr(P.adv, adversary)())
    return b.build(seed=seed)


def drive_epoch(net, epoch_idx, contribute=lambda i, e: ("tx", i, e)):
    for i in sorted(net.nodes):
        algo = net.nodes[i].algorithm
        if algo.netinfo.is_validator():
            step(net, i, algo.propose(contribute(i, epoch_idx)))
    net.crank_until(lambda n: all(len(node.outputs) >= epoch_idx + 1
                                  for node in n.correct_nodes()))


def drive_until_complete(P, net, limit, change=None):
    for epoch in range(limit):
        drive_epoch(net, epoch)
        last = net.correct_nodes()[0].outputs[-1]
        if change is None and last.change.kind == "complete":
            return
        if change is not None and last.change == P.change.ChangeState.complete(change):
            return
    raise AssertionError("change never completed")


def dhb_steady(P):
    net = dhb_net(P, 4)
    for e in range(3):
        drive_epoch(net, e)
    batches = agreed_batches(net)
    assert [b.era for b in batches] == [0, 0, 0]
    assert all(b.change == P.change.ChangeState.none() for b in batches)
    return [net]


def dhb_remove(P):
    net = dhb_net(P, 4, seed=1)
    for i in sorted(net.nodes):
        step(net, i, net.nodes[i].algorithm.vote_to_remove(3))
    drive_until_complete(P, net, 12, P.change.Change.remove(3))
    agreed_batches(net)
    assert all(net.nodes[i].algorithm.netinfo.num_nodes() == 3 for i in (0, 1, 2))
    assert not net.nodes[3].algorithm.netinfo.is_validator()
    n_before = len(net.nodes[0].outputs)
    for i in (0, 1, 2):
        step(net, i, net.nodes[i].algorithm.propose(("postchange", i)))
    net.crank_until(lambda n: all(len(n.nodes[i].outputs) > n_before for i in (0, 1, 2)))
    assert net.nodes[0].outputs[n_before].era == 1
    return [net]


def dhb_add(P):
    net = dhb_net(P, 4, seed=2)
    rng = random.Random(777)
    joiner_sk = P.keys.SecretKey.random(net.backend.group, rng)
    plan = net.nodes[0].algorithm.join_plan()
    joiner = P.dhb.DynamicHoneyBadger.new_joining(
        our_id=4, secret_key=joiner_sk, join_plan=plan, backend=net.backend, rng=rng,
        session_id=b"test-dhb")
    net.nodes[4] = P.vn.Node(id=4, algorithm=joiner, faulty=False)
    net._sorted_ids = sorted(net.nodes)
    net._node_order = {n: i for i, n in enumerate(net._sorted_ids)}
    for i in range(4):
        step(net, i, net.nodes[i].algorithm.vote_to_add(4, joiner_sk.public_key()))
    drive_until_complete(P, net, 12)
    agreed_batches(net)
    assert all(net.nodes[i].algorithm.netinfo.num_nodes() == 5 for i in range(5))
    assert all(net.nodes[i].algorithm.netinfo.is_validator() for i in range(5))
    n_before = min(len(net.nodes[i].outputs) for i in range(5))
    for i in range(5):
        step(net, i, net.nodes[i].algorithm.propose(("era1", i)))
    net.crank_until(lambda n: all(len(n.nodes[i].outputs) > n_before for i in range(5)))
    assert net.nodes[4].outputs[-1].era == 1
    return [net]


def dhb_schedule(P):
    net = dhb_net(P, 4, seed=3)
    sched = P.hb.EncryptionSchedule.every_nth(2)
    for i in sorted(net.nodes):
        step(net, i, net.nodes[i].algorithm.vote_for(P.change.Change.set_schedule(sched)))
    drive_epoch(net, 0)
    batches = agreed_batches(net)
    assert batches[0].change == P.change.ChangeState.complete(
        P.change.Change.set_schedule(sched))
    assert all(net.nodes[i].algorithm.encryption_schedule == sched for i in net.nodes)
    return [net]


def dhb_remove_reordering(P, seed):
    net = dhb_net(P, 4, f=1, adversary="ReorderingAdversary", seed=seed)
    for i in sorted(net.nodes):
        step(net, i, net.nodes[i].algorithm.vote_to_remove(3))
    drive_until_complete(P, net, 15)
    agreed_batches(net)
    return [net]


DHB_CASES = [
    ("dhb-steady", dhb_steady, ()),
    ("dhb-remove", dhb_remove, ()),
    ("dhb-add-join-plan", dhb_add, ()),
    ("dhb-schedule", dhb_schedule, ()),
] + [(f"dhb-remove-reorder-s{s}", dhb_remove_reordering, (s,)) for s in range(2)]


# -- QueueingHoneyBadger (test_queueing_honey_badger.py) -----------------------------


def qhb_net(P, n, f=0, seed=0, batch_size=3):
    return (P.net(range(n)).num_faulty(f).crank_limit(10_000_000)
            .using(lambda ni, be, rng: P.qhb.QueueingHoneyBadger(
                ni, be, rng=rng, batch_size=batch_size, session_id=b"test-qhb"))
            .build(seed=seed))


def push_all(net, txs):
    for tx in txs:
        for i in sorted(net.nodes):
            step(net, i, net.nodes[i].algorithm.push_transaction(tx))


def qhb_all_commit(P, seed):
    net = qhb_net(P, 4, f=1, seed=seed)
    txs = [("tx", i) for i in range(12)]
    push_all(net, txs)
    net.crank_until(lambda n: all(set(txs) <= set(committed_txs(node))
                                  for node in n.correct_nodes()), max_cranks=2_000_000)
    orders = [committed_txs(node) for node in net.correct_nodes()]
    assert all(o == orders[0] for o in orders)
    return [net]


def qhb_removed_from_queue(P):
    net = qhb_net(P, 4, seed=5)
    push_all(net, [("t", t) for t in range(6)])
    net.crank_until(lambda n: all(len(node.algorithm.queue) == 0 for node in n.correct_nodes()),
                    max_cranks=2_000_000)
    return [net]


def qhb_churn(P):
    """Vote node 3 out, then back in (it keeps its key), while
    transactions flow."""
    net = qhb_net(P, 4, seed=7)
    pk3 = net.nodes[3].algorithm.netinfo.public_key(3)
    push_all(net, [("pre", t) for t in range(4)])
    for i in sorted(net.nodes):
        step(net, i, net.nodes[i].algorithm.vote_to_remove(3))
    net.crank_until(lambda n: all(node.algorithm.dhb.era >= 1 for node in n.correct_nodes()),
                    max_cranks=2_000_000)
    assert not net.nodes[3].algorithm.netinfo.is_validator()
    for i in (0, 1, 2):
        step(net, i, net.nodes[i].algorithm.vote_to_add(3, pk3))
    push_all(net, [("mid", t) for t in range(4)])
    net.crank_until(lambda n: all(node.algorithm.dhb.era >= 2 for node in n.correct_nodes()),
                    max_cranks=5_000_000)
    assert net.nodes[3].algorithm.netinfo.is_validator()
    push_all(net, [("post", t) for t in range(4)])
    target = {("post", t) for t in range(4)}
    net.crank_until(lambda n: all(target <= set(committed_txs(node))
                                  for node in n.correct_nodes()), max_cranks=5_000_000)
    orders = [committed_txs(node) for node in net.correct_nodes()]
    assert all(o == orders[0] for o in orders)
    return [net]


QHB_CASES = (
    [(f"qhb-all-commit-s{s}", qhb_all_commit, (s,)) for s in range(3)]
    + [("qhb-removed-from-queue", qhb_removed_from_queue, ()),
       ("qhb-churn-remove-readd", qhb_churn, ())]
)


# -- SenderQueue (test_sender_queue.py) ----------------------------------------------


def sq_net(P, n, f=0, seed=0):
    return (P.net(range(n)).num_faulty(f).crank_limit(10_000_000)
            .using(lambda ni, be, rng: P.sq.SenderQueue(P.qhb.QueueingHoneyBadger(
                ni, be, rng=rng, batch_size=3, session_id=b"test-sq")))
            .build(seed=seed))


def sq_wrapped_commits(P, seed):
    net = sq_net(P, 4, f=1, seed=seed)
    txs = [("tx", i) for i in range(6)]
    push_all(net, txs)
    net.crank_until(lambda n: all(set(txs) <= set(committed_txs(node))
                                  for node in n.correct_nodes()), max_cranks=2_000_000)
    orders = [committed_txs(node) for node in net.correct_nodes()]
    assert all(o == orders[0] for o in orders)
    return [net]


def sq_announcements(P):
    net = sq_net(P, 4, seed=3)
    for i in sorted(net.nodes):
        step(net, i, net.nodes[i].algorithm.push_transaction(("t", i)))
    net.crank_until(lambda n: all(len(node.outputs) >= 1 for node in n.correct_nodes()),
                    max_cranks=1_000_000)
    assert net.nodes[0].algorithm.peer_epochs
    return [net]


def sq_churn_round(P):
    """The card's churn run: SenderQueue ⊃ QueueingHoneyBadger (batch size
    100) under the round barrier, N=4, f=1, net seed 12; 25 ten-byte
    transactions a node, node 3 voted out and back in, 25 more a node, each
    transaction committed exactly once."""
    rng = random.Random(0)
    net = (P.net(range(4)).num_faulty(1).defer_mode("round").crank_limit(10_000_000)
           .using(lambda ni, be, r: P.sq.SenderQueue(
               P.qhb.QueueingHoneyBadger.builder(ni, be, r).batch_size(100).build()))
           .build(seed=12))
    pushed = []

    def push():
        for i in sorted(net.nodes):
            for _ in range(25):
                tx = rng.getrandbits(80).to_bytes(10, "big")
                net.send_input(i, ("user", tx))
                pushed.append(tx)

    def crank(cond):
        while not cond(net):
            assert net.queue or net._pending_work
            net.crank_round()

    pk3 = net.nodes[3].algorithm.netinfo.public_key(3)
    push()
    for i in sorted(net.nodes):
        net.send_input(i, ("change", P.change.Change.remove(3)))
    crank(lambda n: all(x.algorithm.dhb.era >= 1 for x in n.correct_nodes()))
    assert not net.nodes[0].algorithm.netinfo.is_node_validator(3)
    for i in (0, 1, 2):
        net.send_input(i, ("change", P.change.Change.add(3, pk3.to_bytes())))
    crank(lambda n: all(x.algorithm.dhb.era >= 2 for x in n.correct_nodes()))
    push()
    crank(lambda n: all(set(pushed) <= set(committed_txs(x)) for x in n.correct_nodes()))
    assert net.nodes[3].algorithm.netinfo.is_validator()
    for x in net.correct_nodes():
        seen = [tx for b in x.outputs for txs in b.contributions.values() for tx in txs]
        assert sorted(seen) == sorted(pushed)
    return [net]


SQ_CASES = (
    [(f"sq-wrapped-commits-s{s}", sq_wrapped_commits, (s,)) for s in range(3)]
    + [("sq-announcements", sq_announcements, ()),
       ("sq-qhb-churn-round-barrier", sq_churn_round, ())]
)


CASES = DHB_CASES + QHB_CASES + SQ_CASES


def test_every_reference_case_is_here():
    """One case per parametrised end-to-end case of the three reference
    files (the two SenderQueue routing cases are below), and the card's
    churn run."""
    assert [len(c) for c in (DHB_CASES, QHB_CASES, SQ_CASES)] == [6, 5, 5]
    assert len({name for name, _, _ in CASES}) == len(CASES)


@pytest.mark.parametrize("name, case, args", CASES, ids=[c[0] for c in CASES])
def test_port_equals_the_reference(name, case, args):
    ref = [summary(net) for net in case(REF, *args)]
    port = [summary(net) for net in case(PORT, *args)]
    assert port == ref
    assert all(out for i, out in port[0]["outputs"].items() if i not in port[0]["faulty"])


def _route(P, announce, msg_epoch):
    """SenderQueue's routing of one DHB message to peer 1 after peer 1
    announced ``announce``: what is sent now, what stays buffered, and what
    a later announcement of (0, 8) flushes."""
    seed = 1 if announce == (0, 0) else 2
    net = sq_net(P, 4, seed=seed)
    sq = net.nodes[0].algorithm
    step(net, 0, sq.handle_message(1, P.sq.SqMessage.epoch_started(*announce)))
    fake = P.dhb.DhbMessage(0, P.hb.HbMessage.subset(msg_epoch, "payload"))
    sent = sq._route(P.types.TargetedMessage(P.types.Target.node(1), fake))
    buffered = list(sq._outgoing.get(1, []))
    flush = sq._on_epoch_started(1, (0, 8))
    flushed = [tm.message.payload for tm in flush.messages if tm.message.kind == "algo"]
    return (len(sent.messages), [m is fake for m in buffered],
            [m is fake for m in flushed], sorted(sq.peer_epochs.items()))


@pytest.mark.parametrize("announce, msg_epoch, expect", [
    ((0, 0), 10, (0, [True], [True])),   # premature: buffered, flushed at (0, 8)
    ((2, 5), 0, (0, [], [])),             # obsolete: dropped
], ids=["premature-buffered", "obsolete-dropped"])
def test_sender_queue_routing_equals_the_reference(announce, msg_epoch, expect):
    ref, port = _route(REF, announce, msg_epoch), _route(PORT, announce, msg_epoch)
    assert port == ref
    assert port[:3] == expect


def test_unported_batch_size_input_is_refused():
    """The reference's ``("batch_size", B)`` input (the adaptive
    controller's channel), refused while the port lacked the controller, is
    ported now: in both packages it is a state write that re-sizes later
    proposals and proposes nothing, and the user and change inputs still go
    through."""
    def run(P):
        net = qhb_net(P, 4, seed=3)
        qhb = net.nodes[0].algorithm
        st = qhb.handle_input(("batch_size", 7))
        assert qhb.batch_size == 7 and not st.messages and not st.output
        step(net, 0, qhb.handle_input(("user", "tx-0")))
        assert "tx-0" in qhb.queue
        return qhb.batch_size, summary(net)

    assert run(PORT) == run(REF)
