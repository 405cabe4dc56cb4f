"""The port's object-level checkpoint/resume (``utils/snapshot.py``)
against the JAX package's.

Every case of the reference's ``test_snapshot.py`` is run in both packages,
each on its own ``MockBackend``: a node snapshotted mid-protocol, mid-epoch
or as a whole ``VirtualNet`` restores to an object that continues the same
way, and the two packages' restored continuations agree on outputs, fault
logs, cranks and the next RNG draw.  The port's bytes re-encode to
themselves (``save_node(load_node(b)) == b``), and it refuses callables,
unregistered classes and malformed bytes as the reference does.  The
simulation checkpoint cases hold the port's ``tools/simulation.py``
against ``examples/simulation.py``; the dynamic twin of the
snapshot-coverage rule runs over a crash-scheduled SenderQueue ⊃
QueueingHoneyBadger net, the port having no composed soak cell yet.
"""

import importlib
import random

import pytest

from test_torch_protocols import PORT, REF, norm, summary

SIMS = {id(REF): importlib.import_module("examples.simulation"),
        id(PORT): importlib.import_module("hbbft_tpu_torch.tools.simulation")}


def mock(P):
    return P.backend.MockBackend()


def reencodes(P, obj, backend):
    blob = P.snap.save_node(obj)
    back = P.snap.load_node(blob, backend)
    assert P.snap.save_node(back) == blob
    return back


# -- the cases (test_snapshot.py) -----------------------------------------------------


def ts_mid_protocol(P):
    net = (P.net(range(4)).using(lambda ni, b: P.ts.ThresholdSign(ni, b, doc=b"snapshot me"))
           .build(seed=3))
    net.broadcast_input(None)
    for _ in range(3):
        net.crank()
    nid = next(n for n in net.nodes
               if not net.nodes[n].outputs and any(m.to == n for m in net.queue))
    algo = net.nodes[nid].algorithm
    restored = reencodes(P, algo, net.backend)
    assert type(restored) is P.ts.ThresholdSign
    assert restored.netinfo.our_id == algo.netinfo.our_id

    def drain(step, backend, sink):
        sink.extend(step.output)
        for w in step.work:
            fn = {"verify_sig_share": backend.verify_sig_shares,
                  "verify_signature": backend.verify_signatures}[w.kind]
            drain(w.on_result(fn([w.payload])[0]), backend, sink)

    outs_a, outs_b = [], []
    for m in [m for m in net.queue if m.to == nid]:
        drain(algo.handle_message(m.sender, m.payload), net.backend, outs_a)
        drain(restored.handle_message(m.sender, m.payload), net.backend, outs_b)
    assert outs_a and outs_a == outs_b
    return [nid, [norm(o) for o in outs_b], summary(net)]


def hb_mid_epoch(P):
    def build():
        return (P.net(range(4)).scheduler("first")
                .using(lambda ni, be: P.hb.HoneyBadger(ni, be, session_id=b"midsnap"))
                .build(seed=4))

    def mid_epoch_node(net):
        for nid in sorted(net.nodes):
            for ps in net.nodes[nid].algorithm._epoch_state.subset.proposals.values():
                if ps.value is not None and ps.decision is None:
                    return nid
        return None

    def done(nt):
        return all(len(nd.outputs) >= 1 for nd in nt.correct_nodes())

    ref = build()
    for i in sorted(ref.nodes):
        ref.send_input(i, {"from": i})
    ref.crank_until(done)
    net = build()
    for i in sorted(net.nodes):
        net.send_input(i, {"from": i})
    target = None
    for _ in range(200_000):
        target = mid_epoch_node(net)
        if target is not None:
            break
        assert net.crank() is not None
    restored = reencodes(P, net.nodes[target].algorithm, net.backend)
    assert any(ps.value is not None and ps.decision is None
               for ps in restored._epoch_state.subset.proposals.values())
    net.nodes[target].algorithm = restored
    net.crank_until(done)
    batch = net.nodes[target].outputs[0]
    assert all(net.nodes[i].outputs[0] == batch for i in net.nodes)
    assert all(ref.nodes[i].outputs[0] == batch for i in ref.nodes)
    return [target, summary(net), summary(ref)]


def qhb_build(P, seed, batch_size):
    return (P.net(range(4))
            .using(lambda ni, b, rng: P.qhb.QueueingHoneyBadgerBuilder(ni, b, rng)
                   .batch_size(batch_size).build())
            .build(seed=seed))


def whole_net_resume(P):
    net = qhb_build(P, 11, 3)
    for i in range(4):
        for t in range(5):
            net.send_input(i, ("user", ("tx", i, t)))
    for _ in range(120):
        net.crank()
    net2 = reencodes(P, net, mock(P))
    assert sorted(net2.nodes) == sorted(net.nodes) and len(net2.queue) == len(net.queue)
    for _ in range(3000):
        a, b = net.crank(), net2.crank()
        if a is None and b is None:
            break
        assert (a is None) == (b is None)
    assert net.cranks == net2.cranks
    assert any(net.nodes[i].outputs for i in net.nodes)
    for i in net.nodes:
        assert net.nodes[i].outputs == net2.nodes[i].outputs
    first = summary(net)
    first.pop("backend_counters")  # the restored net starts its own backend's
    second = summary(net2)
    second.pop("backend_counters")
    assert first == second
    return [second]


def shared_rng(P):
    net = (P.net(range(4)).using(lambda ni, b: P.ts.ThresholdSign(ni, b, doc=b"snapshot me"))
           .build(seed=9))
    net2 = reencodes(P, net, mock(P))
    assert net2.rng.getstate() == net.rng.getstate()
    return [net2.rng.random(), summary(net2)]


def rng_identity(P):
    net = qhb_build(P, 2, 2)
    assert net.nodes[0].algorithm.rng is net.rng
    net2 = reencodes(P, net, mock(P))
    assert all(net2.nodes[i].algorithm.rng is net2.rng for i in net2.nodes)
    return [net2.rng.random()]


def slotted_dataclasses(P):
    tm = P.types.TargetedMessage(P.types.Target.node(1), ("msg", b"payload"))
    step = P.types.Step(messages=[tm], output=[("out", 7)])
    back = reencodes(P, step, mock(P))
    assert back.messages[0].message == tm.message
    assert back.messages[0].target == tm.target
    assert back.output == step.output
    return [back.output, back.messages[0].message]


def set_members_shared_refs(P):
    class Holder:  # stand-in for any registered class
        pass

    tag = f"{Holder.__module__}:{Holder.__qualname__}"
    P.snap._registry()[tag] = Holder
    try:
        fs = frozenset({1, 2})
        h = Holder()
        h.state = {fs, (fs,)}
        back = reencodes(P, h, mock(P))
        assert back.state == h.state
        return [sorted(map(repr, back.state))]
    finally:
        P.snap._registry().pop(tag, None)


def canonical_bytes(P):
    net = (P.net(range(4)).using(lambda ni, b: P.ts.ThresholdSign(ni, b, doc=b"snapshot me"))
           .build(seed=1))
    blob = P.snap.save_node(net)
    assert blob.startswith(b"HBTPUSNAP1") and blob == P.snap.save_node(net)
    reencodes(P, net, mock(P))
    return [len(blob) > 16]


CASES = {
    "threshold-sign-mid-protocol": ts_mid_protocol,
    "honey-badger-mid-epoch": hb_mid_epoch,
    "whole-network-resume": whole_net_resume,
    "shared-rng-after-restore": shared_rng,
    "rng-identity-net-and-protocols": rng_identity,
    "generic-slotted-dataclasses": slotted_dataclasses,
    "set-members-with-shared-refs": set_members_shared_refs,
    "canonical-bytes-no-pickle": canonical_bytes,
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_the_reference(case):
    got = [CASES[case](P) for P in (REF, PORT)]
    assert got[1] == got[0]


def _canonical(P):
    return importlib.import_module(P.snap.__name__.replace("snapshot", "canonical"))


REFUSALS = {
    "callable-in-state": lambda P: P.snap.save_node(_with_callable()),
    "unregistered-class": lambda P: P.snap.load_node(
        P.snap._MAGIC + _canonical(P).encode(("o", 0, "os:system", [])), mock(P)),
    "bad-rng": lambda P: P.snap.load_node(
        P.snap._MAGIC + _canonical(P).encode(("rng", 0, 99, [1, 2], ("p", None))), mock(P)),
    "bad-ndarray": lambda P: P.snap.load_node(
        P.snap._MAGIC + _canonical(P).encode(("nd", 0, "<f4", [5, 5], b"xx")), mock(P)),
    "bad-tree": lambda P: P.snap.load_node(P.snap._MAGIC + b"\xff\xff", mock(P)),
    "truncated": lambda P: P.snap.load_node(P.snap.save_node([1, 2, 3])[:-3], mock(P)),
    "bad-magic": lambda P: P.snap.load_node(b"not a snapshot", mock(P)),
    "function-outside-registry": lambda P: P.snap.load_node(
        P.snap._MAGIC + _canonical(P).encode(("fn", "os", "system")), mock(P)),
}


def _with_callable():
    class Holder:
        pass

    h = Holder()
    h.cb = lambda: None
    return h


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refuses_as_the_reference_does(case):
    for P in (REF, PORT):
        with pytest.raises(P.snap.SnapshotError):
            REFUSALS[case](P)


def test_module_functions_encode_by_name():
    """SenderQueue's default ``msg_epoch_fn`` is a module-level function:
    it rides the snapshot by name and decodes to the same object."""
    got = []
    for P in (REF, PORT):
        net = (P.net(range(4))
               .using(lambda ni, b, rng, P=P: P.sq.SenderQueue(
                   P.qhb.QueueingHoneyBadgerBuilder(ni, b, rng).batch_size(3).build()))
               .build(seed=5))
        fn = net.nodes[0].algorithm.msg_epoch_fn
        back = reencodes(P, net, mock(P))
        assert back.nodes[0].algorithm.msg_epoch_fn is fn
        got.append((fn.__qualname__, fn.__module__.split(".", 1)[1]))
    assert got[1] == got[0]


# -- the simulation's checkpoint (examples/simulation.py and the port's) --------------


class SimArgs:
    num_nodes = 4
    num_faulty = 1
    batch_size = 3
    tx_size = 8
    txns = 12
    epochs = 4
    lam = 10.0
    bandwidth = 2000.0
    cpu_factor = 1.0
    crypto_window = 64
    seed = 7


def sim_resume(P):
    sim = SIMS[id(P)]
    full = sim.Simulation(SimArgs, mock(P), random.Random(0))
    full.run()

    class A2(SimArgs):
        epochs = 2

    first = sim.Simulation(A2, mock(P), random.Random(0))
    first.run()
    blob = first.checkpoint()
    second = sim.Simulation(SimArgs, mock(P), random.Random(99))
    second.restore(blob)
    rows = second.run()
    assert rows and rows[0]["epoch"] >= 2
    for nid in full.nodes:
        a = [b.contributions for b in full.nodes[nid].outputs[:4]]
        assert a == [b.contributions for b in second.nodes[nid].outputs[:4]]
    return [{nid: [norm(b) for b in n.outputs] for nid, n in second.nodes.items()},
            second.delivered, [{k: v for k, v in r.items() if k not in ("wall_s", "virtual_ms")}
                               for r in rows]]


def sim_before_first_epoch(P):
    sim = SIMS[id(P)]

    class A(SimArgs):
        txns = 5
        epochs = 0

    class A2(A):
        epochs = 2

    first = sim.Simulation(A, mock(P), random.Random(0))
    first.run()
    resumed = sim.Simulation.from_checkpoint(A2, mock(P), first.checkpoint())
    resumed.run()
    for node in resumed.nodes.values():
        assert len(node.algo.algo.queue) <= A.txns * A.num_nodes
    return [{nid: [norm(b) for b in n.outputs] for nid, n in resumed.nodes.items()},
            resumed.delivered]


@pytest.mark.parametrize("case", ["resume-matches-uninterrupted", "before-first-epoch"])
def test_simulation_checkpoint_equals_the_reference(case):
    fn = sim_resume if case == "resume-matches-uninterrupted" else sim_before_first_epoch
    got = [fn(P) for P in (REF, PORT)]
    assert got[1] == got[0]


# -- the dynamic twin of the snapshot-coverage rule -----------------------------------


def _iter_state_instances(P, root):
    registered = set(P.snap._registry().values())
    seen, out, stack = set(), [], [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, (list, tuple, set, frozenset)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.keys())
            stack.extend(obj.values())
        elif type(obj) in registered:
            out.append(obj)
            stack.extend(v for _, v in P.snap._state_attrs(obj))
    return out


def test_dynamic_twin_live_state_instances_roundtrip_key_identical():
    """After a run with a crash mid-way (SenderQueue ⊃ QueueingHoneyBadger,
    N=4, node 3 down at epoch 2 for 2 epochs, 6 epochs, a critical-path
    recorder attached), every live instance of the port's state modules
    snapshots and restores with the live object's attribute-key set, every
    declared environment attribute has a class default, and the whole net
    round-trips; the reference's net of the same run has the same classes
    by name."""
    names = []
    for P in (REF, PORT):
        cs = P.vn.CrashSchedule((P.vn.CrashEvent(node_id=3, at_epoch=2, down_epochs=2),),
                                checkpoint_every=2)
        net = (P.net(range(4)).crashes(cs)
               .using(lambda ni, b, rng, P=P: P.sq.SenderQueue(
                   P.qhb.QueueingHoneyBadgerBuilder(ni, b, rng).batch_size(3).build()))
               .build(seed=3))
        cp = importlib.import_module(P.snap.__name__.replace("utils.snapshot", "obs.critpath"))
        net.critpath = cp.CritPathRecorder()
        for i in sorted(net.nodes):
            net.send_input(i, ("user", ("boot", i)))
        for k in range(6):
            net.crank_until(lambda nt, k=k: all(len(nd.outputs) >= k + 1
                                                for nd in nt.correct_nodes()
                                                if nd.id not in nt.down_node_ids()))
        assert net.crash.stats()["restarts"] == 1
        whole = P.snap.load_node(P.snap.save_node(net), net.backend)
        assert type(whole) is type(net) and whole.critpath is None
        by_class = {}
        for obj in _iter_state_instances(P, net):
            by_class.setdefault(type(obj), []).append(obj)
        assert {"VirtualNet", "CrashManager", "QueueingHoneyBadger"} <= {
            c.__name__ for c in by_class}
        for cls in sorted(by_class, key=lambda c: c.__qualname__):
            for env_name in getattr(cls, "_SNAPSHOT_ENV_ATTRS", ()):
                assert hasattr(cls, env_name), (cls.__qualname__, env_name)
            for obj in by_class[cls][:3]:
                restored = P.snap.load_node(P.snap.save_node(obj), net.backend)
                assert type(restored) is cls
                assert ({n for n, _ in P.snap._state_attrs(restored)}
                        == {n for n, _ in P.snap._state_attrs(obj)}), cls.__qualname__
        names.append(sorted(c.__qualname__ for c in by_class))
    assert names[1] == names[0]
