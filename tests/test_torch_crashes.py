"""The port's crash/restart axis (``net/crash.py`` on ``VirtualNet``)
against the JAX package's.

Every case of the reference's ``test_crashes.py`` that drives the axis
itself (its composed soak cells are in ``test_torch_soak.py``) is built
twice, once from each package: SenderQueue ⊃ QueueingHoneyBadger on each
one's ``MockBackend`` with the same crash schedule, N, f, adversary and
seed, driven by the same code.  The two runs must agree on every node's
batches, ``crash.stats()``, the fault logs, deliveries, cranks, the
counters and the net's next RNG draw, and each must pass the reference
test's own checks.
"""

import pytest

from test_torch_protocols import PORT, REF, summary


def qhb_net(P, n=4, f=0, crash=None, seed=5, batch_size=3, adversary=None, defer_mode=None):
    def make(ni, be, rng):
        return P.sq.SenderQueue(
            P.qhb.QueueingHoneyBadgerBuilder(ni, be, rng).batch_size(batch_size).build())

    b = P.net(range(n)).num_faulty(f).crashes(crash).crank_limit(2_000_000).using(make)
    if adversary is not None:
        b = b.adversary(getattr(P.adv, adversary)())
    if defer_mode is not None:
        b = b.defer_mode(defer_mode)
    return b.build(seed=seed)


def schedule(P, *events, every=2):
    return P.vn.CrashSchedule(tuple(P.vn.CrashEvent(**ev) for ev in events),
                              checkpoint_every=every)


def boot(net):
    for i in sorted(net.nodes):
        net.send_input(i, ("user", ("boot", i)))


def run_epochs(net, epochs, max_cranks=400_000, start=0):
    for k in range(start, epochs):
        net.crank_until(
            lambda nt, k=k: all(len(nd.outputs) >= k + 1 for nd in nt.correct_nodes()
                                if nd.id not in nt.down_node_ids()),
            max_cranks=max_cranks)


def faults(net):
    return [(n.id, f.kind) for n in net.nodes.values() for f in n.faults_observed]


def agreed(net):
    common = min(len(n.outputs) for n in net.nodes.values())
    ref = net.nodes[0].outputs[:common]
    for i in net.nodes:
        assert net.nodes[i].outputs[:common] == ref, f"node {i} diverged"
    return common


def state(net):
    """summary() plus the crash axis's own record."""
    out = summary(net)
    out["crash"] = net.crash.stats() if net.crash is not None else None
    out["down"] = sorted(net.down_node_ids())
    return out


# -- the cases (test_crashes.py) ------------------------------------------------------


def parks_and_catches_up(P):
    net = qhb_net(P, crash=schedule(P, dict(node_id=3, at_epoch=3, down_epochs=4)))
    boot(net)
    run_epochs(net, 14)
    st = net.crash.stats()
    assert st["crashes"] == 1 and st["restarts"] == 1
    assert net.counters.crash_parked_messages > 0
    assert net.counters.crash_checkpoints >= 1
    assert net.counters.crash_suppressed_sends > 0
    assert faults(net) == []
    assert agreed(net) >= 14
    rec = st["recoveries"][0]
    assert rec["replayed_events"] > 0 and rec["behind_after_replay"] >= 0
    return [state(net)]


def mid_epoch_checkpoint(P):
    net = qhb_net(P, crash=schedule(P, dict(node_id=2, at_epoch=2, down_epochs=3), every=1),
                  seed=9)
    boot(net)
    run_epochs(net, 10)
    assert net.crash.stats()["restarts"] == 1
    assert faults(net) == []
    agreed(net)
    return [state(net)]


def parked_inputs(P):
    net = qhb_net(P, crash=schedule(P, dict(node_id=3, at_epoch=2, down_epochs=3)), seed=7)
    boot(net)
    run_epochs(net, 3)
    assert net.crash.is_down(3)
    step = net.send_input(3, ("user", ("late", "tx")))
    assert not step.output and not step.messages
    assert net.crash.tracks[3].parked_inputs
    mid = state(net)
    run_epochs(net, 12, start=3)
    assert not net.crash.is_down(3)
    committed = {tx for b in net.nodes[0].outputs for txs in b.contributions.values()
                 if isinstance(txs, list) for tx in txs}
    assert ("late", "tx") in committed
    return [mid, state(net)]


def corrupted_checkpoint(P):
    net = qhb_net(P, crash=schedule(P, dict(node_id=3, at_epoch=2, down_epochs=2)), seed=3)
    boot(net)
    run_epochs(net, 2)
    net.crash.tracks[3].ckpt_blob = b"HBTPUSNAP1corrupt"
    run_epochs(net, 8, start=2)
    assert "crash:recovery_failed" in [k for _, k in faults(net)]
    assert net.crash.tracks[3].state == "failed"
    assert all(len(n.outputs) >= 8 for n in net.correct_nodes() if n.id != 3)
    return [state(net)]


def names_down_node(P):
    cs = schedule(P, dict(at_epoch=1, down_epochs=None, down_ticks=None, restart=False))
    net = qhb_net(P, f=1, crash=cs, seed=2, adversary="SilentAdversary")
    boot(net)
    with pytest.raises(P.vn.CrankError) as err:
        run_epochs(net, 30)
    report = err.value.report
    assert report is not None and "crash" in report
    assert "down since crank" in str(err.value)
    assert "restoring from checkpoint at epoch" in str(err.value)
    return [str(err.value), report, state(net)]


def starvation_release(P):
    net = qhb_net(P, f=1, crash=schedule(P, dict(at_epoch=1, down_epochs=50)), seed=6,
                  adversary="SilentAdversary")
    boot(net)
    run_epochs(net, 6)
    st = net.crash.stats()
    assert st["crashes"] == 1 and st["restarts"] == 1
    assert faults(net) == []
    assert all(len(n.outputs) >= 6 for n in net.correct_nodes())
    return [state(net)]


def tick_gated(P):
    cs = schedule(P, dict(node_id=2, at=5, at_epoch=None, down_epochs=None, down_ticks=100),
                  dict(node_id=3, at=5, at_epoch=None, down_epochs=None, down_ticks=5000))
    net = qhb_net(P, crash=cs, seed=8)
    boot(net)
    run_epochs(net, 8, max_cranks=800_000)
    assert net.crash.stats()["restarts"] == 1
    assert net.crash.is_down(3) and net.now < 5005
    mid = state(net)
    run_epochs(net, 35, max_cranks=2_000_000)
    assert [r for r in net.crash.stats()["recoveries"] if r["node"] == "3"]
    assert net.now >= 5005
    assert faults(net) == []
    return [mid, state(net)]


def restored_listeners(P):
    net = qhb_net(P, crash=schedule(P, dict(node_id=3, at_epoch=2, down_epochs=3)), seed=5)
    boot(net)
    run_epochs(net, 3)
    net2 = P.snap.load_node(P.snap.save_node(net), P.backend.MockBackend())
    calls = []
    net2.crash.add_restart_listener(lambda nt, nid, algo: calls.append(nid))
    run_epochs(net2, 10)
    assert net2.crash.stats()["restarts"] == 1
    assert calls == [3]
    return [state(net2)]


def second_crash(P):
    """The reference's ``two_restarts`` crash spec at 14 epochs (the highest
    honest node dies at epoch 3 and again at epoch 8, down 2 epochs each),
    on the axis directly (the composed cell it rides there is held in
    ``test_torch_soak.py``)."""
    cs = schedule(P, dict(at_epoch=3, down_epochs=2), dict(at_epoch=8, down_epochs=2))
    net = qhb_net(P, crash=cs, seed=4)
    boot(net)
    run_epochs(net, 14)
    st = net.crash.stats()
    assert st["crashes"] == 2 and st["restarts"] == 2
    assert faults(net) == []
    agreed(net)
    return [state(net)]


def snapshot_mid_outage(P):
    net = qhb_net(P, crash=schedule(P, dict(node_id=3, at_epoch=2, down_epochs=3)), seed=5)
    boot(net)
    run_epochs(net, 3)
    assert net.crash.is_down(3)
    net2 = P.snap.load_node(P.snap.save_node(net), P.backend.MockBackend())
    assert net2.crash is not None and net2.crash.is_down(3)
    run_epochs(net, 10, start=3)
    run_epochs(net2, 10, start=3)
    assert net.crash.stats()["restarts"] == 1 == net2.crash.stats()["restarts"]
    for i in net.nodes:
        assert net.nodes[i].outputs == net2.nodes[i].outputs
    return [state(net), state(net2)]


CASES = {
    "parks-traffic-and-catches-up": parks_and_catches_up,
    "mid-epoch-checkpoint": mid_epoch_checkpoint,
    "down-node-inputs-park": parked_inputs,
    "corrupted-checkpoint-attributed": corrupted_checkpoint,
    "why-stalled-names-down-node": names_down_node,
    "epoch-gated-restart-starvation-release": starvation_release,
    "tick-gated-restart-keeps-outage": tick_gated,
    "restored-manager-restart-listeners": restored_listeners,
    "second-crash-replays-through-first": second_crash,
    "whole-net-snapshot-mid-outage": snapshot_mid_outage,
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_the_reference(case):
    got = [CASES[case](P) for P in (REF, PORT)]
    assert got[1] == got[0]


def test_crash_schedule_rejects_round_defer_mode():
    cs = [schedule(P, dict(at_epoch=1, down_epochs=2)) for P in (REF, PORT)]
    for P, c in zip((REF, PORT), cs):
        with pytest.raises(ValueError, match="eager"):
            qhb_net(P, crash=c, seed=1, defer_mode="round")


def test_no_schedule_keeps_the_crash_free_runtime():
    """``crashes(None)`` is the runtime without the axis: no manager, no
    down node, the same run as a builder that never named it."""
    def make(ni, be, rng):
        return PORT.sq.SenderQueue(
            PORT.qhb.QueueingHoneyBadgerBuilder(ni, be, rng).batch_size(3).build())

    runs = []
    for name_it in (False, True):
        b = PORT.net(range(4)).using(make)
        net = (b.crashes(None) if name_it else b).build(seed=5)
        assert net.crash is None and net.down_node_ids() == frozenset()
        boot(net)
        run_epochs(net, 3)
        runs.append(summary(net))
    assert runs[0] == runs[1]


def test_metrics_log_series_equals_the_reference():
    """``obs/timeseries.py``: one ``snap_net`` row an epoch over the crash
    run (merged counter deltas, crash state, cranks, virtual clock), the
    same rows in both packages, JSONL-exportable."""
    import importlib

    got = []
    for P in (REF, PORT):
        ts = importlib.import_module(P.snap.__name__.replace("utils.snapshot", "obs.timeseries"))
        log = ts.MetricsLog(capacity=8)
        net = qhb_net(P, crash=schedule(P, dict(node_id=3, at_epoch=2, down_epochs=2)), seed=5)
        boot(net)
        for k in range(10):
            run_epochs(net, k + 1, start=k)
            ts.snap_net(log, net, k, gate={"phase": "epoch.commit", "cranks": net.cranks})
        assert len(log) == 8 and log.dropped == 2
        got.append(log.rows_list())
    assert got[1] == got[0]
    assert any(r["crash"]["down"] == ["3"] for r in got[1])


def test_knob_sets_the_checkpoint_period(monkeypatch):
    monkeypatch.setenv("HBBFT_TPU_CHECKPOINT_EVERY", "3")
    assert [P.vn.CrashSchedule().checkpoint_every for P in (REF, PORT)] == [3, 3]
    monkeypatch.setenv("HBBFT_TPU_CHECKPOINT_EVERY", "0")
    assert [P.vn.CrashSchedule().checkpoint_every for P in (REF, PORT)] == [1, 1]
