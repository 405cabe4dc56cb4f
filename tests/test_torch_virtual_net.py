"""The port's VirtualNet runtime against the JAX package's: the builder's
checks, a tripped crank limit and its why-stalled report, the schedule
layer (latency, jitter, drops, partitions), the attack library, the
attached observers (``Tracer`` spans and histograms, the ``EventLog``), the
stall reports, the crash axis the port refuses, and the verify skill's
BinaryAgreement handle.  Each net is built in both packages on each one's
``MockBackend`` from the same seed and driven by the same code; the runs
must agree on outputs, faults, deliveries, cranks, counters and the next
RNG draw."""

import json

import pytest

from test_torch_protocols import PORT, REF, summary


def ba(P, sid=b"vn"):
    return lambda ni, be: P.ba.BinaryAgreement(ni, be, session_id=sid)


def hb(P, sid=b"vn-hb"):
    return lambda ni, be: P.hb.HoneyBadger(ni, be, session_id=sid)


def rbc(P):
    return lambda ni, be: P.bc.Broadcast(ni, proposer_id=0)


def propose_all(net, value):
    for i in sorted(net.nodes):
        net.send_input(i, value(i))


# -- the builder ---------------------------------------------------------------------


@pytest.mark.parametrize("n, f", [(3, 1), (6, 2), (9, 3), (4, 1), (7, 2), (1, 0), (2, 0)])
def test_num_faulty_rejects_n_at_most_3f(n, f):
    got = []
    for P in (REF, PORT):
        try:
            P.net(range(n)).num_faulty(f)
            got.append("ok")
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]
    assert (got[1] == "ok") == (n > 3 * f)


def test_crashes_is_not_ported():
    b = PORT.vn.NetBuilder(range(4))
    assert b.crashes(None) is b
    with pytest.raises(NotImplementedError, match="net/crash.py"):
        b.crashes(object())
    assert not hasattr(PORT.vn.VirtualNet, "crash")


def test_builder_defaults_to_the_card():
    """Without ``.backend(...)`` the port's builder takes ``TorchBackend()``,
    which asks for the card: on a machine without one it raises instead of
    running on the CPU or on the mock."""
    import torch

    b = PORT.vn.NetBuilder(range(4)).num_faulty(1).using(ba(PORT))
    if torch.cuda.is_available():
        assert type(b.build(seed=1).backend).__name__ == "TorchBackend"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            b.build(seed=1)


# -- a tripped limit -----------------------------------------------------------------


@pytest.mark.parametrize("limit", ["crank", "message"])
def test_tripped_limit_carries_the_reference_report(limit):
    """A split-input BA (N=4, f=1) under a partition schedule and the
    reordering adversary trips its limit after 40; the CrankError's message
    and why-stalled report equal the reference's, key for key."""
    got = []
    for P in (REF, PORT):
        sched = P.vn.NetSchedule("split", latency=1, partitions=[
            P.vn.Partition(0, 500, (frozenset({0, 1}),))])
        b = (P.net(range(4)).num_faulty(1).adversary(P.adv.ReorderingAdversary())
             .schedule(sched).using(ba(P)))
        b = b.crank_limit(40) if limit == "crank" else b.message_limit(40)
        net = b.build(seed=4)
        propose_all(net, lambda i: i % 2 == 0)
        with pytest.raises(P.vn.CrankError) as err:
            net.crank_to_quiescence()
        got.append((str(err.value), err.value.report, summary(net)))
    assert got[1] == got[0]
    report = got[1][1]
    assert {"nodes", "summary", "scenario"} <= set(report)
    assert report["scenario"]["adversary"] and report["scenario"]["schedule"]
    json.dumps(report)


# -- the schedule layer --------------------------------------------------------------


SCHEDULES = {
    "latency-jitter": dict(latency=2, jitter=3),
    "drops": dict(drop=0.05),
    "per-link": dict(link_latency="by_sum", jitter=1),
    "partition-heal": dict(partitions=[(5, 300, ({0, 1},))]),
    "partition-drop": dict(partitions=[(0, 40, ({3},))], partition_mode="drop"),
}


def _schedule(P, name):
    kw = dict(SCHEDULES[name])
    if kw.get("link_latency") == "by_sum":
        kw["link_latency"] = lambda s, t: (s + t) % 3
    if "partitions" in kw:
        kw["partitions"] = [P.vn.Partition(a, z, tuple(frozenset(g) for g in gs))
                            for a, z, gs in kw["partitions"]]
    return P.vn.NetSchedule(name, **kw)


@pytest.mark.parametrize("protocol", ["ba", "hb"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_gives_the_reference_deliveries(name, protocol):
    got = []
    for P in (REF, PORT):
        net = (P.net(range(4)).num_faulty(1).schedule(_schedule(P, name))
               .crank_limit(500_000).using(ba(P) if protocol == "ba" else hb(P)).build(seed=8))
        propose_all(net, (lambda i: i < 2) if protocol == "ba" else (lambda i: ("tx", i)))
        net.crank_to_quiescence()
        got.append(summary(net))
    assert got[1] == got[0]
    assert got[1]["net_counters"]["schedule_delayed"] + got[1]["net_counters"][
        "schedule_dropped"] > 0


# -- the attack library --------------------------------------------------------------


ATTACKS = {
    "equivocating": ("EquivocatingAdversary", {}),
    "withholding": ("WithholdingAdversary", {}),
    "withholding-half": ("WithholdingAdversary", {"fraction": 0.5}),
    "crafted-shares": ("CraftedShareAdversary", {}),
    "crafted-half": ("CraftedShareAdversary", {"rate": 0.5}),
    "replay": ("ReplayAdversary", {}),
    "laggard": ("LaggardAdversary", {"lag_cranks": 300}),
    "node-order": ("NodeOrderAdversary", {}),
}


@pytest.mark.parametrize("defer_mode", ["eager", "round"])
@pytest.mark.parametrize("attack", list(ATTACKS))
def test_attack_library_equals_the_reference(attack, defer_mode):
    """Each attack against one HoneyBadger epoch (N=4, f=1): the same
    outputs, fault attribution and deliveries."""
    cls, kw = ATTACKS[attack]
    got = []
    for P in (REF, PORT):
        net = (P.net(range(4)).num_faulty(1).defer_mode(defer_mode)
               .adversary(getattr(P.adv, cls)(**kw)).crank_limit(500_000).using(hb(P))
               .build(seed=5))
        propose_all(net, lambda i: {"tx": i})
        if defer_mode == "eager":
            net.crank_to_quiescence()
        else:
            while True:
                while net.queue or net._pending_work:
                    net.crank_round()
                # an idle crank runs the adversary's pre_crank (the laggard
                # releases what it holds) and fast-forwards future messages
                if net.crank() is None:
                    break
        got.append(summary(net))
    assert got[1] == got[0]
    assert all(len(v) == 1 for i, v in got[1]["outputs"].items() if i not in got[1]["faulty"])


class Classifier:
    """Records ``classify_inner`` of every message a faulty node sends."""

    def __init__(self, P):
        self.seen = []

        class Rec(P.adv.Adversary):
            def tamper(inner, net, msg):
                self.seen.append(P.adv.classify_inner(msg.payload))
                return [msg]

        self.adversary = Rec()


def test_classify_inner_equals_the_reference():
    """Every envelope the port can produce (HB ⊃ Subset ⊃ {Broadcast, BA ⊃
    coin}, HB ⊃ decryption share) is classified as the reference does."""
    got = []
    for P in (REF, PORT):
        rec = Classifier(P)
        net = (P.net(range(4)).num_faulty(1).adversary(rec.adversary).using(hb(P))
               .build(seed=6))
        propose_all(net, lambda i: i)
        net.crank_to_quiescence()
        got.append(rec.seen)
    assert got[1] == got[0]
    assert set(got[1]) == {None, "value", "echo", "ready", "dec_share"}


# -- observers -----------------------------------------------------------------------


def test_tracer_and_event_log_record_the_reference_events():
    """A Tracer with crank spans and an EventLog attached to an N=4 round-
    mode HoneyBadger epoch: the same span events (times aside), histogram
    counts, queue-depth distribution and event log."""
    got = []
    for P in (REF, PORT):
        tracer, events = P.tracer.Tracer(), P.metrics.EventLog()
        tracer.crank_spans = True
        net = (P.net(range(4)).num_faulty(1).defer_mode("round").trace(tracer)
               .trace(events).using(hb(P)).build(seed=7))
        assert net.backend.tracer is tracer
        propose_all(net, lambda i: [i])
        while net.queue or net._pending_work:
            net.crank_round()
        spans = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
                 for e in tracer.events]
        hists = {k: h.count for k, h in sorted(tracer.histograms.items())}
        got.append((spans, hists, tracer.hist("net_queue_depth").summary(),
                    list(events.events), summary(net)))
    assert got[1] == got[0]
    spans, hists = got[1][:2]
    assert {s["name"] for s in spans} >= {"crank:HbMessage"}
    assert hists["crank_latency_us"] == hists["net_queue_depth"] == got[1][4]["delivered"]


def _drain_without(net, drop, max_cranks=200_000):
    """test_obs_health.py's: crank with the matching messages dropped."""
    for _ in range(max_cranks):
        net.queue[:] = [m for m in net.queue if not drop(m)]
        if not net.queue:
            net._flush_work()
            net.queue[:] = [m for m in net.queue if not drop(m)]
            if not net.queue:
                return
        net.crank()
    raise AssertionError("did not quiesce")


@pytest.mark.parametrize("stall", ["coin", "echo", "none"])
def test_why_stalled_equals_the_reference(stall):
    """test_obs_health.py's three stall shapes: BA blocked on its coin, an
    RBC without its echo quorum, a finished run."""
    got = []
    for P in (REF, PORT):
        b = P.net(range(4)).num_faulty(1).crank_limit(500_000)
        if stall == "echo":
            net = b.using(rbc(P)).build(seed=3)
            net.send_input(0, b"payload")
            _drain_without(net, lambda m, P=P: isinstance(m.payload, P.bc.BroadcastMessage)
                           and m.payload.kind == "echo")
        else:
            net = b.using(ba(P, b"stall")).build(seed=0 if stall == "coin" else 1)
            propose_all(net, (lambda i: i % 2 == 0) if stall == "coin" else (lambda i: True))
            _drain_without(net, lambda m, P=P: stall == "coin" and isinstance(
                m.payload, P.ba.BaMessage) and m.payload.kind == "coin")
        report = P.health.why_stalled(net)
        got.append((report, P.health.render_why_stalled(report)))
    assert got[1] == got[0]
    assert bool(got[1][0]["summary"]) == (stall != "none")


class _Stamps:
    """A recorder for the critical-path stamp seam: keeps every stamp."""

    def __init__(self):
        self.events = []

    def stamp(self, phase, **kw):
        self.events.append((phase, tuple(sorted((k, repr(v)) for k, v in kw.items()))))


def test_critpath_stamps_equal_the_reference():
    """A recorder activated on each package's stamp seam over an N=4
    round-mode HoneyBadger epoch receives the reference's stamps (RBC
    outputs, BA decisions and coins, decrypt combines, the commit), in
    the same order; with none active a stamp is a no-op."""
    import importlib

    got = []
    for P, root in ((REF, "hbbft_tpu"), (PORT, "hbbft_tpu_torch")):
        cp = importlib.import_module(f"{root}.obs.critpath")
        rec = _Stamps()
        cp.activate(rec)
        try:
            net = P.net(range(4)).num_faulty(1).defer_mode("round").using(hb(P)).build(seed=12)
            propose_all(net, lambda i: [bytes([i])])
            while net.queue or net._pending_work:
                net.crank_round()
        finally:
            cp.deactivate()
        cp.stamp("epoch.commit", node=0, epoch=0)  # none active: dropped
        got.append((rec.events, summary(net)))
    assert got[1] == got[0]
    phases = {p for p, _ in got[1][0]}
    assert {"rbc.output", "ba.decide", "decrypt.combine", "epoch.commit"} <= phases


# -- the verify skill's handle -------------------------------------------------------


def test_verify_skill_ba_handle_equals_the_reference():
    """BinaryAgreement at N=7, f=2 under the reordering adversary in round
    mode, seed 99: every correct node decides the same single bit, as in
    the reference."""
    got = []
    for P in (REF, PORT):
        net = (P.net(range(7)).num_faulty(2).adversary(P.adv.ReorderingAdversary())
               .defer_mode("round").using(ba(P, b"drive")).build(seed=99))
        propose_all(net, lambda i: i % 2 == 0)
        while net.queue or net._pending_work:
            net.crank_round()
        got.append(summary(net))
    assert got[1] == got[0]
    decided = [v for i, v in got[1]["outputs"].items() if i not in got[1]["faulty"]]
    assert len(decided) == 5 and all(d == decided[0] and len(d) == 1 for d in decided)


@pytest.mark.parametrize("n, f, counts", [
    (16, 5, (27_120, 256, 3_368, 1_536)),
    (32, 10, (223_200, 1_024, 26_315, 11_264)),
])
def test_round_mode_honey_badger_epoch_equals_the_reference(n, f, counts):
    """The smoke's object-runtime net on the mock (``defer_mode("round")``,
    every epoch encrypted (the default schedule), seed 11, one epoch): the same Batches,
    deliveries and counters as the reference.  A share that reaches an
    instance after it combined is dropped unchecked, so the share
    verifies stay below N²(N−1) (3,840 and 31,744)."""
    got = []
    for P in (REF, PORT):
        net = (P.net(range(n)).num_faulty(f).defer_mode("round")
               .using(hb(P, b"chip-smoke")).build(seed=11))
        propose_all(net, lambda i: [bytes([i, j]) * 5 for j in range(25)])
        while net.queue or net._pending_work:
            net.crank_round()
        got.append(summary(net))
    assert got[1] == got[0]
    c = got[1]["backend_counters"]
    assert (got[1]["delivered"], c["ciphertexts_verified"], c["dec_shares_verified"],
            c["dec_shares_combined"]) == counts
    assert c["dec_shares_verified"] < n * n * (n - 1)
