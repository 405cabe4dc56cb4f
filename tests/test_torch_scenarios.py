"""The port's attack × schedule scenario matrix (``net/scenarios.py``)
against the JAX package's.

Every non-slow case of the reference's ``test_scenarios.py`` is run in
both packages, each cell on its own package's ``MockBackend`` with the
same attack, schedule, N, seed and scheduler.  The two must give equal
``ScenarioResult`` verdicts (``row()``, the fault log, the batch digest,
the why-stalled report and the forensics bundle of a failed cell), and
each must pass the reference test's own checks.  The schedule-layer and
CrankError cases hold whole nets (``summary``) and reports equal.
"""

import importlib

import pytest

from test_torch_protocols import PORT, REF, summary

SC = {id(REF): importlib.import_module("hbbft_tpu.net.scenarios"),
      id(PORT): importlib.import_module("hbbft_tpu_torch.net.scenarios")}
MATRIX_ATTACKS = SC[id(REF)].MATRIX_ATTACKS
MATRIX_SCHEDULES = SC[id(REF)].MATRIX_SCHEDULES


def scenario(P, attack, schedule, n, **kw):
    r = SC[id(P)].run_scenario(attack, schedule, n, backend=P.backend.MockBackend(), **kw)
    return r


def verdict(r):
    return (r.row(), r.ok, r.batches_identical, r.prefix_identical, r.fault_log, r.why,
            r.forensics)


def cell_ok(r):
    assert r.ok, (f"{r.attack}x{r.schedule}@n{r.n}: error={r.error} "
                  f"missing={r.missing_expected} misattributed={r.misattributed[:3]}")


def both(fn):
    got = [fn(P) for P in (REF, PORT)]
    assert got[1] == got[0]
    return got[1]


@pytest.mark.parametrize("attack", MATRIX_ATTACKS)
def test_fast_matrix_cell(attack):
    """Every attack × {uniform, partition_heal} at N∈{4,7}, seed 1."""
    def run(P):
        out = []
        for n in (4, 7):
            for schedule in ("uniform", "partition_heal"):
                r = scenario(P, attack, schedule, n, seed=1)
                cell_ok(r)
                out.append(verdict(r))
        return out

    both(run)


@pytest.mark.parametrize("schedule", MATRIX_SCHEDULES)
def test_fast_matrix_schedules(schedule):
    """Every eventual-delivery schedule × every attack at N=4, seed 2."""
    def run(P):
        out = []
        for attack in MATRIX_ATTACKS:
            r = scenario(P, attack, schedule, 4, seed=2)
            cell_ok(r)
            out.append(verdict(r))
        return out

    both(run)


def test_registries_equal_the_reference():
    """The same attacks (expected fault kinds, all registered), schedules
    and matrices, at the acceptance floor of ≥6 attacks × ≥4 schedules."""
    def reg(P):
        sc = SC[id(P)]
        known = importlib.import_module(
            sc.__name__.replace("net.scenarios", "core.fault_log")).all_fault_kinds()
        for a in sc.ATTACKS.values():
            assert set(a.expected_faults) <= known
        return ({k: (a.expected_faults, a.description) for k, a in sc.ATTACKS.items()},
                {k: (s.lossy, s.description) for k, s in sc.SCHEDULES.items()},
                sc.MATRIX_ATTACKS, sc.MATRIX_SCHEDULES, sc.MATRIX_SCHEDULES_ALL)

    attacks, _, matrix_attacks, matrix_schedules, every = both(reg)
    assert len(matrix_attacks) >= 6 and len(matrix_schedules) >= 4 and "lossy" in every
    planted = {k for faults, _ in attacks.values() for k in faults}
    assert {"broadcast:conflicting_values", "threshold_decrypt:invalid_share",
            "broadcast:multiple_echos"} <= planted


@pytest.mark.parametrize("attack", MATRIX_ATTACKS)
def test_lossy_cells_gated_bounded(attack):
    """The lossy schedule under the bounded-degradation contract, seeds 1
    and 5: a stalled cell is a flagged degraded pass naming its cause."""
    def run(P):
        out = []
        for seed in (1, 5):
            r = scenario(P, attack, "lossy", 4, seed=seed, crank_limit=200_000)
            assert r.ok, (attack, seed, r.error, r.misattributed[:3])
            if r.error is not None:
                assert r.bounded and (r.why or {}).get("summary")
            out.append(verdict(r))
        return out

    both(run)


def test_first_scheduler_mode():
    both(lambda P: [verdict(scenario(P, a, "lan", 4, seed=3, scheduler="first"))
                    for a in ("equivocate", "crafted_shares")])


@pytest.mark.parametrize("attack,schedule", [
    ("crafted_shares", "wan"),
    ("equivocate", "partition_heal"),
    ("replay_flood", "lan"),
])
def test_seeded_replay_is_bit_identical(attack, schedule):
    def run(P):
        a = scenario(P, attack, schedule, 4, seed=11)
        b = scenario(P, attack, schedule, 4, seed=11)
        assert verdict(a) == verdict(b)
        c = scenario(P, attack, schedule, 4, seed=12)
        assert c.ok and (c.cranks != a.cranks or c.fault_log != a.fault_log)
        return [verdict(a), verdict(c)]

    both(run)


def test_run_matrix_equals_the_reference():
    """``run_matrix`` with a backend factory: one fresh mock per cell."""
    both(lambda P: [verdict(r) for r in SC[id(P)].run_matrix(
        ns=(4,), attacks=("equivocate", "laggard"), schedules=("uniform", "wan"),
        backend_factory=P.backend.MockBackend)])


# -- the schedule layer and the CrankError diagnosis ----------------------------------


def hb_net(P, n, schedule, seed=0, crank_limit=500_000):
    return (P.net(range(n)).num_faulty(1).schedule(schedule).crank_limit(crank_limit)
            .using(lambda ni, be: P.hb.HoneyBadger(ni, be, session_id=b"sched"))
            .build(seed=seed))


def propose(net):
    for i in sorted(net.nodes):
        net.send_input(i, {"from": i})


def one_epoch(nt):
    return all(len(nd.outputs) >= 1 for nd in nt.correct_nodes())


def latency(P):
    net = hb_net(P, 4, P.vn.NetSchedule(name="t", latency=3, jitter=2))
    propose(net)
    net.crank_until(one_epoch)
    assert net.counters.schedule_delayed > 0 and net.counters.schedule_dropped == 0
    return [summary(net)]


def drops(P):
    net = hb_net(P, 7, P.vn.NetSchedule(name="t", drop=0.2), seed=5)
    propose(net)
    try:
        net.crank_to_quiescence()
    except P.vn.CrankError:
        pass
    assert net.counters.schedule_dropped > 0
    return [summary(net)]


def partition_holds(P):
    sched = P.vn.NetSchedule(name="t", partitions=(P.vn.Partition(0, 10_000, (frozenset({0, 1}),)),))
    net = hb_net(P, 4, sched)
    propose(net)
    part = sched.partitions[0]
    held = 0
    for _ in range(200):
        if net.now >= part.end:
            break
        assert not any(part.crosses(m.sender, m.to) for m in net.queue)
        for not_before, _seq, m in net._future:
            if part.crosses(m.sender, m.to):
                assert not_before >= part.end
                held += 1
        if net.crank() is None:
            break
    assert held > 0
    net.crank_until(one_epoch)
    return [held, summary(net)]


def partition_drop(P):
    sched = P.vn.NetSchedule(name="t", partitions=(P.vn.Partition(0, 10**9, (frozenset({2, 3}),)),),
                             partition_mode="drop")
    net = hb_net(P, 4, sched)
    propose(net)
    with pytest.raises(P.vn.CrankError) as err:
        net.crank_until(one_epoch)
    assert net.counters.schedule_dropped > 0
    return [str(err.value), err.value.report, summary(net)]


def names_attack_and_partition(P):
    sc = SC[id(P)]
    spec = sc.ScheduleSpec("split_forever", lambda n: P.vn.NetSchedule(
        name="split_forever", partitions=(P.vn.Partition(0, 10**9, (frozenset({2, 3}),)),),
        partition_mode="drop"))
    net = sc.build_scenario_net(sc.ATTACKS["crafted_shares"], spec, 4, seed=1,
                                crank_limit=100_000, backend=P.backend.MockBackend())
    propose(net)
    with pytest.raises(P.vn.CrankError) as err:
        net.crank_until(one_epoch)
    report = err.value.report
    ctx = report["scenario"]
    assert ctx["adversary"]["name"] == "CraftedShareAdversary"
    assert "crafted_shares" in ctx["scenario"]
    assert ctx["schedule"]["partition"]["isolates"] == [[2, 3]]
    assert "partition isolates {2, 3}" in str(err.value)
    assert "CraftedShareAdversary" in str(err.value) and report["nodes"]
    return [str(err.value), report, summary(net)]


def crank_limit_trip(P):
    net = hb_net(P, 4, None, crank_limit=10)
    propose(net)
    with pytest.raises(P.vn.CrankError) as err:
        net.crank_to_quiescence()
    assert err.value.report is not None and "crank limit 10 exceeded" in str(err.value)
    return [str(err.value), err.value.report, summary(net)]


def stall_as_verdict(P):
    r = scenario(P, "withhold_echo", "lossy", 4, seed=7, crank_limit=50_000)
    assert r.ok or r.error is not None
    return [verdict(r)]


NET_CASES = {
    "latency-delays-but-delivers": latency,
    "drop-schedule-counts-drops": drops,
    "partition-holds-cross-traffic-until-heal": partition_holds,
    "partition-drop-mode-severs-links": partition_drop,
    "crank-error-names-attack-and-partition": names_attack_and_partition,
    "crank-limit-trip-carries-report": crank_limit_trip,
    "run-scenario-surfaces-stall": stall_as_verdict,
}


@pytest.mark.parametrize("case", list(NET_CASES))
def test_port_equals_the_reference(case):
    both(NET_CASES[case])


def test_forensics_bundle_equals_the_reference(tmp_path):
    """A failed cell's flight-recorder bundle (``obs/flight.py``): a cell
    at a crank limit too small to finish carries the same bundle in both
    packages, which validates, summarises alike and survives a write/load
    round trip."""
    def run(P):
        flight = importlib.import_module(SC[id(P)].__name__.replace("net.scenarios",
                                                                    "obs.flight"))
        r = scenario(P, "equivocate", "uniform", 4, seed=1, crank_limit=300)
        assert not r.ok and r.forensics is not None
        assert flight.validate_bundle(r.forensics) == []
        path = flight.write_bundle(r.forensics, str(tmp_path / f"{flight.__name__}.json"))
        back = flight.load_bundle(path)
        assert flight.validate_bundle(back) == []
        return [verdict(r), flight.summarize_bundle(back), back]

    bundle = both(run)[2]
    assert bundle["reason"] == "crank_error" and bundle["frames"]


def test_build_scenario_net_defaults_to_the_card():
    """Without a backend a cell takes ``TorchBackend()``, the card: on a
    machine without one it raises instead of running on the CPU."""
    import torch

    sc = SC[id(PORT)]
    args = (sc.ATTACKS["passive"], sc.SCHEDULES["uniform"], 4)
    if torch.cuda.is_available():
        assert type(sc.build_scenario_net(*args).backend).__name__ == "TorchBackend"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sc.build_scenario_net(*args)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sc.run_scenario("passive", "uniform", 4)
