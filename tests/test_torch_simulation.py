"""The port's simulation CLI (``hbbft_tpu_torch/tools/simulation.py``)
against the JAX package's ``examples/simulation.py``.

Both CLIs run in-process on their package's ``MockBackend``
(``--backend mock``) with the same flags, for both engines, with and
without ``--trace`` (the cases of ``tests/test_trace_smoke.py``), and
through ``--checkpoint``/``--resume``.  Their per-epoch tables must agree
column for column but the wall seconds.  The object engine's bandwidth
model charges each message its pickled size, and a pickle names its
classes' modules, "hbbft_tpu_torch." six bytes longer than "hbbft_tpu.":
the ``same_sizes`` fixture has the port's CLI measure its pickles with the
reference's module names, so the virtual clocks, and with them the order
of deliveries, agree exactly.  The traces must validate against the
Chrome trace-event schema and hold the same span categories and names.
The port's CLI defaults to the card.
"""

import json
import pickle

import pytest

from examples.simulation import main as ref_main
from hbbft_tpu_torch.tools.simulation import main as port_main
from tools.trace_report import device_span_seconds, kind_table, load_events, validate_chrome_trace

COLUMNS = ("epoch", "virt ms", "wall s", "txns", "msgs", "shr.vrf", "pairchk", "shr.cmb", "disp")


def table(out: str) -> list:
    """The per-epoch rows of a run's printed table, as column -> number."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["epoch", "virt"])
    rows = []
    for ln in lines[start + 1:]:
        if ln.startswith("total:"):
            break
        rows.append(dict(zip(COLUMNS, (float(v) for v in ln.split()))))
    return rows


class _RefNamedPickle:
    """``pickle`` for the port's size model, module names as the
    reference's."""

    @staticmethod
    def dumps(obj, protocol=None):
        return pickle.dumps(obj, protocol=protocol).replace(b"hbbft_tpu_torch.", b"hbbft_tpu.")


@pytest.fixture(autouse=True)
def same_sizes(monkeypatch):
    from hbbft_tpu_torch.tools import simulation

    monkeypatch.setattr(simulation, "pickle", _RefNamedPickle)


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def both(argv, capsys, port_extra=("--backend", "mock")):
    """Each CLI's table: the reference's (its default backend is the mock)
    and the port's on the mock."""
    ref = table(run(ref_main, list(argv), capsys))
    port = table(run(port_main, list(argv) + list(port_extra), capsys))
    return ref, port


def assert_tables_equal(ref, port):
    assert len(ref) == len(port) and ref
    for a, b in zip(ref, port):
        assert {k: v for k, v in a.items() if k != "wall s"} == \
               {k: v for k, v in b.items() if k != "wall s"}


CASES = {
    "object": ["-n", "4", "-f", "1", "--epochs", "3"],
    "object-n7-window": ["-n", "7", "-f", "2", "-b", "20", "--txns", "30", "--epochs", "2",
                         "--crypto-window", "16"],
    "array": ["-n", "4", "-f", "1", "--epochs", "3", "--engine", "array"],
    "array-coin-churn": ["-n", "4", "-f", "1", "--epochs", "3", "--engine", "array",
                         "--coin-rounds", "1", "--churn-at", "1"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_equals_the_reference(case, capsys):
    assert_tables_equal(*both(CASES[case], capsys))


@pytest.mark.parametrize("engine", ["object", "array"])
def test_checkpoint_resume_equals_uninterrupted(engine, tmp_path, capsys):
    """``--epochs 2 --checkpoint F`` then ``--epochs 4 --resume F`` gives
    the uninterrupted run's epochs 2 and 3, in each package, and the
    packages agree."""
    base = ["-n", "4", "-f", "1", "-b", "3", "--txns", "12", "-t", "8", "--lam", "10",
            "--seed", "7", "--engine", engine]
    got = []
    for main, extra, tag in ((ref_main, [], "ref"), (port_main, ["--backend", "mock"], "port")):
        snap = str(tmp_path / f"{tag}.snap")
        full = table(run(main, base + ["--epochs", "4"] + extra, capsys))
        run(main, base + ["--epochs", "2", "--checkpoint", snap] + extra, capsys)
        resumed = table(run(main, base + ["--epochs", "4", "--resume", snap] + extra, capsys))
        assert [r["epoch"] for r in resumed] == [2, 3]
        keep = ("epoch", "txns")
        assert [{k: r[k] for k in keep} for r in resumed] == \
               [{k: r[k] for k in keep} for r in full[2:]]
        got.append((full, resumed))
    for a, b in zip(got[0], got[1]):
        assert_tables_equal(a, b)


def trace_of(main, argv, path, capsys):
    run(main, argv + ["--trace", path], capsys)
    events = load_events(path)
    assert validate_chrome_trace(events) == []
    return events


def begins(events):
    return sorted({(e["cat"], e["name"]) for e in events if e.get("ph") == "B"})


def test_object_engine_trace_equals_the_reference(tmp_path, capsys):
    argv = ["-n", "4", "-f", "1", "--epochs", "1", "--heartbeat", "3600"]
    ref = trace_of(ref_main, argv, str(tmp_path / "ref.json"), capsys)
    path = str(tmp_path / "port.json")
    port = trace_of(port_main, argv + ["--backend", "mock"], path, capsys)
    hists = json.load(open(path))["otherData"]["histograms"]
    assert hists["crank_latency_us"]["count"] > 0 and "p99" in hists["crank_latency_us"]
    assert "epoch" in {c for c, _ in begins(port)}
    assert device_span_seconds(port) == 0.0
    assert begins(port) == begins(ref)


@pytest.mark.parametrize("suffix", ["json", "jsonl"])
def test_array_engine_trace_equals_the_reference(suffix, tmp_path, capsys):
    argv = ["-n", "4", "-f", "1", "--epochs", "1", "--engine", "array"]
    ref = trace_of(ref_main, argv, str(tmp_path / f"ref.{suffix}"), capsys)
    port = trace_of(port_main, argv + ["--backend", "mock"], str(tmp_path / f"port.{suffix}"),
                    capsys)
    cats = {c for c, _ in begins(port)}
    assert {"epoch", "subset", "rbc", "ba", "coin"} <= cats
    names = {n for _, n in begins(port)}
    assert any(n.startswith("dispatch:") for n in names)
    assert any(n.startswith("ba:") for n in names)
    assert any(n.startswith("coin_round:") for n in names)
    assert ("epoch", False) in {(r["cat"], r["device"]) for r in kind_table(port)}
    assert begins(port) == begins(ref)


def test_simulation_defaults_to_the_card(capsys):
    """Without ``--backend`` the port's CLI runs on ``TorchBackend()``, the
    card: on a machine without one it raises instead of running on the CPU
    (``--backend cpu`` asks for ``TorchBackend(device="cpu")``)."""
    import torch

    from hbbft_tpu_torch.tools import simulation

    argv = ["-n", "4", "-f", "1", "--epochs", "1"]
    if torch.cuda.is_available():
        assert "backend=torch " in run(port_main, argv, capsys)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main(argv)
    cpu = simulation.make_backend("cpu")
    assert type(cpu).__name__ == "TorchBackend" and cpu.device.type == "cpu"
    assert type(simulation.make_backend("mock")).__name__ == "MockBackend"


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_health_reporter_equals_the_reference():
    """The heartbeat and stall detector the CLI's ``--heartbeat`` and
    ``--stall-timeout`` drive, on a fake clock (the cases of
    ``tests/test_obs_health.py``): the same beats (period, rates, counter
    deltas, device share) and stall records (one-shot per episode, re-armed
    by epoch progress only, the quiesced report) in both packages."""
    import importlib

    got = []
    for root in ("hbbft_tpu", "hbbft_tpu_torch"):
        health = importlib.import_module(f"{root}.obs.health")
        clock, sink = _Clock(), []
        counters = {"device_seconds": 0.0, "pairing_checks": 0}
        hr = health.HealthReporter(
            interval_s=10.0, stall_timeout_s=30.0, counters_fn=lambda: dict(counters),
            stall_report_fn=lambda: {"nodes": {}, "summary": ["ba blocked"]},
            sink=sink.append, clock=clock)
        out = [hr.tick(epoch=0, msgs=0)]
        for dt, dev, checks, epoch, msgs in ((10, 2.5, 40, 1, 500), (10, 2.5, 40, 2, 1500),
                                             (29, 3.0, 41, 2, 1600), (2, 3.0, 41, 2, 1700),
                                             (100, 3.0, 41, 2, 1800), (1, 3.0, 41, 3, 1900)):
            clock.t += dt
            counters.update(device_seconds=dev, pairing_checks=checks)
            out.append(hr.tick(epoch=epoch, msgs=msgs, faults=0))
        clock.t += 5
        out.append(hr.report_quiesced(epoch=3, msgs=1900))
        got.append((out, sink, hr.beats, hr.stalled))
    assert got[1] == got[0]
    assert any(r and r.get("stall") for r in got[1][0]) and got[1][2]
    json.dumps(got[1][1])
