"""The port's composed soak half (``net/scenarios.py``: ``Cell``,
``run_cell``, the churn/crash/traffic registries) and its soak CLI
(``hbbft_tpu_torch/tools/soak.py``) against the JAX package's.

The composed cells of the reference's ``tests/test_crashes.py``, the
``run_cell`` cases of ``tests/test_critpath.py`` and the snapshot twin
over a soak cell of ``tests/test_snapshot.py`` run in both packages
through :mod:`torch_twin`, each on its own package's ``MockBackend``: the
reference test's own checks hold in each and the two runs' soak rows,
``SoakResult.fingerprint()``s (batch digest, fault log, tracker
fingerprint, crash trace), series rows, controller decisions and
why-stalled reports are equal call for call.  The soak CLI replays a
record to exit 0, flags a wrong fingerprint with exit 2 and folds a race
explorer's counterexample in as a ``race-cex:<file>`` row (the
reference's row), and without a backend both ``run_cell`` and the CLI
take the card.  The composed-cell
stability case's second seed runs behind ``-m slow``.
"""

import json

import pytest

from torch_twin import TwinModule, behind_slow, twin

import hbbft_tpu.net.scenarios as REF
import hbbft_tpu_torch.net.scenarios as PORT

CRASHES = TwinModule("test_crashes.py", port_subs=[
    ('    sys.path.insert(0, "tools")\n    import soak\n',
     '    from hbbft_tpu_torch.tools import soak\n'),
    ("soak.replay_record(str(rec), 5_000_000)", 'soak.replay_record(str(rec), 5_000_000, "mock")'),
    ("soak.replay_record(str(bad), 5_000_000)", 'soak.replay_record(str(bad), 5_000_000, "mock")'),
])
CRITPATH = TwinModule("test_critpath.py")
SNAPSHOT = TwinModule("test_snapshot.py")

#: the second seed of the composed-cell stability case, past the file's
#: share of the suite's time (~5 s here; seed 3 stays)
SLOW = {"test_composed_cell_fingerprint_is_stable[11]"}
CASES = behind_slow([
    *(p for n in ("test_registries_cover_all_axes", "test_composed_cell_all_axes_on",
                  "test_composed_cell_fingerprint_is_stable",
                  "test_lossy_composed_cell_gated_bounded", "test_soak_replay_record_roundtrip")
      for p in CRASHES.params(n)),
    *(p for n in ("test_path_from_phase_seconds_gates_longest_phase",
                  "test_path_from_phase_seconds_ignores_unknown_keys",
                  "test_gating_histogram_and_series_agree", "test_diff_gating_flags_shifts_beyond_tol",
                  "test_phase_labels_are_human_vocabulary",
                  "test_run_cell_attributes_gates_and_clears_hook",
                  "test_restart_epoch_gated_by_crash_recovery", "test_fingerprint_identical_with_obs_off",
                  "test_series_and_gating_replay_bit_identically",
                  "test_why_stalled_leads_with_gate_line")
      for p in CRITPATH.params(n)),
    *SNAPSHOT.params("test_dynamic_twin_live_state_instances_roundtrip_key_identical"),
], SLOW)
MODULES = {"test_crashes": CRASHES, "test_critpath": CRITPATH, "test_snapshot": SNAPSHOT}
OWNER = {p.values[0]: m for m in MODULES.values() for p in CASES
         if hasattr(m.copies["hbbft_tpu"], p.values[0])}


@pytest.mark.parametrize("name,kwargs", CASES)
def test_port_equals_the_reference(name, kwargs, tmp_path):
    twin(OWNER[name], name, kwargs, tmp_path)


def test_soak_registries_equal_the_reference():
    """The same churn, crash and traffic axes: names, descriptions, what
    each ``make`` builds at a few shapes, and the traffic specs' rate,
    controller and trace."""
    def reg(sc):
        churns = {k: (c.description, [c.make(n, e) for n in (4, 16) for e in (6, 12, 200)])
                  for k, c in sc.CHURNS.items()}
        crashes = {}
        for k, c in sc.CRASHES.items():
            made = [c.make(n, e) for n in (4, 16) for e in (6, 10, 200)]
            crashes[k] = (c.description, [
                None if s is None else (s.recommit_epochs, s.checkpoint_every,
                                        [(ev.node_id, ev.at_epoch, ev.down_epochs)
                                         for ev in s.events])
                for s in made])
        traffics = {k: (t.rate_frac, t.description, t.adaptive, t.trace)
                    for k, t in sc.TRAFFICS.items()}
        return churns, crashes, traffics

    assert reg(PORT) == reg(REF)
    assert PORT.Cell.__dataclass_fields__.keys() == REF.Cell.__dataclass_fields__.keys()
    cell = PORT.Cell(crash="one_restart", traffic="swing_adaptive", seed=4)
    assert cell.cell_id() == REF.Cell(**cell.to_dict()).cell_id()
    assert PORT.Cell.from_dict(cell.to_dict()) == cell


def test_soak_cli_replay_round_trip(tmp_path, capsys):
    """``--replay`` reproduces a failed-cell record written by
    ``--fail-dir`` (exit 0) and flags a tampered fingerprint (exit 2);
    ``--json`` holds the row; the reference's CLI gives the same row."""
    from hbbft_tpu_torch.tools import soak

    spec = "replay_flood:lan:none:one_restart:half_x"
    out = tmp_path / "rows.json"
    rc = soak.main(["--backend", "mock", "--cells", spec, "--n", "4", "--epochs", "6",
                    "--seeds", "6", "--json", str(out)])
    assert rc == 0
    (row,) = json.loads(out.read_text())["rows"]
    cell = PORT.Cell.from_dict(row)
    ref = REF.run_cell(REF.Cell(**cell.to_dict()))
    assert row["fingerprint"] == ref.fingerprint()
    assert {k: v for k, v in row.items() if k not in ("wall_s",)} == json.loads(
        json.dumps({**ref.row(), "p99_ok": row["p99_ok"], "clean_p99": row["clean_p99"]},
                   default=repr))
    rec, _ = soak.write_failed(str(tmp_path / "failed"), cell, dict(row))
    assert soak.main(["--backend", "mock", "--replay", rec]) == 0
    doc = json.loads(open(rec).read())
    doc["fingerprint"] = "0" * 64
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert soak.main(["--backend", "mock", "--replay", str(bad)]) == 2
    assert "DIVERGED" in capsys.readouterr().out
    # a race-explorer counterexample folds in as a cell of its own: the
    # mutant's divergence still reproduces, so the row fails (exit 1) and
    # equals the reference's row for the same file
    from hbbft_tpu_torch.analysis import schedules

    cx = tmp_path / "cx.json"
    schedules.write_counterexample(cx, schedules.explore("mutant:counter", 4, seed=0))
    out2 = tmp_path / "cex.json"
    rc = soak.main(["--backend", "mock", "--cells", spec, "--n", "4", "--epochs", "6",
                    "--seeds", "6", "--race-cex", str(cx), "--json", str(out2)])
    assert rc == 1
    assert "FAIL race-cex:cx.json diverged=True reproduced=True" in capsys.readouterr().out
    cell_row, cex_row = json.loads(out2.read_text())["rows"]
    assert cell_row["ok"] and cell_row["fingerprint"] == row["fingerprint"]
    ref_soak = _reference_soak()
    ref_row = ref_soak.run_race_cex(str(cx))
    assert {k: v for k, v in cex_row.items() if k != "wall_s"} == json.loads(json.dumps(
        {k: v for k, v in ref_row.items() if k != "wall_s"}))
    assert (cex_row["kind"], cex_row["ok"]) == ("race_counterexample", False)


def _reference_soak():
    """The JAX package's soak CLI (``tools/soak.py``), imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "soak.py"
    spec = importlib.util.spec_from_file_location("reference_soak", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_cell_defaults_to_the_card():
    """Without a backend a soak cell takes ``TorchBackend()``, the card:
    on a machine without one it raises instead of running on the CPU."""
    import torch

    cell = PORT.Cell(n=4, epochs=2)
    if torch.cuda.is_available():
        assert type(PORT.build_cell_net(cell).backend).__name__ == "TorchBackend"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.build_cell_net(cell)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.run_cell(cell)


def test_soak_cli_defaults_to_the_card():
    """The soak CLI's ``--backend`` is ``torch``, the card, unless asked."""
    import torch

    from hbbft_tpu_torch.tools import soak

    argv = ["--cells", "passive:uniform", "--n", "4", "--epochs", "2"]
    if torch.cuda.is_available():
        assert type(soak.make_backend("torch")).__name__ == "TorchBackend"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            soak.main(argv)
