"""The port's observability modules (``hbbft_tpu_torch/obs/``,
``utils/metrics.py``) and its trace report
(``hbbft_tpu_torch/tools/trace_report.py``) against the JAX package's own
tests of them.

Every case of the reference's ``tests/test_flight.py``,
``test_timeseries.py``, ``test_obs_tracer.py``, ``test_obs_histogram.py``,
``test_metrics.py``, ``test_host_buckets.py``, ``test_phase_labels.py``,
``test_trace_smoke.py`` and the recorder and path cases of
``test_critpath.py`` runs in both packages through :mod:`torch_twin`: the
reference test's own checks hold in each, and the two runs' recorded
values are equal call for call (the default record: Batches, series rows,
soak rows and fingerprints, why-stalled reports; per module also
histogram summaries and percentiles, the tracer's events on a fake clock,
flight bundles, critical-path stamps and the trace report's verdicts).
``test_critpath.py``'s other ten cases (the array-engine half and the
``run_cell`` cases) ride ``tests/test_torch_soak.py``.

The port's text substitutions: ``tools/trace_report.py`` becomes the
port's ``hbbft_tpu_torch/tools/trace_report.py`` (imported, and read by
path for its no-package-import contract); the stamp scopes become the
port's directories; ``examples/simulation.py`` becomes
``hbbft_tpu_torch/tools/simulation.py`` with ``--backend mock`` (the
reference's CLI defaults to its mock, the port's to the card).

``test_host_buckets.py::test_traced_host_buckets_validate_and_cli`` checks
a wall-clock share (unattributed host time under 10%), which a loaded
host can push past its bar (it failed once in a full suite run and passes
alone): its twin runs behind ``-m slow``.
"""

import pytest

from torch_twin import RECORDED, TwinModule, behind_slow, twin

#: the reference's trace report → the port's (imported and read by path)
TRACE_REPORT = [("from tools.trace_report import", "from hbbft_tpu_torch.tools.trace_report import")]
#: the trace report's verdicts (pure functions of their inputs)
REPORT_CALLS = tuple(({"hbbft_tpu": "tools.trace_report",
                       "hbbft_tpu_torch": "hbbft_tpu_torch.tools.trace_report"}, None, fn)
                     for fn in ("validate_chrome_trace", "check_host_buckets",
                                "validate_forensics"))


def _untimed(args, events):
    """A tracer's events without their clock readings (some of the cases
    time on the host's clock)."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


MODULES = {
    "test_flight": TwinModule("test_flight.py", recorded=RECORDED + (
        ("obs.flight", "FlightRecorder", "bundle"),)),
    "test_timeseries": TwinModule("test_timeseries.py"),
    "test_critpath": TwinModule("test_critpath.py", recorded=RECORDED + (
        ("obs.critpath", "CritPathRecorder", "take"),)),
    "test_obs_tracer": TwinModule("test_obs_tracer.py", port_subs=TRACE_REPORT,
                                  recorded=RECORDED + REPORT_CALLS + (
                                      ("obs.tracer", "Tracer", "chrome_events", _untimed),)),
    "test_obs_histogram": TwinModule("test_obs_histogram.py", recorded=RECORDED + (
        ("obs.histogram", "Histogram", "summary"),
        ("obs.histogram", "Histogram", "percentile"))),
    "test_metrics": TwinModule("test_metrics.py"),
    "test_host_buckets": TwinModule("test_host_buckets.py", port_subs=TRACE_REPORT),
    "test_phase_labels": TwinModule("test_phase_labels.py", port_subs=[
        ("from tools import trace_report", "from hbbft_tpu_torch.tools import trace_report"),
        ('"hbbft_tpu/', '"hbbft_tpu_torch/'),
        ('(REPO / "tools" / "trace_report.py")',
         '(REPO / "hbbft_tpu_torch" / "tools" / "trace_report.py")'),
    ], recorded=RECORDED + REPORT_CALLS),
    "test_trace_smoke": TwinModule("test_trace_smoke.py", port_subs=TRACE_REPORT + [
        ("from examples.simulation import main as sim_main",
         "from hbbft_tpu_torch.tools.simulation import main as _sim_main\n\n\n"
         "def sim_main(argv):\n"
         "    return _sim_main([*argv, \"--backend\", \"mock\"])"),
    ]),
}

#: test_critpath.py's cases that ride tests/test_torch_soak.py
CRITPATH_ON_SOAK = {
    "test_path_from_phase_seconds_gates_longest_phase",
    "test_path_from_phase_seconds_ignores_unknown_keys",
    "test_gating_histogram_and_series_agree", "test_diff_gating_flags_shifts_beyond_tol",
    "test_phase_labels_are_human_vocabulary", "test_run_cell_attributes_gates_and_clears_hook",
    "test_restart_epoch_gated_by_crash_recovery", "test_fingerprint_identical_with_obs_off",
    "test_series_and_gating_replay_bit_identically", "test_why_stalled_leads_with_gate_line",
}
SLOW = {"test_host_buckets::test_traced_host_buckets_validate_and_cli"}

CASES = behind_slow([
    pytest.param(stem, *p.values, id=f"{stem}::{p.id}")
    for stem, mod in MODULES.items()
    for name in sorted(n for n in vars(mod.copies["hbbft_tpu"]) if n.startswith("test_"))
    if not (stem == "test_critpath" and name in CRITPATH_ON_SOAK)
    for p in mod.params(name)
], SLOW)


@pytest.mark.parametrize("stem,name,kwargs", CASES)
def test_port_equals_the_reference(stem, name, kwargs, tmp_path):
    twin(MODULES[stem], name, kwargs, tmp_path)


def test_every_named_case_runs():
    """The twin holds every case of each module (the critpath cases on the
    soak twin counted there), at the counts the reference files have."""
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_flight": 11, "test_timeseries": 8, "test_critpath": 9,
                      "test_obs_tracer": 7, "test_obs_histogram": 7, "test_metrics": 5,
                      "test_host_buckets": 18, "test_phase_labels": 5, "test_trace_smoke": 3}
