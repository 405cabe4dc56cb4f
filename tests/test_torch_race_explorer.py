"""The port's schedule-space race explorer (``analysis/schedules.py``,
``analysis/mutations.py``, ``parallel/shardpipe.py``, the ``MockBackend``
chunk pipeline and ``VirtualNet``'s controlled scheduler and race probe)
and its CLI (``python -m hbbft_tpu_torch.tools.race_explorer``) against
the JAX package's.

The non-slow cases of the reference's ``tests/test_race_explorer.py``
and every case of ``tests/test_shard_pipe.py`` (none needs a
``MeshBackend``) run in both packages through :mod:`torch_twin`, the
explorer's CLI pointed at the port's module.  The reference test's own
checks hold in each, and the two runs' ``Exploration.summary()``s,
``RunResult.fingerprint``s (every schedule run, the explorer's own
included) and counterexample documents (as written and as replayed) are
equal call for call: the tolerance is zero.  The reference's full sweep
stays behind ``-m slow``.  Its ``test_ci_entry_point_runs_clean_and_under_budget``
is left out: the reference's ``tools/ci.sh`` also runs the trace
report's forensics check and the soak CLI's ``--smoke-fail``, which the
port does not have yet.

The cases below them pin the smoke plan's counts against the reference,
each mutant through the CLI with a replay in a fresh process, and that
the hooks default to off.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from torch_twin import TwinModule, behind_slow, twin

import hbbft_tpu.analysis.schedules as REF
import hbbft_tpu.crypto.backend as REF_BACKEND
import hbbft_tpu.net.virtual_net as REF_NET
import hbbft_tpu_torch.analysis.schedules as PORT
import hbbft_tpu_torch.crypto.backend as PORT_BACKEND
import hbbft_tpu_torch.net.virtual_net as PORT_NET

REPO_ROOT = Path(__file__).resolve().parent.parent


def _dump(value) -> str:
    return json.dumps(value, sort_keys=True, default=repr)


#: the explorer's results, held equal call for call
RECORDED = (
    ("analysis.schedules", None, "explore", lambda args, ex: _dump(ex.summary())),
    ("analysis.schedules", "RunResult", "fingerprint"),
    ("analysis.schedules", None, "write_counterexample",
     lambda args, out: Path(args[0]).read_text(encoding="utf-8")),
    ("analysis.schedules", None, "replay_counterexample", lambda args, rep: _dump(rep)),
)

EXPLORER = TwinModule("test_race_explorer.py", recorded=RECORDED, port_subs=[
    ("[sys.executable, str(EXPLORER), *args]",
     '[sys.executable, "-m", "hbbft_tpu_torch.tools.race_explorer", *args]'),
])
SHARD = TwinModule("test_shard_pipe.py", recorded=RECORDED)

#: the root ci.sh gate is not ported (see the module docstring)
LEFT_OUT = {"test_ci_entry_point_runs_clean_and_under_budget"}
SLOW = {"test_full_sweep_explores_1000_schedules_and_agrees"}


def _cases(module: TwinModule):
    names = [n for n in vars(module.copies["hbbft_tpu"])
             if n.startswith("test_") and n not in LEFT_OUT]
    return [p for n in names for p in module.params(n)]


@pytest.mark.parametrize("name,kwargs", behind_slow(_cases(EXPLORER), SLOW))
def test_explorer_port_equals_the_reference(name, kwargs, tmp_path):
    twin(EXPLORER, name, kwargs, tmp_path)


@pytest.mark.parametrize("name,kwargs", _cases(SHARD))
def test_shard_pipe_port_equals_the_reference(name, kwargs, tmp_path):
    twin(SHARD, name, kwargs, tmp_path)


def test_smoke_plan_counts_equal_the_reference():
    """``SMOKE_PLAN`` on both packages: the same summaries, 145 runs, 121
    non-equivalent schedules and 98 DPOR prunes in all."""
    assert PORT.SMOKE_PLAN == REF.SMOKE_PLAN and PORT.FULL_PLAN == REF.FULL_PLAN
    totals = [0, 0, 0]
    for target, n, max_runs in PORT.SMOKE_PLAN:
        ours = PORT.explore(target, n, seed=0, max_runs=max_runs)
        assert ours.ok, ours.divergence
        assert _dump(ours.summary()) == _dump(REF.explore(target, n, seed=0, max_runs=max_runs).summary())
        assert ours.reference.fingerprint == REF.run_schedule(target, n, 0, []).fingerprint
        totals = [totals[0] + ours.runs, totals[1] + ours.classes, totals[2] + ours.pruned]
    assert totals == [145, 121, 98]


@pytest.mark.parametrize("mutant,runs", [("accum", 5), ("counter", 2), ("listener", 2), ("shard", 5)])
def test_cli_mutant_detected_and_replayed_in_a_fresh_process(mutant, runs, tmp_path):
    """Each mutant exits 1 with a minimised counterexample, after the
    reference's number of runs; ``--replay`` reproduces it in another
    process (exit 0) and the document equals the reference's."""
    cx = tmp_path / f"{mutant}.json"
    cli = [sys.executable, "-m", "hbbft_tpu_torch.tools.race_explorer"]
    proc = subprocess.run([*cli, "--target", f"mutant:{mutant}", "--counterexample", str(cx)],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f"runs={runs} " in proc.stdout and "ok=False" in proc.stdout
    rep = subprocess.run([*cli, "--replay", str(cx)],
                         cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stdout + rep.stderr
    assert "diverged=True reproduced=True" in rep.stdout
    ref = REF.explore(f"mutant:{mutant}", 4, seed=0, max_runs=120)
    REF.write_counterexample(tmp_path / "ref.json", ref)
    assert cx.read_text() == (tmp_path / "ref.json").read_text()


def test_hooks_default_off_as_in_the_reference():
    """The mock's chunk pipeline and the net's explorer hooks are off
    unless asked for, and ride the snapshot's environment list."""
    for attr in ("pipeline_chunk", "resolve_order", "chunk_listeners"):
        assert getattr(PORT_BACKEND.MockBackend, attr) == getattr(REF_BACKEND.MockBackend, attr)
    assert PORT_BACKEND.MockBackend().pipeline_chunk is None
    assert PORT_NET.VirtualNet._SNAPSHOT_ENV_ATTRS == REF_NET.VirtualNet._SNAPSHOT_ENV_ATTRS
    assert PORT_NET.VirtualNet.crank_chooser is None and PORT_NET.VirtualNet.race_probe is None
    builder = PORT_NET.NetBuilder(range(4)).scheduler("controlled")
    assert builder._scheduler == "controlled"


def test_explorer_imports_no_torch():
    """The mock targets run with no torch: the port's pipeline module is
    import-light, as the reference's is of JAX."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from hbbft_tpu_torch.analysis import schedules, mutations; "
         "schedules.run_schedule('pipeline', 4, 0, []); print('torch' in sys.modules)"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
