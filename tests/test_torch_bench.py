"""The port's bench (``hbbft_tpu_torch/tools/bench``) held against the JAX
package's ``bench.py``.

* Every case of ``tests/test_bench_budget.py`` runs in both packages
  through ``tests/torch_twin.py``: the planner's row orders equal row for
  row (the port's ``array_n100_cuda`` is the reference's
  ``array_n100_tpu``), and the budget runs leave the same labelled rows.
* The mock-backed rows run in both packages at the reference's shapes,
  cut small through their own ``BENCH_*`` knobs, and must be equal field
  for field with tolerance zero, apart from what a wall clock decides
  (``timing_free``).
* The card rows run on the CPU request at tiny shapes: their own spot
  checks and A/B assertions hold, their count fields follow the
  reference's definitions, and every field of the reference's row at the
  same knobs is equal.  The reference side of a card row compiles XLA:CPU
  graphs for tens of seconds, so all but the RS rows are behind
  ``-m slow``.
* No fallback: without a card and without the CPU request the bench
  exits non-zero at once; a row whose kernel raises is not retried, gives
  an error row, and the process exits non-zero, as it does when a row
  reports a failure in its own fields.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_twin import TwinModule

import hbbft_tpu_torch.tools.bench as PORT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _load_reference():
    spec = importlib.util.spec_from_file_location("bench_reference", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()
BENCHES = {"hbbft_tpu": REF, "hbbft_tpu_torch": PORT}

#: the budget tests' text substitutions for the port's copy
BUDGET = TwinModule("test_bench_budget.py", port_subs=(
    # the bench.py path becomes the port's module
    ('[sys.executable, os.path.join(_REPO, "bench.py")]',
     '[sys.executable, "-m", "hbbft_tpu_torch.tools.bench"]'),
    # the reference's platform "tpu" is the port's card, "cuda"
    ('"tpu"', '"cuda"'),
    ("array_n100_tpu", "array_n100_cuda"),
    ("BENCH_N100_TPU_EPOCH_EST", "BENCH_N100_CUDA_EPOCH_EST"),
    # the subprocess's JAX environment becomes the port's CPU request
    ('JAX_PLATFORMS="cpu",\n        XLA_FLAGS="--xla_force_host_platform_device_count=1",\n'
     '        BENCH_PLATFORM_CHECKED="1",', 'BENCH_DEVICE="cpu",'),
), recorded=())


def _budget_cases():
    cases = []
    for name in sorted(n for n in vars(BUDGET.copies["hbbft_tpu"]) if n.startswith("test_")):
        cases += BUDGET.params(name)
    return cases


def _plan_names(names):
    return [n.replace("array_n100_cuda", "array_n100_tpu") for n in names]


@pytest.mark.parametrize("test_name, kwargs", _budget_cases())
def test_budget_case_in_both_packages(test_name, kwargs, tmp_path, monkeypatch):
    """Each budget test passes against both benches, and the two call the
    planner with the same arguments and get the same row order back."""
    plans = {}
    for root, bench in BENCHES.items():
        calls = plans[root] = []
        plan = bench._plan_benches

        def recorded(only, platform, budget, plan=plan, calls=calls):
            out = plan(only, platform, budget)
            calls.append((platform.replace("cuda", "tpu"), budget,
                          _plan_names(n for n, _ in out)))
            return out

        monkeypatch.setattr(bench, "_plan_benches", recorded)
        (tmp_path / root).mkdir()
        BUDGET.run(root, test_name, {**kwargs, "bench": bench}, tmp_path / root)
        monkeypatch.undo()
    assert plans["hbbft_tpu_torch"] == plans["hbbft_tpu"]


def test_every_row_has_its_reference_row():
    """The port plans every row of the reference, under the same names
    (array_n100_cuda for array_n100_tpu), in both orders and on both
    platforms, with an estimate for each."""
    for budget in (0.0, 3000.0):
        for ref_plat, port_plat in (("tpu", "cuda"), ("cpu", "cpu")):
            ref = [n for n, _ in REF._plan_benches(None, ref_plat, budget)]
            port = _plan_names(n for n, _ in PORT._plan_benches(None, port_plat, budget))
            assert port == ref
    assert set(PORT._BENCH_EST_S) == {n.replace("_tpu", "_cuda") if n == "array_n100_tpu"
                                      else n for n in REF._BENCH_EST_S}


#: a row's fields that a wall clock decides: a time, a rate or ratio
#: derived from one (``value``, ``*per_sec*``, ``*_per_s``, ``*_per_s_*``
#: such as adv_matrix's ``epochs_per_s_est``, ``*seconds*``,
#: ``wall_s``, ``vs_baseline*``, the host buckets' seconds, the
#: ``*_fraction`` shares of seconds, the A/B rows' rate ratios ``*_vs_*``
#: and ``*_over_*``), and the fields chosen by comparing wall-clock rates
#: (``best_cell``, ``controller_beats_fixed``, ``adaptive_beats_fixed_*``)
TIMING = re.compile(r"^value$|per_sec|_per_s($|_)|seconds|^wall_s$|^vs_baseline|^host_bucket"
                    r"|_fraction$|_vs_|_over_|^best_cell$|^controller_beats_fixed$"
                    r"|^adaptive_beats_fixed")


def timing_free(obj):
    """``obj`` with every wall-clock field (``TIMING``) taken out, at any depth."""
    if isinstance(obj, dict):
        return {k: timing_free(v) for k, v in obj.items() if not TIMING.search(k)}
    if isinstance(obj, list):
        return [timing_free(v) for v in obj]
    return obj


#: the mock rows at the reference's shapes, cut small through their knobs
MOCK_KNOBS = {
    "scenario_matrix": {"BENCH_SCEN_NS": "4"},
    "crash_matrix": {"BENCH_CRASH_N": "4", "BENCH_CRASH_EPOCHS": "3"},
    "qhb_traffic": {"BENCH_QHB_N": "4", "BENCH_QHB_EPOCHS": "2", "BENCH_QHB_CLIENTS": "1000",
                    "BENCH_QHB_BATCHES": "16", "BENCH_QHB_RATES": "1.0,2.0",
                    "BENCH_QHB_N100_N": "4", "BENCH_QHB_N100_EPOCHS": "1"},
    "slo_traffic": {"BENCH_SLO_N": "4", "BENCH_SLO_EPOCHS": "2", "BENCH_SLO_CLIENTS": "1000",
                    "BENCH_SLO_BATCHES": "8,32"},
    "n4": {"BENCH_N4_EPOCHS": "2"},
    "array_n100": {"BENCH_ARRAY_N": "4", "BENCH_ARRAY_EPOCHS": "2"},
    "array_n100_dedup": {"BENCH_ARRAY_N": "4", "BENCH_ARRAY_EPOCHS": "2"},
    # N is fixed (256, 64): one timed epoch each, ~100 s and ~5 s a package
    "array_n256_soak": {"BENCH_SOAK_EPOCHS": "1"},
    "array_n64_coin": {"BENCH_COIN_MACRO_EPOCHS": "1"},
}
SLOW_MOCK_ROWS = {"array_n256_soak", "array_n64_coin"}


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW_MOCK_ROWS else n for n in MOCK_KNOBS])
def test_mock_row_equals_the_reference(name, monkeypatch):
    for k, v in MOCK_KNOBS[name].items():
        monkeypatch.setenv(k, v)
    ref = dict(REF._plan_benches(None, "tpu", 0.0))[name]()
    port = dict(PORT._plan_benches(None, "cuda", 0.0))[name]()
    if name == "scenario_matrix":
        # the port names the mock it runs on (its library defaults to the card)
        assert port.pop("backend") == "MockBackend" and "backend" not in ref
    if "backend" in ref:
        assert ref["backend"] in ("MockBackend", "mock")
    assert timing_free(port) == timing_free(ref)
    assert set(port) == set(ref)


@pytest.mark.parametrize("frac", [0.0, 0.25])
def test_contaminated_items_equal_the_reference(frac):
    """``_adv_contaminated_items`` on each package's MockBackend: the
    reference's verdicts and forged positions."""
    from hbbft_tpu.crypto.backend import MockBackend as RefMock

    from hbbft_tpu_torch.crypto.backend import MockBackend

    ref_items, ref_want = REF._adv_contaminated_items(RefMock(), 3, 4, frac)
    items, want = PORT._adv_contaminated_items(MockBackend(), 3, 4, frac)
    assert want == ref_want and len(items) == len(ref_items) == 12
    assert [i for i, w in enumerate(want) if not w] == [i for i, w in enumerate(ref_want)
                                                         if not w]
    assert sum(not w for w in want) == (max(1, int(frac * 12)) if frac else 0)


#: the card rows at tiny shapes on the CPU request, through their knobs
CARD_KNOBS = {
    "rs_encode": {"BENCH_RS_SHARD": "64", "BENCH_RS_ITERS": "1"},
    "rs_host": {"BENCH_RS_SHARD": "64", "BENCH_RS_ITERS": "1"},
    "rlc_dec": {"BENCH_DEC_GROUPS": "2", "BENCH_DEC_K": "2", "BENCH_ITERS": "1"},
    "rlc_sig": {"BENCH_RLC_GROUPS": "2", "BENCH_RLC_K": "2", "BENCH_ITERS": "1"},
    "share_verify": {"BENCH_BATCH": "2", "BENCH_ITERS": "1"},
    "g2_sign": {"BENCH_SIGN_BATCH": "2", "BENCH_ITERS": "1"},
    "coin_e2e": {"BENCH_COIN_N": "4", "BENCH_COIN_FLIPS": "2"},
    "rlc_dec_adversarial": {"BENCH_ADV_GROUPS": "2", "BENCH_ADV_K": "4",
                            "BENCH_ADV_ITERS": "1"},
    "adv_matrix": {"BENCH_ADVM_GROUPS": "1", "BENCH_ADVM_K": "4", "BENCH_ADVM_ITERS": "1",
                   "BENCH_ADVM_FRACS": "0,0.5"},
    "glv_ladder": {"BENCH_GLV_BATCH": "8", "BENCH_GLV_ITERS": "1"},
    "fused_chain_ab": {"BENCH_FUSED_GROUPS": "2", "BENCH_RLC_K": "2", "BENCH_ITERS": "1"},
    "rs_plane_ab": {"BENCH_RS_PLANE_BLOCK": "64", "BENCH_RS_PLANE_ITERS": "1"},
    "fq_kernel": {"BENCH_FQ_LANES": "8", "BENCH_FQ_CHAIN": "2", "BENCH_FQ_PROBE_SHAPE": "4x8",
                  "BENCH_FQ_PROBE_ITERS": "10"},
    "mesh_scaling": {"BENCH_MESH_SIZES": "1,2", "BENCH_MESH_CHUNKS": "4",
                     "BENCH_MESH_LANES": "16"},
}
#: the card rows' count fields by the reference's definitions
CARD_COUNTS = {
    "rs_encode": {"batch": 64, "gf_dot": None},
    "rs_host": {"batch": 64},
    "rlc_dec": {"batch": 4, "groups": 2},
    "rlc_sig": {"batch": 4, "groups": 2},
    "share_verify": {"batch": 2},
    "g2_sign": {"batch": 2},
    "coin_e2e": {"flips": 2, "chunk": 2, "n": 4, "signs_per_flip": 4, "verifies_per_flip": 4,
                 "combine_width": 2},
    "rlc_dec_adversarial": {"batch": 8, "groups": 2, "contaminated": 1,
                            "contamination_frac": 0.125},
    "adv_matrix": {"batch": 4, "groups": 1},
    # the reference's GLV prediction: 2368 against 3810 products a ladder
    "glv_ladder": {"batch": 8, "field_muls_per_ladder_glv": 2368.0,
                   "field_muls_per_ladder_w2": 3810.0, "table_muls_per_ladder": 268.0},
    "fused_chain_ab": {"batch": 4, "groups": 2, "mode": "plain"},
    "rs_plane_ab": {"batch": 64},
    "fq_kernel": {"impl": "rns", "lanes": "8", "chain": 2, "baseline": "limb arm, same run"},
    "mesh_scaling": {"chunks": 4, "virtual_mesh": True, "all_ok": True, "failed": []},
}
TIER1_CARD_ROWS = {"rs_encode", "rs_host"}


@pytest.mark.parametrize("name", [
    n if n in TIER1_CARD_ROWS else pytest.param(n, marks=pytest.mark.slow) for n in CARD_KNOBS])
def test_card_row_on_the_cpu_request(name, monkeypatch):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    for k, v in CARD_KNOBS[name].items():
        monkeypatch.setenv(k, v)
    row = dict(PORT._plan_benches(None, "cpu", 0.0))[name]()
    for k, v in CARD_COUNTS[name].items():
        assert row[k] == v, (k, row[k], v)
    if name == "adv_matrix":
        assert [c["contamination_frac"] for c in row["curve"]] == [0.0, 0.5]
    if name == "fq_kernel":  # both arms and the chain, timed in this process
        assert [r["kernel"] for r in row["rows"]] == ["fq_rns_mul", "fq_limb_mul",
                                                      "fq_rns_chain"]
        assert row["probe"]["shape"] == [4, 8]
    json.dumps(row)


#: fields a port card row adds to the reference's, by design: the RS row's
#: ``gf_dot`` (null: the kernel has no dot arm to choose), the field row's
#: kernel-bench rows, chain, probe and card (the reference's child prints
#: only its rates), and the port's mesh_probe marking its rate as
#: structural, by path
PORT_ONLY = {
    "rs_encode": {("gf_dot",)},
    "fq_kernel": {("chain_muls_per_sec",), ("card",), ("chain",), ("probe",), ("rows",)},
    "mesh_scaling": {("meshes", "*", "chunks_per_s_is")},
}
#: reference fields the port's row sets otherwise, by design, as
#: {field: {reference value: port value}}: the field row's baseline is the
#: limb arm of the same run, not the reference's TPU limb asymptote; the
#: fused-chain row names the port's kernel path (``cuda`` on the card, the
#: ``plain`` versions on the CPU) where the reference names Pallas's
#: (``native`` on the TPU, ``interpret`` on the CPU)
DEPARTS = {
    "fq_kernel": {"baseline": {"round-2 on-chip limb asymptote": "limb arm, same run"}},
    "fused_chain_ab": {"mode": {"interpret": "plain", "native": "cuda"}},
}


def _extra_paths(port, ref, at=()):
    """The key paths of ``port`` that ``ref`` lacks (list items as ``*``)."""
    if isinstance(port, dict) and isinstance(ref, dict):
        out = set()
        for k, v in port.items():
            out |= {at + (k,)} if k not in ref else _extra_paths(v, ref[k], at + (k,))
        return out
    if isinstance(port, list) and isinstance(ref, list):
        return set().union(*(_extra_paths(p, r, at + ("*",)) for p, r in zip(port, ref)))
    return set()


def _keys_of(port, ref):
    """``port`` cut to the keys that ``ref`` has, at every depth."""
    if isinstance(port, dict) and isinstance(ref, dict):
        return {k: _keys_of(v, ref[k]) for k, v in port.items() if k in ref}
    if isinstance(port, list) and isinstance(ref, list) and len(port) == len(ref):
        return [_keys_of(p, r) for p, r in zip(port, ref)]
    return port


@pytest.mark.parametrize("name", [
    n if n in TIER1_CARD_ROWS else pytest.param(n, marks=pytest.mark.slow) for n in CARD_KNOBS])
def test_card_row_fields_equal_the_reference(name, monkeypatch):
    """Each card row at its tiny shape on the CPU request holds every field
    of the reference's row at the same knobs, with tolerance zero, but the
    wall-clock ones (``timing_free``) and the stated departures
    (``DEPARTS``); it adds only ``PORT_ONLY``.  The reference side compiles
    XLA:CPU graphs (10-50 s a row), so all but the RS rows are slow."""
    for k, v in CARD_KNOBS[name].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    port = dict(PORT._plan_benches(None, "cpu", 0.0))[name]()
    ref = dict(REF._plan_benches(None, "cpu", 0.0))[name]()
    assert _extra_paths(port, ref) == PORT_ONLY.get(name, set())
    for k, to_port in DEPARTS.get(name, {}).items():
        assert to_port[ref.pop(k)] == port.pop(k)
    assert timing_free(_keys_of(port, ref)) == timing_free(ref)


def _bench_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(extra)
    return env


def test_bench_without_the_card_exits_at_once(tmp_path):
    """No card and no CPU request: a non-zero exit within seconds, a
    message naming the missing card, no row."""
    proc = subprocess.run(
        [sys.executable, "-m", "hbbft_tpu_torch.tools.bench"],
        env=_bench_env(CUDA_VISIBLE_DEVICES="", BENCH_ROWS_PATH=str(tmp_path / "rows.json")),
        capture_output=True, text=True, cwd=ROOT, timeout=60,
    )
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr and "--device cpu" in proc.stderr
    assert proc.stdout == "" and not (tmp_path / "rows.json").exists()


def test_a_failing_kernel_is_not_retried(tmp_path, monkeypatch, capsys):
    """A row whose kernel wrapper raises gives the reference's error row
    once, the other rows run, and the bench exits 1."""
    from hbbft_tpu_torch.ops import gf256

    calls = []

    def broken(*args):
        calls.append(args)
        raise RuntimeError("gf256_matmul failed to launch")

    monkeypatch.setattr(gf256, "gf256_matmul", broken)
    for k, v in CARD_KNOBS["rs_encode"].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_ONLY", "rs_encode,rs_host")
    monkeypatch.setenv("BENCH_ROWS_PATH", str(tmp_path / "rows.json"))
    assert PORT.main(["--device", "cpu"]) == 1
    rows = json.loads((tmp_path / "rows.json").read_text())["rows"]
    assert [r["metric"] for r in rows] == ["rs_encode", "rs_encode_host_throughput"]
    assert set(rows[0]) == {"metric", "error"} and "failed to launch" in rows[0]["error"]
    assert len(calls) == 1
    assert rows[1]["platform"] == "cpu" and "error" not in rows[1]
    capsys.readouterr()


def test_backend_names_measure_what_the_reference_measures(monkeypatch):
    """``cpu`` is the pure-Python CpuBackend (the n4_realcrypto anchor),
    ``torch`` the reference's ``tpu`` (TorchBackend on the bench's
    device), ``mock`` the mock; ``tpu`` itself is refused."""
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    assert type(PORT.make_backend("cpu")).__name__ == "CpuBackend"
    assert type(PORT.make_backend("mock")).__name__ == "MockBackend"
    be = PORT.make_backend("torch")
    assert type(be).__name__ == "TorchBackend" and be.device.type == "cpu"
    with pytest.raises(ValueError, match="'torch'"):
        PORT.make_backend("tpu")
    monkeypatch.setenv("BENCH_DEVICE", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.make_backend("torch")


def test_n100_cuda_skips_the_era_change_it_cannot_fit(monkeypatch):
    """At the card's figures one N=100 era change outlasts a 3000 s
    budget, so the churn row is skipped with its label before it starts;
    without churn its epochs fit."""
    fit, label = PORT._n100_cuda_fit(3000.0, 0.0)
    assert fit == 0 and "budget exhausted" in label and "era change" in label
    monkeypatch.setenv("BENCH_N100_CUDA_CHURN", "0")
    fit, label = PORT._n100_cuda_fit(3000.0, 0.0)
    assert label is None and fit == int(3000 * 0.7 / PORT.N100_CUDA_EPOCH_EST)


@pytest.mark.parametrize("fields", [
    {"all_ok": False, "failed_cells": []},
    {"all_ok": True, "failed_cells": [{"cell": "x"}]},
    {"all_ok": True, "failed": [{"devices": 2, "error": "exit 1"}]},
    {"killswitch_identical": False},
])
def test_a_row_reporting_a_failure_counts_as_an_error(fields):
    """Each way a row reports a failure in its own fields counts; the same
    fields reporting none do not."""
    assert PORT._row_failed({"metric": "m", **fields})
    assert not PORT._row_failed({"metric": "m", "all_ok": True, "failed": [],
                                 "failed_cells": [], "killswitch_identical": True})


def test_a_failed_cell_fails_the_bench(tmp_path, monkeypatch, capsys):
    """A scenario cell that fails (planted in the matrix's results) leaves
    the row as the reference writes it, and the bench exits 1."""
    from hbbft_tpu_torch.net import scenarios

    real = scenarios.run_matrix

    def planted(**kwargs):
        results = real(**kwargs)
        results[0].ok, results[0].error = False, "planted"
        return results

    monkeypatch.setattr(scenarios, "run_matrix", planted)
    monkeypatch.setenv("BENCH_SCEN_NS", "4")
    monkeypatch.setenv("BENCH_SCEN_SCHEDULES", "uniform")
    monkeypatch.setenv("BENCH_ONLY", "scenario_matrix")
    monkeypatch.setenv("BENCH_ROWS_PATH", str(tmp_path / "rows.json"))
    assert PORT.main(["--device", "cpu"]) == 1
    (row,) = json.loads((tmp_path / "rows.json").read_text())["rows"]
    assert "error" not in row and row["all_ok"] is False and row["cells_ok"] == row["cells"] - 1
    assert [c["error"] for c in row["failed_cells"]] == ["planted"]
    capsys.readouterr()
