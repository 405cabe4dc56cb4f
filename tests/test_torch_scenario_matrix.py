"""The port's scenario-matrix CLI (``hbbft_tpu_torch/tools/scenario_matrix``)
against the JAX package's ``tools/scenario_matrix.py``: on the mock the
JSON rows are equal, and without ``--backend`` it runs on the card."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from hbbft_tpu_torch.tools import scenario_matrix as PORT

ROOT = Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location(
        "scenario_matrix_reference", ROOT / "tools" / "scenario_matrix.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_json_rows_equal_the_reference(tmp_path, capsys):
    args = ["--ns", "4", "--schedules", "uniform"]
    assert _reference().main(args + ["--json", str(tmp_path / "ref.json")]) == 0
    ref_out = capsys.readouterr().out
    assert PORT.main(args + ["--backend", "mock", "--json", str(tmp_path / "port.json")]) == 0
    port_out = capsys.readouterr().out
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == ref and len(port["rows"]) > 1
    # the same table, but for the file names
    assert port_out.replace("port.json", "ref.json") == ref_out


def test_scenario_matrix_cli_defaults_to_the_card(capsys):
    """``--backend`` is ``torch``, the card, unless asked: on a machine
    without one the CLI raises instead of running on the CPU."""
    argv = ["--ns", "4", "--attacks", "passive", "--schedules", "uniform"]
    if torch.cuda.is_available():
        assert type(PORT.make_backend("torch")).__name__ == "TorchBackend"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.main(argv)
    capsys.readouterr()
