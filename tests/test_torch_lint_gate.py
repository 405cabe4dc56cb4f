"""The lint cases of the JAX package that run over the whole trees, in
both packages (the rest are in ``test_torch_analysis.py``), and the
gate over the port.

Each of these cases makes full lint runs, so a case costs a few seconds
a package.  The reference's full-run cases (the gate over the package,
the order-independent output, the clean dispatch layer, the baseline
rewrite and the ``--json`` document through the CLI) run through
:mod:`torch_twin` as in ``test_torch_analysis.py``: both trees clean,
every recorded call equal.  The inventory of every real
``_STATE_MODULES`` class runs in each package on its own, with no
record: the two packages' modules differ in layout, so their
inventories' lines do too.  Then the port's own gate: its baseline is
empty and the lint CLI runs without importing ``torch`` (or JAX).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_analysis import LINT, STATEINV, cases
from torch_twin import twin

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name,kwargs", cases(LINT, tree=True))
def test_lint_port_equals_the_reference_over_the_trees(name, kwargs, tmp_path):
    twin(LINT, name, kwargs, tmp_path)


@pytest.mark.parametrize("name,kwargs", cases(STATEINV, tree=True))
@pytest.mark.parametrize("root", ["hbbft_tpu", "hbbft_tpu_torch"])
def test_stateinv_real_registry_in_each_package(root, name, kwargs):
    getattr(STATEINV.copies[root], name)(**kwargs)


def test_port_lint_gate_empty_baseline_and_no_torch():
    """The port's baseline holds no finding, and its lint CLI imports
    neither ``torch`` nor JAX (it is pure AST work)."""
    base = json.loads((REPO_ROOT / "hbbft_tpu_torch/tools/lint_baseline.json").read_text())
    assert base == {"version": 1, "findings": []}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from hbbft_tpu_torch.tools import lint; "
         "rc = lint.main(['hbbft_tpu_torch/parallel/__init__.py']); "
         "print('torch' in sys.modules, 'jax' in sys.modules); sys.exit(rc)"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines() == ["lint: 0 new finding(s)", "False False"]
