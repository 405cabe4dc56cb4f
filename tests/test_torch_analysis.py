"""The port's lint rule engine (``hbbft_tpu_torch/analysis/``: the engine,
the determinism, exhaustiveness, byzantine, tracer, snapshot and seam
rules, the state inventory) and its CLI (``python -m
hbbft_tpu_torch.tools.lint``) against the JAX package's.

Every case of the reference's ``tests/test_lint.py`` and
``tests/test_stateinv.py`` runs in both packages through
:mod:`torch_twin`, with the ``hbbft_tpu/`` path scopes, the package
directory, the lint CLI's module path and its baseline pointed at the
port.  The reference test's own checks hold in each, and the two runs'
findings (each ``lint_sources`` and ``run_lint`` call), state inventories
(``inventory_module``) and JSON documents (``findings_document``) are
equal call for call once the package name is taken out: the work is pure
AST, so the tolerance is zero.  The cases that lint the whole trees run
in ``test_torch_lint_gate.py`` (``TREE``), which keeps each file's share
of the suite's time small.

The cases below them pin what only the port has: the rules know torch's
spellings of a host sync (flagged in scope, not out of it, honoured with
a reason, reported without one).
"""

import textwrap
from pathlib import Path

import pytest

from torch_twin import TwinModule, twin

REPO_ROOT = Path(__file__).resolve().parent.parent

#: the calls whose results the analysis twins hold equal
RECORDED = (
    (None, None, "lint_sources"),
    ("analysis.engine", None, "run_lint"),
    ("analysis.stateinv", None, "inventory_module"),
    ({"hbbft_tpu": "tools.lint", "hbbft_tpu_torch": "hbbft_tpu_torch.tools.lint"},
     None, "findings_document"),
)

#: the lint tests' paths and CLI, pointed at the port
PORT_SUBS = [
    ("hbbft_tpu/", "hbbft_tpu_torch/"),
    ('/ "hbbft_tpu"', '/ "hbbft_tpu_torch"'),
]
LINT_SUBS = PORT_SUBS + [
    ('REPO_ROOT / "tools" / "lint_baseline.json"',
     'REPO_ROOT / "hbbft_tpu_torch" / "tools" / "lint_baseline.json"'),
    ('"tools/lint.py"', '"-m", "hbbft_tpu_torch.tools.lint"'),
    ("from tools.lint import", "from hbbft_tpu_torch.tools.lint import"),
]

LINT = TwinModule("test_lint.py", port_subs=LINT_SUBS, recorded=RECORDED)
STATEINV = TwinModule("test_stateinv.py", port_subs=PORT_SUBS, recorded=RECORDED)

#: the cases that lint or inventory the whole trees (each a full run per
#: package): they run in test_torch_lint_gate.py
TREE = {
    "test_package_lint_clean",
    "test_lint_output_deterministic",
    "test_deferred_fetch_real_dispatch_layer_is_clean",
    "test_baseline_rewrite_prunes_vanished_entries",
    "test_lint_json_output_schema_pinned",
    "test_real_registry_classes_inventory_clean",
}


def cases(module: TwinModule, tree: bool):
    names = [n for n in vars(module.copies["hbbft_tpu"])
             if n.startswith("test_") and (n in TREE) == tree]
    return [p for n in names for p in module.params(n)]


@pytest.mark.parametrize("name,kwargs", cases(LINT, tree=False))
def test_lint_port_equals_the_reference(name, kwargs, tmp_path):
    twin(LINT, name, kwargs, tmp_path)


@pytest.mark.parametrize("name,kwargs", cases(STATEINV, tree=False))
def test_stateinv_port_equals_the_reference(name, kwargs, tmp_path):
    twin(STATEINV, name, kwargs, tmp_path)


# ---------------------------------------------------------------------------
# torch's spellings of a host sync
# ---------------------------------------------------------------------------

from hbbft_tpu_torch.analysis.engine import LintProject, ModuleSource, run_lint  # noqa: E402
from hbbft_tpu_torch.analysis.rules_tracer import (  # noqa: E402
    DeferredFetchRule,
    TracerSafetyRule,
)

#: (spelling as written, spelling as reported)
SPELLINGS = [
    ("t.cpu()", ".cpu()"),
    ("t.numpy()", ".numpy()"),
    ("t.item()", ".item()"),
    ("t.tolist()", ".tolist()"),
    ('t.to("cpu")', '.to("cpu")'),
    ('t.to(device="cpu")', '.to("cpu")'),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("stream.synchronize()", ".synchronize()"),
    ("t.cpu().numpy()", ".cpu().numpy()"),
]
SPELLING_IDS = [w for w, _ in SPELLINGS]


def _lint(rule, path, src):
    mod = ModuleSource(path, textwrap.dedent(src))
    project = LintProject(REPO_ROOT, {path: mod})
    return [f for f in rule.check_project(project) if not mod.is_suppressed(f.rule, f.line)]


def _fetch_src(expr, comment=""):
    return f"""\
    import torch

    def fetch(t, stream):
        out = {expr}{comment}
        return out
    """


def _loop_src(expr, comment=""):
    return f"""\
    import torch

    def fetch(ts, stream):
        out = []
        for t in ts:
            out.append({expr}){comment}
        return out
    """


@pytest.mark.parametrize("written,reported", SPELLINGS, ids=SPELLING_IDS)
def test_deferred_fetch_flags_torch_spelling_in_scope(written, reported):
    for path in ("hbbft_tpu_torch/ops/backend.py", "hbbft_tpu_torch/engine/_x.py",
                 "hbbft_tpu_torch/ops/gf256.py"):
        (f,) = _lint(DeferredFetchRule(), path, _fetch_src(written))
        assert (f.rule, f.line) == ("deferred-fetch", 4)
        assert f.message.startswith(f"{reported} in the dispatch layer"), f.message
        assert "deferred-fetch seam" in f.message


@pytest.mark.parametrize("written,reported", SPELLINGS, ids=SPELLING_IDS)
def test_deferred_fetch_ignores_torch_spelling_out_of_scope(written, reported):
    for path in ("hbbft_tpu_torch/ops/pipeline.py", "hbbft_tpu_torch/ops/curve.py",
                 "hbbft_tpu_torch/protocols/_x.py"):
        assert _lint(DeferredFetchRule(), path, _fetch_src(written)) == []


@pytest.mark.parametrize("written,reported", SPELLINGS, ids=SPELLING_IDS)
def test_tracer_safety_flags_torch_spelling_in_a_loop(written, reported):
    for path in ("hbbft_tpu_torch/ops/_x.py", "hbbft_tpu_torch/engine/_x.py",
                 "hbbft_tpu_torch/obs/critpath.py"):
        (f,) = _lint(TracerSafetyRule(), path, _loop_src(written))
        assert (f.rule, f.line) == ("tracer-safety", 6)
        assert f.message == f"{reported} inside a loop; batch the transfer"
        # outside a loop the same call is not a per-iteration sync
        assert _lint(TracerSafetyRule(), path, _fetch_src(written)) == []
    # out of scope (the protocols are host code)
    assert _lint(TracerSafetyRule(), "hbbft_tpu_torch/protocols/_x.py", _loop_src(written)) == []


@pytest.mark.parametrize("written,reported", SPELLINGS, ids=SPELLING_IDS)
def test_torch_spelling_suppression_needs_a_reason(written, reported, tmp_path):
    """An allow with a reason silences the finding; a bare allow is
    reported as ``lint-allow`` and does not."""
    sites = {
        "hbbft_tpu_torch/ops/backend.py": ("deferred-fetch", _fetch_src, 4),
        "hbbft_tpu_torch/ops/_loop.py": ("tracer-safety", _loop_src, 6),
    }
    for rel, (rule, make, line) in sites.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(make(written, f"  # lint: allow[{rule}] host-only value")))
        assert run_lint(tmp_path, [p]) == []
        p.write_text(textwrap.dedent(make(written, f"  # lint: allow[{rule}]")))
        got = {(f.rule, f.line) for f in run_lint(tmp_path, [p])}
        assert (rule, line) in got and ("lint-allow", line) in got, got


def test_jitted_body_flags_torch_spelling():
    """A jitted body's host sync is flagged in either package's spelling."""
    src = """\
    import jax

    @jax.jit
    def kernel(x):
        y = x.cpu().numpy()
        torch.cuda.synchronize()
        return y
    """
    msgs = sorted(f.message for f in _lint(TracerSafetyRule(), "hbbft_tpu_torch/ops/_x.py", src))
    assert msgs == [
        ".cpu().numpy() inside jitted kernel() is a host sync",
        "torch.cuda.synchronize() inside jitted kernel() is a host sync",
    ]


def test_device_moves_are_not_host_syncs():
    """``.to("cuda")``, ``.cuda()``, ``np.array`` staging and a method
    named ``numpy`` that takes an argument stay clean."""
    src = """\
    import numpy as np

    def stage(t, rows):
        a = t.to("cuda")
        b = t.to(torch.device("cuda"), non_blocking=True)
        c = t.cuda()
        d = np.array([1, 2, 3])
        e = rows.numpy(0)
        return a, b, c, d, e
    """
    assert _lint(DeferredFetchRule(), "hbbft_tpu_torch/ops/backend.py", src) == []
