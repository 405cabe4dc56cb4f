"""Protocol-invariant linter CLI (hbbft_tpu_torch/analysis rule engine).

Usage::

    python -m hbbft_tpu_torch.tools.lint            # full run over hbbft_tpu_torch/
    python -m hbbft_tpu_torch.tools.lint --diff     # only files changed vs git HEAD
    python -m hbbft_tpu_torch.tools.lint --baseline # rewrite the grandfathered baseline
    python -m hbbft_tpu_torch.tools.lint --ci       # ruff (if installed) + custom rules
    python -m hbbft_tpu_torch.tools.lint --json OUT # machine-readable findings ("-": stdout)
    python -m hbbft_tpu_torch.tools.lint a.py ...   # explicit file list

Exit status is non-zero iff there are findings beyond the checked-in
baseline (``hbbft_tpu_torch/tools/lint_baseline.json``).  Output is deterministically
sorted by (path, line, col, rule, message).

Suppression syntax (must carry a reason)::

    x = f(s)  # lint: allow[determinism] ordering provably irrelevant: <why>

The linter never imports the code under analysis — a full run is pure AST
work and finishes in seconds on CPU (``torch`` is never imported).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

from hbbft_tpu_torch.analysis.engine import (
    Baseline,
    Finding,
    iter_python_files,
    run_lint,
)

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
BASELINE_PATH = REPO_ROOT / "hbbft_tpu_torch" / "tools" / "lint_baseline.json"

#: schema identifier pinned by the lint tests — bump only with a
#: matching consumer update (CI scripts parse this, not the human text)
JSON_SCHEMA = "hbbft-tpu-lint/1"


def findings_document(new, grandfathered: int) -> dict:
    """Machine-readable findings: stable sort, schema-pinned shape."""
    return {
        "schema": JSON_SCHEMA,
        "new": [
            {
                "rule": f.rule,
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
            }
            for f in sorted(new, key=Finding.sort_key)
        ],
        "grandfathered": grandfathered,
    }


def _git_changed_files() -> list:
    """Changed + untracked .py files under hbbft_tpu_torch/ (repo-relative)."""
    out = subprocess.run(
        ["git", "status", "--porcelain", "--untracked-files=all"],
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    paths = []
    for line in out.splitlines():
        rel = line[3:].split(" -> ")[-1].strip().strip('"')
        p = REPO_ROOT / rel
        if rel.endswith(".py") and rel.startswith("hbbft_tpu_torch/") and p.exists():
            paths.append(p)
    return sorted(set(paths))


def _run_ruff() -> int:
    """Run ruff if the binary is available; 0 when absent (gated dep)."""
    ruff = shutil.which("ruff")
    if ruff is None:
        print("lint: ruff not installed; skipping ruff pass", file=sys.stderr)
        return 0
    proc = subprocess.run(
        [ruff, "check", "hbbft_tpu_torch", "tests"], cwd=REPO_ROOT
    )
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*", help="explicit files (default: hbbft_tpu_torch/)")
    ap.add_argument(
        "--diff", action="store_true", help="lint only files changed vs git"
    )
    ap.add_argument(
        "--baseline",
        action="store_true",
        help="rewrite hbbft_tpu_torch/tools/lint_baseline.json from the current full run",
    )
    ap.add_argument(
        "--baseline-file",
        type=Path,
        default=BASELINE_PATH,
        help="baseline location (default hbbft_tpu_torch/tools/lint_baseline.json)",
    )
    ap.add_argument(
        "--ci",
        action="store_true",
        help="also run ruff (if installed); exit codes are merged",
    )
    ap.add_argument(
        "--json",
        metavar="OUT",
        default=None,
        help="write machine-readable findings (schema "
        f"{JSON_SCHEMA!r}) to OUT; '-' writes JSON to stdout and moves "
        "the human summary to stderr",
    )
    args = ap.parse_args(argv)

    if args.files:
        paths = [Path(f).resolve() for f in args.files]
    elif args.diff:
        paths = _git_changed_files()
        if not paths:
            print("lint: no changed files under hbbft_tpu_torch/")
            return _run_ruff() if args.ci else 0
    else:
        paths = iter_python_files(REPO_ROOT / "hbbft_tpu_torch")

    findings = run_lint(REPO_ROOT, paths)

    if args.baseline:
        if args.diff or args.files:
            print("lint: --baseline requires a full run", file=sys.stderr)
            return 2
        old = Baseline.load(args.baseline_file)
        new_baseline = Baseline.from_findings(findings)
        # prune report: grandfathered entries whose findings no longer
        # occur (fixed code keeps the baseline honest automatically)
        pruned = sum(
            max(0, n - new_baseline.counts.get(key, 0))
            for key, n in old.counts.items()
        )
        added = sum(
            max(0, n - old.counts.get(key, 0))
            for key, n in new_baseline.counts.items()
        )
        new_baseline.save(args.baseline_file)
        print(
            f"lint: baseline rewritten with {len(findings)} grandfathered "
            f"finding(s) -> {args.baseline_file} "
            f"({pruned} pruned, {added} added)"
        )
        return 0

    baseline = Baseline.load(args.baseline_file)
    new = baseline.new_findings(findings)
    grandfathered = len(findings) - len(new)

    human_out = sys.stdout
    if args.json is not None:
        doc = json.dumps(findings_document(new, grandfathered), indent=2)
        if args.json == "-":
            print(doc)
            human_out = sys.stderr
        else:
            Path(args.json).write_text(doc + "\n", encoding="utf-8")

    for f in new:
        print(f.render(), file=human_out)
    summary = f"lint: {len(new)} new finding(s)"
    if grandfathered:
        summary += f", {grandfathered} grandfathered"
    print(summary, file=human_out)

    rc = 1 if new else 0
    if args.ci:
        rc = max(rc, _run_ruff())
    return rc


if __name__ == "__main__":
    sys.exit(main())
