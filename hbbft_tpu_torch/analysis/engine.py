"""AST lint engine: findings, suppressions, baseline, rule registry.

Pure stdlib (``ast`` + ``re`` + ``json``) — the linter never imports the
code under analysis, so a full run costs parse time only (<10s on CPU; no
``torch`` import) and cannot be affected by import-time side effects.

Suppression syntax (same line as the finding, or a comment-only line
immediately above it)::

    self._counts[k] += 1  # lint: allow[determinism] counting is commutative

A suppression must carry a reason; a bare ``# lint: allow[rule]`` is not
honoured and is itself reported (rule id ``lint-allow``).

The baseline file grandfathers known findings: each entry is the multiset
key ``(rule, path, message)`` with a count, so moving a grandfathered
finding within its file does not trip CI but adding a new instance does.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(r"#\s*lint:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(.*)")

#: rule id used for meta-findings about malformed suppressions
ALLOW_RULE_ID = "lint-allow"
#: rule id for suppressions that no longer suppress anything
STALE_RULE_ID = "stale-suppression"


@dataclass(frozen=True, slots=True)
class Finding:
    """One lint finding, anchored to a source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str

    def sort_key(self) -> Tuple:
        return (self.path, self.line, self.col, self.rule, self.message)

    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class ModuleSource:
    """One parsed module: source text, AST, and suppression table."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        #: line -> set of rule ids allowed on that line ("*" = all)
        self.allowed: Dict[int, set] = {}
        #: (line, rule-list) of suppressions missing a reason
        self.bare_allows: List[Tuple[int, str]] = []
        #: honoured allow comments: (comment line, target line, rules) —
        #: the stale-suppression pass checks each actually fired
        self.allow_sites: List[Tuple[int, int, frozenset]] = []
        self._scan_suppressions()

    def _scan_suppressions(self) -> None:
        # Real COMMENT tokens only (tokenize): allow-syntax quoted inside a
        # docstring or string literal must not create phantom suppressions.
        if "allow[" not in self.text:
            return  # fast path: tokenizing dominates project load time
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return  # surfaced separately as a syntax finding
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            line = tok.start[0]
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = m.group(2).strip()
            if not reason:
                self.bare_allows.append((line, ",".join(sorted(rules))))
                continue  # not honoured without a reason
            target = line
            code = self.lines[line - 1][: tok.start[1]].strip()
            if not code:
                # Comment-only line: applies to the next SOURCE line —
                # skipping CONTINUATION COMMENT lines only, so a
                # multi-line justification comment still binds to the
                # code it precedes.  A blank line ends the binding (the
                # allow then suppresses nothing and is reported stale)
                # — skipping blanks would let a dead allow silently
                # capture the next code block.
                target = line + 1
                while target <= len(self.lines):
                    nxt = self.lines[target - 1].strip()
                    if not nxt.startswith("#"):
                        break
                    target += 1
            self.allowed.setdefault(target, set()).update(rules)
            self.allow_sites.append((line, target, frozenset(rules)))

    def is_suppressed(self, rule: str, line: int) -> bool:
        # (no wildcard form: SUPPRESS_RE only admits rule-id characters,
        # so every suppression names the rules it blankets)
        rules = self.allowed.get(line)
        return rules is not None and rule in rules


class LintProject:
    """All modules under analysis, keyed by repo-relative posix path."""

    def __init__(self, repo_root: Path, modules: Dict[str, ModuleSource]) -> None:
        self.repo_root = repo_root
        self.modules = modules

    @staticmethod
    def load(repo_root: Path, paths: Iterable[Path]) -> "LintProject":
        modules: Dict[str, ModuleSource] = {}
        for p in sorted(paths):
            rel = p.resolve().relative_to(repo_root.resolve()).as_posix()
            text = p.read_text(encoding="utf-8")
            try:
                modules[rel] = ModuleSource(rel, text)
            except SyntaxError as e:
                # Surfaced as a finding rather than crashing the run.
                broken = ModuleSource.__new__(ModuleSource)
                broken.path = rel
                broken.text = text
                broken.lines = text.splitlines()
                broken.tree = ast.Module(body=[], type_ignores=[])
                broken.allowed = {}
                broken.bare_allows = []
                broken.allow_sites = []
                broken.syntax_error = e  # type: ignore[attr-defined]
                modules[rel] = broken
        return LintProject(repo_root, modules)

    def module(self, path: str) -> Optional[ModuleSource]:
        return self.modules.get(path)


class Rule:
    """Base class: subclasses set ``rule_id``/``scope`` and override one of
    ``check_module`` (per-file) or ``check_project`` (cross-file)."""

    rule_id: str = ""
    #: path prefixes this rule applies to (posix, repo-relative)
    scope: Tuple[str, ...] = ()

    def applies_to(self, path: str) -> bool:
        return not self.scope or any(path.startswith(pfx) for pfx in self.scope)

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        return []

    def check_project(self, project: LintProject) -> List[Finding]:
        out: List[Finding] = []
        for path in sorted(project.modules):
            if self.applies_to(path):
                out.extend(self.check_module(project.modules[path]))
        return out


_REGISTRY: Dict[str, Callable[[], Rule]] = {}


def register(rule_cls):
    """Class decorator adding a rule to the global registry."""
    if not rule_cls.rule_id:
        raise ValueError(f"{rule_cls.__name__} has no rule_id")
    if rule_cls.rule_id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule_cls.rule_id!r}")
    _REGISTRY[rule_cls.rule_id] = rule_cls
    return rule_cls


def all_rules() -> List[Rule]:
    """Instantiate every registered rule (importing the rule modules)."""
    # Imports are deferred so `engine` has no circular dependency on rules.
    from hbbft_tpu_torch.analysis import (  # noqa: F401
        rules_byzantine,
        rules_determinism,
        rules_exhaustiveness,
        rules_seam,
        rules_snapshot,
        rules_tracer,
    )

    return [_REGISTRY[rid]() for rid in sorted(_REGISTRY)]


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


class Baseline:
    """Multiset of grandfathered findings keyed by (rule, path, message)."""

    def __init__(self, counts: Optional[Dict[Tuple[str, str, str], int]] = None) -> None:
        self.counts: Dict[Tuple[str, str, str], int] = dict(counts or {})

    @staticmethod
    def from_findings(findings: Iterable[Finding]) -> "Baseline":
        b = Baseline()
        for f in findings:
            k = f.baseline_key()
            b.counts[k] = b.counts.get(k, 0) + 1
        return b

    @staticmethod
    def load(path: Path) -> "Baseline":
        if not path.exists():
            return Baseline()
        data = json.loads(path.read_text(encoding="utf-8"))
        counts: Dict[Tuple[str, str, str], int] = {}
        for entry in data.get("findings", []):
            key = (entry["rule"], entry["path"], entry["message"])
            counts[key] = int(entry.get("count", 1))
        return Baseline(counts)

    def save(self, path: Path) -> None:
        entries = [
            {"rule": rule, "path": p, "message": msg, "count": n}
            for (rule, p, msg), n in sorted(self.counts.items())
        ]
        path.write_text(
            json.dumps({"version": 1, "findings": entries}, indent=2) + "\n",
            encoding="utf-8",
        )

    def new_findings(self, findings: Sequence[Finding]) -> List[Finding]:
        """Findings beyond the grandfathered counts (deterministic: for each
        key the *first* ``count`` occurrences in sorted order are absorbed)."""
        remaining = dict(self.counts)
        out: List[Finding] = []
        for f in sorted(findings, key=Finding.sort_key):
            k = f.baseline_key()
            if remaining.get(k, 0) > 0:
                remaining[k] -= 1
            else:
                out.append(f)
        return out


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def iter_python_files(root: Path) -> List[Path]:
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


def run_lint(
    repo_root: Path,
    paths: Optional[Iterable[Path]] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Run ``rules`` over ``paths`` (default: all of hbbft_tpu_torch/).

    Returns unsuppressed findings in deterministic sorted order.
    Suppressions without a reason surface as ``lint-allow`` findings.
    """
    if paths is None:
        paths = iter_python_files(repo_root / "hbbft_tpu_torch")
    project = LintProject.load(repo_root, paths)
    full_rule_set = rules is None
    if full_rule_set:
        rules = all_rules()

    findings: List[Finding] = []
    for path, mod in project.modules.items():
        err = getattr(mod, "syntax_error", None)
        if err is not None:
            findings.append(
                Finding("syntax", path, err.lineno or 1, 0, f"syntax error: {err.msg}")
            )
        for line, rules_txt in mod.bare_allows:
            findings.append(
                Finding(
                    ALLOW_RULE_ID,
                    path,
                    line,
                    0,
                    f"suppression allow[{rules_txt}] has no reason; not honoured",
                )
            )
    #: (path, line, rule) triples where a suppression actually fired —
    #: rule-keyed so a dead allow cannot hide behind a DIFFERENT rule's
    #: live allow on the same line
    used_allows: set = set()
    for rule in rules:
        for f in rule.check_project(project):
            mod = project.module(f.path)
            if mod is not None and mod.is_suppressed(f.rule, f.line):
                used_allows.add((f.path, f.line, f.rule))
                continue
            findings.append(f)
    # Stale suppressions: an honoured allow comment that suppressed
    # nothing in this run is itself a finding — dead suppressions
    # otherwise silently blanket future findings on their line.  Only
    # meaningful when the full rule set ran (a subset run can't tell
    # dead from not-exercised).  (A partial FILE run — --diff or an
    # explicit list — can still transiently report one when the matching
    # finding needs cross-file context; the gate and --baseline always
    # run the full set.)
    if not full_rule_set:
        return sorted(findings, key=Finding.sort_key)
    def _fired(path: str, target: int, rules_txt: frozenset) -> bool:
        return any((path, target, r) in used_allows for r in rules_txt)

    #: candidates: allow sites that suppressed nothing
    stale = [
        (path, mod, comment_line, target, rules_txt)
        for path, mod in project.modules.items()
        for comment_line, target, rules_txt in mod.allow_sites
        if not _fired(path, target, rules_txt)
    ]
    #: (path, target) -> allow[stale-suppression] site lines binding there
    stale_sites: Dict[Tuple[str, int], List[int]] = {}
    for path, _mod, comment_line, target, rules_txt in stale:
        if STALE_RULE_ID in rules_txt:
            stale_sites.setdefault((path, target), []).append(comment_line)
    #: candidates whose stale finding is deliberately allowed, and the
    #: escape-hatch sites that did the allowing (those are live, not
    #: stale themselves — the hatch must converge)
    suppressed: set = set()
    protectors: set = set()
    for path, mod, comment_line, target, rules_txt in stale:
        if STALE_RULE_ID in rules_txt:
            continue
        if mod.is_suppressed(STALE_RULE_ID, comment_line):
            # inline dead allow: the hatch binds to its code line
            suppressed.add((path, comment_line))
            for s in stale_sites.get((path, comment_line), ()):
                protectors.add((path, s))
            continue
        # comment-only dead allow: the hatch comment above it skips the
        # dead comment line and binds to the SAME code line — treat a
        # co-targeting allow[stale-suppression] as this allow's hatch
        others = [
            s
            for s in stale_sites.get((path, target), ())
            if s != comment_line
        ]
        if others:
            suppressed.add((path, comment_line))
            protectors.update((path, s) for s in others)
    for path, mod, comment_line, target, rules_txt in stale:
        if (path, comment_line) in suppressed:
            continue  # its stale finding is deliberately allowed
        if STALE_RULE_ID in rules_txt and (path, comment_line) in protectors:
            continue  # this hatch silenced a kept dead allow: live
        findings.append(
            Finding(
                STALE_RULE_ID,
                path,
                comment_line,
                0,
                f"suppression allow[{','.join(sorted(rules_txt))}] "
                "matches no finding; remove it",
            )
        )
    return sorted(findings, key=Finding.sort_key)
