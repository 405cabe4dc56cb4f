"""Determinism rule: protocol state machines must be replay-identical.

Scope: ``hbbft_tpu_torch/protocols/`` and ``hbbft_tpu_torch/core/`` — the sans-I/O
state machines whose transitions must be byte-identical on every correct
replica (CCS 2016 safety argument; core/protocol.py docstring contract).

Forbidden:

* ``import time`` / ``from time import ...`` and any ``time.*`` use —
  wall-clock reads fork replicas.
* ``import random`` / ``from random import ...`` — ambient module-level
  randomness.  Explicit ``rng`` parameters threaded by the embedder are
  fine (and are the codebase convention).
* ``os.urandom(...)`` — ambient entropy.
* ``id(...)`` — CPython object addresses; any ordering or keying derived
  from them differs across replicas.
* iteration over ``set``-typed values or ``dict.values()``/``.items()``
  without a ``sorted(...)`` wrapper, unless the iteration feeds a
  commutative reducer (``sum``/``any``/``all``/``min``/``max``/``len``)
  or rebuilds an unordered container (``set``/``frozenset``/``dict`` and
  their comprehensions).  Python dicts iterate in *insertion* order, and
  on message paths insertion order is message-arrival order — which an
  asynchronous network does not replicate across nodes.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from hbbft_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, register

#: callables whose result does not depend on argument iteration order
_COMMUTATIVE_SINKS = {"sum", "any", "all", "min", "max", "len", "set", "frozenset", "dict", "sorted"}

_BANNED_MODULE_IMPORTS = {"time", "random"}


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _is_sorted_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node) == "sorted"


def _is_values_or_items(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in ("values", "items")
        and not node.args
        and not node.keywords
    )


class _SetTypeTracker(ast.NodeVisitor):
    """Collect names/attributes statically known to hold built-in sets.

    Tracked: ``x = set()`` / set literals / set comprehensions /
    annotations ``x: set`` / ``x: Set[...]`` — on locals and on ``self``
    attributes anywhere in the module.
    """

    def __init__(self) -> None:
        self.set_names: Set[str] = set()  # bare locals and "self.attr" keys

    @staticmethod
    def _target_key(target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Name):
            return target.id
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            return f"self.{target.attr}"
        return None

    @staticmethod
    def _is_set_expr(value: Optional[ast.AST]) -> bool:
        if value is None:
            return False
        if isinstance(value, (ast.Set, ast.SetComp)):
            return True
        if isinstance(value, ast.Call) and _call_name(value) in ("set", "frozenset"):
            return True
        return False

    @staticmethod
    def _is_set_annotation(ann: Optional[ast.AST]) -> bool:
        if ann is None:
            return False
        base = ann.value if isinstance(ann, ast.Subscript) else ann
        if isinstance(base, ast.Name):
            return base.id in ("set", "frozenset", "Set", "FrozenSet")
        if isinstance(base, ast.Attribute):
            return base.attr in ("Set", "FrozenSet")
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._is_set_expr(node.value):
            for t in node.targets:
                key = self._target_key(t)
                if key:
                    self.set_names.add(key)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if self._is_set_annotation(node.annotation) or self._is_set_expr(node.value):
            key = self._target_key(node.target)
            if key:
                self.set_names.add(key)
        self.generic_visit(node)


@register
class DeterminismRule(Rule):
    rule_id = "determinism"
    # The adversary/scenario harness is in scope (seeded-replay contract:
    # same seed ⇒ identical fault log and batch digests, so attacks and
    # schedules must draw entropy only from net.rng); the VirtualNet
    # runtime itself is not (it OWNS the seeded rng and legitimately
    # reads wall time for tracer spans).  The traffic subsystem is in
    # scope with the same contract: generators, mempools, and drivers
    # draw entropy only from the injected rng and never read wall clocks
    # (same seed ⇒ identical arrival schedule, sampled proposals,
    # Batches, and latency histograms — wall-rate timing belongs to the
    # CALLER, bench.py).  The control plane (hbbft_tpu_torch/control/) rides
    # the same contract: batch-size decisions are a pure function of
    # observed virtual-time state + the injected rng, so a seeded
    # replay reproduces the exact B trace (and the kill-switch A/B
    # stays bit-identical).
    # The critpath/timeseries/flight observability trio rides
    # the same contract: stamps carry caller-provided crank/virtual-time
    # context, series rows and forensics bundles are pure functions of
    # the recorded evidence (seeded replay ⇒ bit-identical artifacts).
    # tracer.py and health.py stay OUT of scope — they legitimately read
    # wall clocks (spans, heartbeats).
    scope = (
        "hbbft_tpu_torch/protocols/",
        "hbbft_tpu_torch/core/",
        "hbbft_tpu_torch/net/adversary.py",
        "hbbft_tpu_torch/net/scenarios.py",
        "hbbft_tpu_torch/net/crash.py",
        "hbbft_tpu_torch/traffic/",
        "hbbft_tpu_torch/control/",
        "hbbft_tpu_torch/obs/critpath.py",
        "hbbft_tpu_torch/obs/timeseries.py",
        "hbbft_tpu_torch/obs/flight.py",
    )

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        tracker = _SetTypeTracker()
        tracker.visit(mod.tree)

        def emit(node: ast.AST, message: str) -> None:
            findings.append(
                Finding(
                    self.rule_id,
                    mod.path,
                    getattr(node, "lineno", 1),
                    getattr(node, "col_offset", 0),
                    message,
                )
            )

        def expr_key(node: ast.AST) -> Optional[str]:
            if isinstance(node, ast.Name):
                return node.id
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return f"self.{node.attr}"
            return None

        def iter_expr_nondeterministic(it: ast.AST) -> Optional[str]:
            """Why iterating ``it`` is order-nondeterministic, or None."""
            if _is_sorted_call(it):
                return None
            if _is_values_or_items(it):
                method = it.func.attr  # type: ignore[union-attr]
                return f"iteration over unsorted dict .{method}()"
            if isinstance(it, (ast.Set, ast.SetComp)):
                return "iteration over a set literal"
            key = expr_key(it)
            if key is not None and key in tracker.set_names:
                return f"iteration over set-typed {key!r}"
            return None

        def enumerate_nondeterministic(it: ast.AST) -> Optional[str]:
            """``enumerate(<unordered>)`` bakes arrival order into indices —
            nondeterministic even when the result feeds an unordered sink."""
            if (
                isinstance(it, ast.Call)
                and _call_name(it) == "enumerate"
                and it.args
            ):
                why = iter_expr_nondeterministic(it.args[0])
                if why is not None:
                    return f"enumerate over nondeterministic order ({why})"
            return None

        # Comprehension nodes whose iteration order cannot leak: the whole
        # comprehension/genexp feeds a commutative reducer or rebuilds an
        # unordered container.
        safe_comps: Set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _call_name(node) in _COMMUTATIVE_SINKS:
                for arg in node.args:
                    if isinstance(arg, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
                        safe_comps.add(id(arg))
            if isinstance(node, (ast.SetComp, ast.DictComp)):
                safe_comps.add(id(node))

        for node in ast.walk(mod.tree):
            # -- banned imports / calls -----------------------------------
            if isinstance(node, ast.Import):
                for alias in node.names:
                    root = alias.name.split(".")[0]
                    if root in _BANNED_MODULE_IMPORTS:
                        emit(node, f"import of nondeterministic module {root!r}")
            elif isinstance(node, ast.ImportFrom):
                root = (node.module or "").split(".")[0]
                if root in _BANNED_MODULE_IMPORTS:
                    emit(node, f"import from nondeterministic module {root!r}")
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and isinstance(
                    node.func.value, ast.Name
                ):
                    base, attr = node.func.value.id, node.func.attr
                    if base == "time":
                        emit(node, f"wall-clock call time.{attr}()")
                    elif base == "os" and attr == "urandom":
                        emit(node, "ambient entropy via os.urandom()")
                    elif base == "random":
                        emit(node, f"ambient randomness via random.{attr}()")
                elif _call_name(node) == "id":
                    emit(node, "id() yields address-derived (nondeterministic) values")

            # -- unordered iteration --------------------------------------
            if isinstance(node, (ast.For, ast.AsyncFor)):
                why = enumerate_nondeterministic(node.iter) or iter_expr_nondeterministic(
                    node.iter
                )
                if why is not None:
                    emit(node, f"{why} in a for loop; wrap in sorted(...)")
            elif isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
                for comp in node.generators:
                    # enumerate leaks order through value expressions, so it
                    # is flagged even inside set/dict/commutative sinks.
                    why = enumerate_nondeterministic(comp.iter)
                    if why is None and id(node) not in safe_comps:
                        why = iter_expr_nondeterministic(comp.iter)
                    if why is not None:
                        emit(node, f"{why} in a comprehension; wrap in sorted(...)")
        return findings


@register
class GlvTableOrderRule(Rule):
    """Determinism-family guard for the GLV/GLS joint-table build.

    The 16-entry joint tables in ``ops/curve.py`` (``_joint_table*``)
    define the gather layout of every endomorphism ladder: entry idx must
    mean the SAME window combination in every process, or replayed runs
    and the ``HBBFT_TPU_NO_GLV`` A/B stop being bit-identical.  The build
    must therefore iterate window indices in a fixed arithmetic order —
    every ``for`` loop and comprehension inside a ``_joint_table*``
    function is required to iterate a literal ``range(...)`` (sets,
    dicts, ``.values()``/``.items()`` and arbitrary iterables are all
    rejected, not merely the provably-unordered ones: the table layout
    is load-bearing enough to pin the idiom, not just the semantics).
    The rule also fails when NO ``_joint_table*`` function exists, so a
    rename or deletion cannot silently retire the guard.
    """

    rule_id = "glv-table-order"
    scope = ("hbbft_tpu_torch/ops/curve.py",)

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []

        def emit(node: ast.AST, message: str) -> None:
            findings.append(
                Finding(
                    self.rule_id,
                    mod.path,
                    getattr(node, "lineno", 1),
                    getattr(node, "col_offset", 0),
                    message,
                )
            )

        def is_range_call(it: ast.AST) -> bool:
            return (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name)
                and it.func.id == "range"
            )

        fns = [
            n
            for n in ast.walk(mod.tree)
            if isinstance(n, ast.FunctionDef) and n.name.startswith("_joint_table")
        ]
        if not fns:
            emit(
                mod.tree,
                "no _joint_table* function found: the joint-table build "
                "(and its fixed-order guard) is missing from ops/curve.py",
            )
        for fn in fns:
            for node in ast.walk(fn):
                iters: List[ast.AST] = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(
                    node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
                ):
                    iters.extend(c.iter for c in node.generators)
                for it in iters:
                    if not is_range_call(it):
                        emit(
                            it,
                            f"table precomputation in {fn.name}() must "
                            "iterate window indices via range(...); found a "
                            "non-range iterable",
                        )
        return findings
