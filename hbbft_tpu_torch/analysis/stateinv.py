"""Per-class mutable-state inventory for the snapshot/WAL-replay rules.

The crash axis makes recovery "restore a checkpoint, then bit-identical WAL
replay"; :mod:`hbbft_tpu_torch.utils.snapshot` enforces the *dynamic* half of
that contract (callables are rejected at encode, ``_SNAPSHOT_ENV_ATTRS``
drops environment hooks).  This module is the *static* half's substrate:
a pure-AST inventory of every ``self.x`` write site in a class —

* classified **init-only** vs **runtime-mutated** (a write is init-only
  when it happens in ``__init__`` or a helper reachable *only* from
  ``__init__``; writes inside nested closures are always runtime, since
  a closure built in ``__init__`` may run much later);
* classified by **value shape**: lambda / nested def / bound method
  (statically unserializable), parameter-sourced (an externally supplied
  object — the hook-detachment signal), or plain;
* cross-referenced with the class's ``_SNAPSHOT_ENV_ATTRS`` declaration
  and its class-body defaults (a restored instance falls back to the
  class attribute for every env attr, so a declaration without a default
  is a latent ``AttributeError``);
* annotated with **hook-call** sites: attributes invoked directly
  (``self.x(...)``) or element-wise (``for f in self.x: ... f(...)``).

Everything is built on :mod:`hbbft_tpu_torch.analysis.dataflow` def-use
summaries (so one-level aliases like ``c = self.counters`` resolve), plus
a small value-expression walk of our own — the dataflow summaries do not
retain assignment right-hand sides.

The ``_STATE_MODULES`` registry itself is read *statically* from
``hbbft_tpu_torch/utils/snapshot.py`` (from the lint project when the file is
loaded, from disk otherwise), so the linter keeps its no-import
guarantee and unit tests with synthetic module sets still resolve the
real registry.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.analysis.dataflow import (
    ClassSummary,
    FunctionSummary,
    ModuleSummary,
    summarize_module,
)
from hbbft_tpu_torch.analysis.engine import LintProject, ModuleSource

#: repo-relative path of the snapshot class registry
STATE_REGISTRY_PATH = "hbbft_tpu_torch/utils/snapshot.py"

#: class attribute naming checkpoint-detached environment attrs
ENV_DECL = "_SNAPSHOT_ENV_ATTRS"


# ---------------------------------------------------------------------------
# Registry / declaration parsing
# ---------------------------------------------------------------------------


def state_module_paths(project: LintProject) -> Tuple[str, ...]:
    """Repo-relative paths of every ``_STATE_MODULES`` module, parsed
    statically from the snapshot registry (never imported)."""
    mod = project.module(STATE_REGISTRY_PATH)
    if mod is not None:
        tree = mod.tree
    else:
        p = project.repo_root / STATE_REGISTRY_PATH
        if not p.exists():
            return ()
        tree = ast.parse(p.read_text(encoding="utf-8"))
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "_STATE_MODULES"
            for t in node.targets
        ):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            out = []
            for el in node.value.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    out.append(el.value.replace(".", "/") + ".py")
            return tuple(out)
    return ()


def parse_env_attrs(cls_node: ast.ClassDef) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``(names, line)`` of the class-body ``_SNAPSHOT_ENV_ATTRS``
    declaration, or ``((), None)`` when the class has none."""
    for item in cls_node.body:
        if not isinstance(item, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == ENV_DECL for t in item.targets
        ):
            continue
        if isinstance(item.value, (ast.Tuple, ast.List)):
            names = tuple(
                el.value
                for el in item.value.elts
                if isinstance(el, ast.Constant) and isinstance(el.value, str)
            )
            return names, item.lineno
        return (), item.lineno
    return (), None


def class_body_defaults(cls_node: ast.ClassDef) -> Set[str]:
    """Names bound at class-body level (plain and annotated assignments
    with a value — i.e. real defaults, not bare annotations)."""
    out: Set[str] = set()
    for item in cls_node.body:
        if isinstance(item, ast.Assign):
            for t in item.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(item, ast.AnnAssign) and item.value is not None:
            if isinstance(item.target, ast.Name):
                out.add(item.target.id)
    return out


# ---------------------------------------------------------------------------
# Inventory data model
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class WriteSite:
    """One ``self.x`` (or aliased) write."""

    line: int
    col: int
    context: str  # qualname of the writing function
    in_init: bool  # on the __init__-only call path
    value: str  # "lambda" | "def" | "bound-method" | "param" | "plain"
    params: Tuple[str, ...] = ()  # parameter names feeding a "param" write

    @property
    def callable_kind(self) -> Optional[str]:
        """Human word for a statically-unserializable value, else None."""
        return {
            "lambda": "lambda",
            "def": "nested function",
            "bound-method": "bound method",
        }.get(self.value)


@dataclass(slots=True)
class AttrRecord:
    """Every write/read of one attribute root within a class."""

    name: str
    writes: List[WriteSite] = field(default_factory=list)
    read_lines: List[int] = field(default_factory=list)

    @property
    def init_only(self) -> bool:
        return bool(self.writes) and all(w.in_init for w in self.writes)

    @property
    def runtime_writes(self) -> List[WriteSite]:
        return [w for w in self.writes if not w.in_init]


@dataclass(slots=True)
class ClassInventory:
    """The full mutable-state picture of one class."""

    name: str
    path: str
    lineno: int
    env_attrs: Tuple[str, ...]
    env_line: Optional[int]
    class_defaults: Set[str]
    method_names: Set[str]
    attrs: Dict[str, AttrRecord]
    #: attr -> line of the first direct (``self.x(...)``) or element-wise
    #: (``for f in self.x: ... f(...)``) invocation
    hook_calls: Dict[str, int]

    def is_real(self, attr: str) -> bool:
        """Does ``attr`` exist anywhere in the class — as a default, a
        write, a read, or a hook call?"""
        rec = self.attrs.get(attr)
        return (
            attr in self.class_defaults
            or attr in self.hook_calls
            or (rec is not None and bool(rec.writes or rec.read_lines))
        )


# ---------------------------------------------------------------------------
# init-path computation
# ---------------------------------------------------------------------------


def init_path_methods(cls: ClassSummary) -> Set[str]:
    """Method names executed only during construction: ``__init__`` plus
    every helper whose callers are all already on the init path.  A
    method with no same-class callers is an entry point (runtime)."""
    callers: Dict[str, Set[str]] = {}
    for key, m in cls.methods.items():
        for site in m.calls:
            if site.on_self:
                callers.setdefault(site.name, set()).add(m.name)
    init: Set[str] = set()
    if "__init__" in cls.methods:
        init.add("__init__")
    changed = True
    while changed:
        changed = False
        for key, m in cls.methods.items():
            nm = m.name
            if nm in init:
                continue
            who = callers.get(nm)
            if who and who <= init:
                init.add(nm)
                changed = True
    return init


# ---------------------------------------------------------------------------
# Value-expression classification
# ---------------------------------------------------------------------------


def _self_attr_root(node: ast.AST) -> Optional[Tuple[str, int, int]]:
    """``(root, line, col)`` when ``node`` is an attribute chain rooted at
    ``self`` (``self.x``, ``self.x.y``...)."""
    chain = node
    while isinstance(chain, ast.Attribute):
        inner = chain.value
        if isinstance(inner, ast.Name) and inner.id == "self":
            return chain.attr, node.lineno, node.col_offset
        chain = inner
    return None


def _classify_value(
    value: ast.AST,
    nested_defs: Set[str],
    method_names: Set[str],
    params: Set[str],
) -> Tuple[str, Tuple[str, ...]]:
    """Shape of an assignment RHS: see :class:`WriteSite`."""
    if isinstance(value, ast.Lambda):
        return "lambda", ()
    if isinstance(value, ast.Name) and value.id in nested_defs:
        return "def", ()
    if (
        isinstance(value, ast.Attribute)
        and isinstance(value.value, ast.Name)
        and value.value.id == "self"
        and value.attr in method_names
    ):
        return "bound-method", ()
    hit = tuple(
        sorted(
            {
                n.id
                for n in ast.walk(value)
                if isinstance(n, ast.Name) and n.id in params
            }
        )
    )
    if hit:
        return "param", hit
    return "plain", ()


def _scan_method(
    method_node: ast.AST, method_names: Set[str]
) -> Tuple[
    Dict[Tuple[int, int], Tuple[str, Tuple[str, ...]]], Dict[str, int]
]:
    """One walk of ``method_node`` collecting both value shapes and hook
    calls (the walk is the cost; four separate passes doubled lint wall).

    Returns ``(value_kinds, hook_calls)``: value_kinds maps the (line,
    col) of each direct ``self.x`` assignment target to the RHS shape
    (coordinates are the target Attribute node's, matching the dataflow
    write Access for the same site); hook_calls maps attr roots invoked
    directly (``self.x(...)``, x not a method) or element-wise (``for f
    in self.x: ... f(...)``) to the first such line.
    """
    params: Set[str] = set()
    nested: Set[str] = set()
    assigns: List[Tuple[ast.AST, ast.AST]] = []  # (target, value)
    hook_calls: Dict[str, int] = {}

    def note(attr: str, line: int) -> None:
        if attr not in hook_calls or line < hook_calls[attr]:
            hook_calls[attr] = line

    for node in ast.walk(method_node):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            a = node.args
            for arg in (
                list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
            ):
                params.add(arg.arg)
            if a.vararg:
                params.add(a.vararg.arg)
            if a.kwarg:
                params.add(a.kwarg.arg)
            if node is not method_node and not isinstance(node, ast.Lambda):
                nested.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                assigns.append((t, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if node.value is not None:
                assigns.append((node.target, node.value))
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and f.attr not in method_names
            ):
                note(f.attr, node.lineno)
        elif isinstance(node, ast.For):
            hit = _self_attr_root(node.iter)
            if hit is None or not isinstance(node.target, ast.Name):
                continue
            loopvar = node.target.id
            for inner in ast.walk(node):
                if (
                    isinstance(inner, ast.Call)
                    and isinstance(inner.func, ast.Name)
                    and inner.func.id == loopvar
                ):
                    note(hit[0], node.iter.lineno)
                    break
    params.discard("self")
    kinds: Dict[Tuple[int, int], Tuple[str, Tuple[str, ...]]] = {}
    for t, value in assigns:
        hit = _self_attr_root(t)
        if hit is None:
            continue
        _, line, col = hit
        kinds[(line, col)] = _classify_value(
            value, nested, method_names, params
        )
    return kinds, hook_calls


# ---------------------------------------------------------------------------
# Per-class / per-module inventory
# ---------------------------------------------------------------------------


def inventory_class(
    mod: ModuleSource, cls: ClassSummary
) -> ClassInventory:
    """Build the full inventory of one class from its dataflow summary."""
    env_attrs, env_line = parse_env_attrs(cls.node)
    method_names = {m.name for m in cls.methods.values()}
    init_path = init_path_methods(cls)
    inv = ClassInventory(
        name=cls.name,
        path=mod.path,
        lineno=cls.node.lineno,
        env_attrs=env_attrs,
        env_line=env_line,
        class_defaults=class_body_defaults(cls.node),
        method_names=method_names,
        attrs={},
        hook_calls={},
    )

    def rec(attr: str) -> AttrRecord:
        r = inv.attrs.get(attr)
        if r is None:
            r = inv.attrs[attr] = AttrRecord(name=attr)
        return r

    def collect(
        summary: FunctionSummary,
        kinds: Dict[Tuple[int, int], Tuple[str, Tuple[str, ...]]],
        in_init: bool,
    ) -> None:
        for w in summary.writes:
            value, params = kinds.get((w.line, w.col), ("plain", ()))
            rec(w.root).writes.append(
                WriteSite(
                    line=w.line,
                    col=w.col,
                    context=summary.qualname,
                    in_init=in_init,
                    value=value,
                    params=params,
                )
            )
        for r in summary.reads:
            rec(r.root).read_lines.append(r.line)
        # Closures share self but run at call time, not def time: their
        # writes are runtime-mutated even when defined under __init__.
        for sub in summary.nested.values():
            collect(sub, kinds, in_init=False)

    for key, m in cls.methods.items():
        kinds, hooks = _scan_method(m.node, method_names)
        collect(m, kinds, in_init=m.name in init_path)
        for attr, line in hooks.items():
            if attr not in inv.hook_calls or line < inv.hook_calls[attr]:
                inv.hook_calls[attr] = line
    for r in inv.attrs.values():
        r.writes.sort(key=lambda w: (w.line, w.col))
        r.read_lines.sort()
    return inv


def module_summary(mod: ModuleSource) -> ModuleSummary:
    """Dataflow summary of ``mod`` (memoized inside ``summarize_module``
    on the ModuleSource, so every rule in one lint run pays the walk
    once)."""
    return summarize_module(mod)


def inventory_module(mod: ModuleSource) -> List[ClassInventory]:
    """Inventories of every class in ``mod``, in source order.  Memoized
    on the ModuleSource: coverage and hook-detachment share one scope."""
    cached = getattr(mod, "_stateinv_inventory", None)
    if cached is not None:
        return cached
    summary = module_summary(mod)
    out = [
        inventory_class(mod, cls)
        for cls in sorted(
            summary.classes.values(), key=lambda c: c.node.lineno
        )
    ]
    mod._stateinv_inventory = out  # type: ignore[attr-defined]
    return out
