"""Pure-AST def-use + call-graph summaries for the seam rules.

The dynamic half (analysis/schedules.py) *executes* schedules;
this module is the static half's substrate: per-function summaries of
which ``self`` attributes a method reads and writes, which callables it
invokes (with argument mapping, so a sender-controlled parameter can be
tracked one call level down), and which nested functions/lambdas it
hands off as callbacks or returns as resolvers.  Everything is plain
``ast`` work on one module at a time — no imports of the code under
analysis, same contract as the rest of ``hbbft_tpu_torch/analysis``.

Attribute paths are rooted at ``self`` and recorded as dotted strings
(``"counters.pairing_checks"`` for ``self.counters.pairing_checks``,
via one level of local-alias resolution: ``c = self.counters; c.x += 1``
is a write to ``counters.x``).  A *write* is an assignment/aug-assignment
whose target is such a path, a mutating method call on it
(``self.q.append(...)``), or passing it as the mutated first argument of
the known in-place helpers (``heapq.heappush(self.q, ...)``).  Reads are
all other Load-context accesses; ``self.meth(...)`` where ``meth`` is a
function defined on the same class is recorded as a call site instead.

Path conflict is prefix-aware: a write to ``counters.x`` conflicts with
a read of ``counters`` (the whole object was observed) and vice versa.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.analysis.engine import ModuleSource

#: method names that mutate their receiver in place
MUTATING_METHODS = frozenset(
    (
        "append", "add", "insert", "extend", "setdefault", "update",
        "pop", "popitem", "clear", "remove", "discard", "push",
        "appendleft", "popleft", "sort", "reverse",
    )
)
#: free functions whose FIRST argument is mutated in place
MUTATING_FIRST_ARG = frozenset(
    ("heapq.heappush", "heapq.heappop", "heapq.heapify", "random.shuffle")
)


@dataclass(frozen=True)
class Access:
    """One read or write of a ``self``-rooted attribute path."""

    path: str  # dotted, without the "self." prefix
    line: int
    col: int
    kind: str  # "read" | "write"

    @property
    def root(self) -> str:
        return self.path.split(".", 1)[0]


def paths_conflict(a: str, b: str) -> bool:
    """Prefix-aware overlap: ``counters`` vs ``counters.x`` conflict."""
    return a == b or a.startswith(b + ".") or b.startswith(a + ".")


@dataclass
class CallSite:
    """One call made from a function body."""

    name: str  # simple callee name ("submit" for self._pipe.submit)
    dotted: Optional[str]  # full dotted form when resolvable
    on_self: bool  # self.<name>(...) — same-class method candidate
    line: int
    col: int
    node: ast.Call
    #: positional argument expressions that are bare names, by position
    name_args: Dict[int, str] = field(default_factory=dict)
    #: keyword argument expressions that are bare names, by kwarg
    name_kwargs: Dict[str, str] = field(default_factory=dict)

    def param_for_name(
        self, callee_params: Sequence[str], value_name: str
    ) -> Optional[str]:
        """Which of ``callee_params`` receives the caller's ``value_name``?
        ``callee_params`` excludes ``self`` for bound-method calls."""
        for pos, nm in self.name_args.items():
            if nm == value_name and pos < len(callee_params):
                return callee_params[pos]
        for kw, nm in self.name_kwargs.items():
            if nm == value_name and kw in callee_params:
                return kw
        return None


@dataclass
class FunctionSummary:
    """Def-use summary of one function (or nested function / lambda)."""

    name: str
    qualname: str
    node: ast.AST  # FunctionDef or Lambda
    params: List[str]
    reads: List[Access] = field(default_factory=list)
    writes: List[Access] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    #: nested defs/lambdas declared in this body, by name ("<lambda:LINE>")
    nested: Dict[str, "FunctionSummary"] = field(default_factory=dict)
    #: names of nested callables given away as callback arguments, keyed
    #: by the kwarg (or "#<pos>") they were passed under, with the call's
    #: callee name — e.g. ("submit", "on_result") -> "deliver"
    callbacks: List[Tuple[str, str, str]] = field(default_factory=list)
    #: names of nested callables (or "<lambda:LINE>") that are returned
    returned_callables: List[str] = field(default_factory=list)

    def writes_to(self, path: str) -> List[Access]:
        return [a for a in self.writes if paths_conflict(a.path, path)]

    def reads_of(self, path: str) -> List[Access]:
        return [a for a in self.reads if paths_conflict(a.path, path)]


@dataclass
class ClassSummary:
    name: str
    node: ast.ClassDef
    methods: Dict[str, FunctionSummary] = field(default_factory=dict)
    bases: List[str] = field(default_factory=list)


@dataclass
class ModuleSummary:
    path: str
    classes: Dict[str, ClassSummary] = field(default_factory=dict)
    functions: Dict[str, FunctionSummary] = field(default_factory=dict)


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _self_path(
    node: ast.AST, aliases: Dict[str, str], self_name: str = "self"
) -> Optional[str]:
    """Dotted path rooted at self (via up to one local alias), else None.
    Subscripts collapse onto their base path (``self.q[i]`` -> ``q``)."""
    parts: List[str] = []
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    if node.id == self_name:
        pass
    elif node.id in aliases:
        parts.append(aliases[node.id])
    else:
        return None
    return ".".join(reversed(parts)) if parts else None


class _FunctionScanner:
    """Collect one function's accesses/calls WITHOUT descending into
    nested function bodies (those get their own summaries)."""

    def __init__(self, fn: ast.AST, qualname: str) -> None:
        self.fn = fn
        if isinstance(fn, ast.Lambda):
            name = qualname.rsplit(".", 1)[-1]
            params = [a.arg for a in fn.args.args]
            body: List[ast.AST] = [fn.body]
        else:
            name = fn.name
            params = [a.arg for a in fn.args.args]
            body = list(fn.body)
        self.summary = FunctionSummary(
            name=name, qualname=qualname, node=fn, params=params
        )
        #: local -> self-attr aliases (``c = self.counters``)
        self.aliases: Dict[str, str] = {}
        self._alias_sources: set = set()
        self._scan_aliases(body)
        write_nodes = set()
        #: attribute nodes that are the FUNC of a call — the final attr is
        #: a method lookup, not a state read (the receiver read is
        #: recorded separately), so the plain read pass skips them
        self._func_nodes: set = set()
        for stmt in self._walk_local(body):
            self._collect_writes(stmt, write_nodes)
        for stmt in self._walk_local(body):
            self._collect_reads_calls(stmt, write_nodes)

    def _walk_local(self, body: Iterable[ast.AST]):
        """ast.walk, but stopping at nested function/lambda boundaries
        (including nested defs that sit directly in ``body``)."""
        stack = [
            n
            for n in body
            if not isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            )
        ]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                stack.append(child)

    def _scan_aliases(self, body: Iterable[ast.AST]) -> None:
        for node in self._walk_local(body):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            path = _self_path(node.value, {})
            if path is not None:
                self.aliases[t.id] = path
                # the aliasing assignment itself is not a state read —
                # the read materializes where the alias is USED
                for sub in ast.walk(node.value):
                    self._alias_sources.add(id(sub))

    def _access(self, node: ast.AST, kind: str) -> Optional[Access]:
        path = _self_path(node, self.aliases)
        if path is None:
            return None
        return Access(
            path, getattr(node, "lineno", 0), getattr(node, "col_offset", 0), kind
        )

    def _collect_writes(self, node: ast.AST, write_nodes: set) -> None:
        s = self.summary
        def record(el: ast.AST) -> None:
            acc = self._access(el, "write")
            if acc is not None:
                s.writes.append(acc)
                # the whole target chain is part of the write, not reads
                for sub in ast.walk(el):
                    write_nodes.add(id(sub))

        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                for el in self._unpack(t):
                    # a bare Name target is a local REBINDING, never a
                    # state write, even when the name aliases self state
                    if not isinstance(el, ast.Name):
                        record(el)
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in MUTATING_METHODS
            ):
                record(node.func.value)
            dotted = _dotted(node.func)
            if dotted in MUTATING_FIRST_ARG and node.args:
                record(node.args[0])

    @staticmethod
    def _unpack(target: ast.AST) -> Iterable[ast.AST]:
        if isinstance(target, (ast.Tuple, ast.List)):
            return target.elts
        return (target,)

    def _collect_reads_calls(self, node: ast.AST, write_nodes: set) -> None:
        s = self.summary
        if isinstance(node, ast.Call):
            func = node.func
            name = None
            on_self = False
            if isinstance(func, ast.Attribute):
                name = func.attr
                on_self = (
                    isinstance(func.value, ast.Name) and func.value.id == "self"
                )
            elif isinstance(func, ast.Name):
                name = func.id
            if name is not None:
                site = CallSite(
                    name=name,
                    dotted=_dotted(func),
                    on_self=on_self,
                    line=node.lineno,
                    col=node.col_offset,
                    node=node,
                )
                for i, a in enumerate(node.args):
                    if isinstance(a, ast.Name):
                        site.name_args[i] = a.id
                for kw in node.keywords:
                    if kw.arg is not None and isinstance(kw.value, ast.Name):
                        site.name_kwargs[kw.arg] = kw.value.id
                s.calls.append(site)
            if isinstance(func, ast.Attribute):
                # `self._q.append(x)`: the `.append` lookup is not a state
                # read; record the RECEIVER (`self._q`) as the read —
                # unless this very node is already the write of a
                # mutating call (then the write subsumes it).
                self._func_nodes.add(id(func))
                if not on_self and id(func.value) not in write_nodes:
                    acc = self._access(func.value, "read")
                    if acc is not None:
                        s.reads.append(acc)
        elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            if (
                id(node) in write_nodes
                or id(node) in self._func_nodes
                or id(node) in self._alias_sources
            ):
                return
            # Only record the OUTERMOST attribute of a chain: walking
            # will also visit `self.a` inside `self.a.b`, which would
            # double-count.  Detect by checking the parent isn't an
            # Attribute — ast doesn't give parents, so approximate by
            # recording all and deduping on position+prefix below.
            acc = self._access(node, "read")
            if acc is not None:
                s.reads.append(acc)
        elif isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Name):
                s.returned_callables.append(node.value.id)
            elif isinstance(node.value, ast.Lambda):
                s.returned_callables.append(f"<lambda:{node.value.lineno}>")
            elif isinstance(node.value, ast.Tuple):
                for el in node.value.elts:
                    if isinstance(el, ast.Name):
                        s.returned_callables.append(el.id)


def _dedup_reads(reads: List[Access]) -> List[Access]:
    """Drop inner-chain duplicates: for reads at the same line/col keep
    only the longest path (``self.a.b`` visits record both ``a.b`` at the
    Attribute node and ``a`` at its child position)."""
    best: Dict[Tuple[int, int, str], Access] = {}
    for a in reads:
        key = (a.line, a.col, a.root)
        cur = best.get(key)
        if cur is None or len(a.path) > len(cur.path):
            best[key] = a
    return sorted(best.values(), key=lambda a: (a.line, a.col, a.path))


def summarize_function(
    fn: ast.AST, qualname: str
) -> FunctionSummary:
    """Summary of ``fn`` plus recursive summaries of its nested defs."""
    scanner = _FunctionScanner(fn, qualname)
    s = scanner.summary
    s.reads = _dedup_reads(s.reads)
    body = [fn.body] if isinstance(fn, ast.Lambda) else fn.body
    for node in ast.walk(ast.Module(body=list(body), type_ignores=[])):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self_contains(fn, child):
                    s.nested[child.name] = summarize_function(
                        child, f"{qualname}.{child.name}"
                    )
            elif isinstance(child, ast.Lambda):
                key = f"<lambda:{child.lineno}>"
                s.nested[key] = summarize_function(child, f"{qualname}.{key}")
    # which nested callables are handed to calls as callbacks
    for site in s.calls:
        for pos, nm in site.name_args.items():
            if nm in s.nested:
                s.callbacks.append((site.name, f"#{pos}", nm))
        for kw, nm in site.name_kwargs.items():
            if nm in s.nested:
                s.callbacks.append((site.name, kw, nm))
    return s


def self_contains(outer: ast.AST, inner: ast.AST) -> bool:
    """Is ``inner`` nested DIRECTLY under ``outer`` (not via another
    function)?  Prevents double-summarizing grandchildren."""
    body = [outer.body] if isinstance(outer, ast.Lambda) else outer.body
    stack = list(body)
    while stack:
        node = stack.pop()
        if node is inner:
            return True
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue  # another function's body: its nested defs are ITS
        stack.extend(ast.iter_child_nodes(node))
    return False


def summarize_module(mod: ModuleSource) -> ModuleSummary:
    # Memoized on the (immutable) ModuleSource: seam-race and the three
    # snapshot rules all summarize overlapping scopes in one lint run,
    # and the walk dominates lint wall time.
    cached = getattr(mod, "_dataflow_summary", None)
    if cached is not None:
        return cached
    out = ModuleSummary(path=mod.path)
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef):
            cls = ClassSummary(
                name=node.name,
                node=node,
                bases=[b for b in map(_dotted, node.bases) if b is not None],
            )
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    key = item.name
                    if key in cls.methods:
                        # property getter/setter pairs share a name;
                        # keep both bodies under distinct keys
                        key = f"{item.name}@{item.lineno}"
                    cls.methods[key] = summarize_function(
                        item, f"{node.name}.{item.name}"
                    )
            out.classes[node.name] = cls
        elif isinstance(node, ast.FunctionDef):
            out.functions[node.name] = summarize_function(node, node.name)
    try:
        mod._dataflow_summary = out  # type: ignore[attr-defined]
    except AttributeError:
        pass  # slotted test double: caching is best-effort
    return out


def resolve_self_call(
    cls: ClassSummary, site: CallSite
) -> Optional[FunctionSummary]:
    """The same-class method a ``self.meth(...)`` site targets, if any."""
    if not site.on_self:
        return None
    return cls.methods.get(site.name)
