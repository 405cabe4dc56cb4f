"""Snapshot/WAL-replay soundness rules (the static twin of
``crash:replay_divergence``).

Three rule families over the :mod:`hbbft_tpu_torch.analysis.stateinv`
inventory:

``snapshot-coverage``
    On every class in a ``_STATE_MODULES`` module: an attribute assigned
    a statically-unserializable callable (lambda, nested def, bound
    method) must be declared in ``_SNAPSHOT_ENV_ATTRS`` — ``save_node``
    rejects callables in state, so an undeclared one is a checkpoint
    crash waiting for the first snapshot.  Conversely every declared env
    attr must be *real* (defined, written, or read somewhere in the
    class) and must have a class-body default — restore drops env attrs
    and falls back to the class attribute, so a declaration without a
    default is a latent ``AttributeError`` on the restored object.

``replay-purity``
    Code reachable from the WAL replay path (``net/crash.py``
    ``_restart``/``_replay*`` seeds, propagated caller→callee to
    fixpoint like seam-race) must not: read a checkpoint-detached env
    attr without a None/truthiness guard (a restored node sees the class
    default, not the pre-crash value), invoke a detached hook at all
    (tracer, ``batch_listeners``, ``batch_size_provider``, probes —
    hooks are environment and must not steer replay), draw entropy
    outside the logged rng stream, or read wall clocks.  Every finding
    names its reach chain back to the seed.

``hook-detachment``
    An attribute that receives an externally-supplied callable (the
    value flows from a method parameter) *and* is invoked as a hook must
    be env-declared, or it rides into snapshots and ``save_node`` dies.
    Module-level functions are exempt at the encoder (serialized by
    name), so a justified exception carries a reasoned suppression.

Scope: ``snapshot-coverage``/``hook-detachment`` run exactly over the
``_STATE_MODULES`` registry (parsed statically from
``utils/snapshot.py``).  ``replay-purity`` propagates through the wider
deterministic core (protocols/net/core/traffic/control/engine/utils plus
the replay-adjacent obs trio) but deliberately not ``crypto/``/``ops/``
(backend compute has its own determinism contract) nor ``analysis/``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hbbft_tpu_torch.analysis.dataflow import (
    MUTATING_METHODS,
    ClassSummary,
    FunctionSummary,
)
from hbbft_tpu_torch.analysis.engine import Finding, LintProject, Rule, register
from hbbft_tpu_torch.analysis.stateinv import (
    ClassInventory,
    inventory_module,
    module_summary,
    parse_env_attrs,
    state_module_paths,
)

# ---------------------------------------------------------------------------
# snapshot-coverage
# ---------------------------------------------------------------------------


@register
class SnapshotCoverageRule(Rule):
    """Callable-valued state must be env-declared; env declarations must
    be real and defaulted."""

    rule_id = "snapshot-coverage"

    def check_project(self, project: LintProject) -> List[Finding]:
        out: List[Finding] = []
        for path in state_module_paths(project):
            mod = project.module(path)
            if mod is None:
                continue
            for inv in inventory_module(mod):
                out.extend(self._check_class(inv))
        return out

    def _check_class(self, inv: ClassInventory) -> List[Finding]:
        out: List[Finding] = []
        for attr in sorted(inv.attrs):
            if attr in inv.env_attrs:
                continue
            for w in inv.attrs[attr].writes:
                kind = w.callable_kind
                if kind is None:
                    continue
                out.append(
                    Finding(
                        self.rule_id,
                        inv.path,
                        w.line,
                        w.col,
                        f"self.{attr} on state class {inv.name} is assigned "
                        f"a {kind} ({w.context}) but is not declared in "
                        f"_SNAPSHOT_ENV_ATTRS; save_node rejects callables "
                        f"in state — declare it environment or store "
                        f"serializable state",
                    )
                )
                break  # one finding per attr: the minimal repro site
        for attr in inv.env_attrs:
            line = inv.env_line or inv.lineno
            if not inv.is_real(attr):
                out.append(
                    Finding(
                        self.rule_id,
                        inv.path,
                        line,
                        0,
                        f"_SNAPSHOT_ENV_ATTRS on {inv.name} declares "
                        f"{attr!r} but the class never defines, writes, or "
                        f"reads it; remove the dead declaration",
                    )
                )
            elif attr not in inv.class_defaults:
                out.append(
                    Finding(
                        self.rule_id,
                        inv.path,
                        line,
                        0,
                        f"env attr {attr!r} on {inv.name} has no class-body "
                        f"default; restore drops env attrs and falls back "
                        f"to the class attribute, so a restored instance "
                        f"would raise AttributeError",
                    )
                )
        return out


# ---------------------------------------------------------------------------
# hook-detachment
# ---------------------------------------------------------------------------


@register
class HookDetachmentRule(Rule):
    """Externally-supplied, invoked callables must be env-declared."""

    rule_id = "hook-detachment"

    def check_project(self, project: LintProject) -> List[Finding]:
        out: List[Finding] = []
        for path in state_module_paths(project):
            mod = project.module(path)
            if mod is None:
                continue
            for inv in inventory_module(mod):
                out.extend(self._check_class(inv))
        return out

    def _check_class(self, inv: ClassInventory) -> List[Finding]:
        out: List[Finding] = []
        for attr in sorted(inv.hook_calls):
            if attr in inv.env_attrs or attr in inv.method_names:
                continue
            rec = inv.attrs.get(attr)
            if rec is None:
                continue
            site = next(
                (w for w in rec.writes if w.value == "param"), None
            )
            if site is None:
                continue
            out.append(
                Finding(
                    self.rule_id,
                    inv.path,
                    site.line,
                    site.col,
                    f"self.{attr} on state class {inv.name} receives an "
                    f"externally-supplied value ({site.context} parameter "
                    f"{', '.join(site.params)}) and is invoked as a hook; "
                    f"declare it in _SNAPSHOT_ENV_ATTRS so snapshots "
                    f"detach it (module-level functions serialize by name "
                    f"and may be suppressed with a reason)",
                )
            )
        return out


# ---------------------------------------------------------------------------
# replay-purity
# ---------------------------------------------------------------------------

#: methods in net/crash.py that start a WAL replay
REPLAY_SEED = re.compile(r"^(_restart|_replay\w*)$")
SEED_PATH_SUFFIX = "net/crash.py"

#: modules the reach propagation walks (posix path prefixes)
REACH_SCOPE: Tuple[str, ...] = (
    "hbbft_tpu_torch/protocols/",
    "hbbft_tpu_torch/net/",
    "hbbft_tpu_torch/core/",
    "hbbft_tpu_torch/traffic/",
    "hbbft_tpu_torch/control/",
    "hbbft_tpu_torch/engine/",
    "hbbft_tpu_torch/utils/",
    # replay-adjacent observability: the critpath recorder runs inside
    # the recovery window, so its code rides the purity contract
    "hbbft_tpu_torch/obs/critpath.py",
    "hbbft_tpu_torch/obs/timeseries.py",
    "hbbft_tpu_torch/obs/flight.py",
)

#: callee names never resolved across classes — builtin container /
#: string verbs and ubiquitous tiny helpers whose name-based resolution
#: would wire the whole package together
SKIP_CALL_NAMES: frozenset = MUTATING_METHODS | frozenset(
    {
        "get", "items", "keys", "values", "copy", "join", "split",
        "startswith", "endswith", "strip", "encode", "format",
        "index", "count", "isoformat", "hexdigest", "to_bytes",
        "from_bytes", "bit_length", "most_common", "popleft",
        "appendleft", "read", "write", "flush", "close", "len",
        "repr", "str", "int", "bytes", "sorted", "min", "max",
        "isinstance", "hasattr", "getattr", "setattr", "tuple",
        "list", "dict", "set", "frozenset", "range", "enumerate",
        "zip", "map", "filter", "any", "all", "sum", "abs", "round",
        "print", "super", "type", "id", "hash", "iter", "next",
        "__class__",
    }
)

ENTROPY_PREFIXES = (
    "random.", "np.random.", "numpy.random.", "secrets.",
)
ENTROPY_EXACT = frozenset({"os.urandom", "random", "uuid.uuid4"})
WALLCLOCK_PREFIXES = ("time.",)
WALLCLOCK_EXACT = frozenset(
    {
        "datetime.now", "datetime.utcnow", "datetime.today",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "date.today", "datetime.date.today",
    }
)


class _Ctx:
    """One function body (method, module function, or nested closure) in
    the reach graph."""

    __slots__ = (
        "path", "cls", "summary", "env", "reached", "via", "children"
    )

    def __init__(
        self,
        path: str,
        cls: Optional[ClassSummary],
        summary: FunctionSummary,
        env: Tuple[str, ...],
    ) -> None:
        self.path = path
        self.cls = cls
        self.summary = summary
        self.env = env
        self.reached = False
        self.via: Optional["_Ctx"] = None
        self.children: List["_Ctx"] = []

    @property
    def qualname(self) -> str:
        return self.summary.qualname

    def chain(self) -> List[str]:
        out, cur = [], self
        while cur is not None and len(out) < 16:
            out.append(cur.qualname)
            cur = cur.via
        return list(reversed(out))


def _local_walk(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk ``fn`` without descending into nested function bodies (those
    are their own contexts with their own guards)."""
    body = [fn.body] if isinstance(fn, ast.Lambda) else list(fn.body)
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _self_root(node: ast.AST) -> Optional[str]:
    chain = node
    while isinstance(chain, ast.Attribute):
        inner = chain.value
        if isinstance(inner, ast.Name) and inner.id == "self":
            return chain.attr
        chain = inner
    return None


def _guarded_env_attrs(fn: ast.AST, env: Tuple[str, ...]) -> Set[str]:
    """Env attrs whose value is tested (``if self.x is not None``, plain
    truthiness, ``self.x and ...``) anywhere in ``fn``'s own body: reads
    of those attrs in this function are guard-aware and allowed."""
    guards: Set[str] = set()
    tests: List[ast.AST] = []
    for node in _local_walk(fn):
        if isinstance(node, (ast.If, ast.While)):
            tests.append(node.test)
        elif isinstance(node, ast.IfExp):
            tests.append(node.test)
        elif isinstance(node, ast.Assert):
            tests.append(node.test)
        elif isinstance(node, (ast.BoolOp, ast.Compare)):
            tests.append(node)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            tests.append(node.operand)
    for t in tests:
        for sub in ast.walk(t):
            root = _self_root(sub)
            if root is not None and root in env:
                guards.add(root)
    return guards


def _env_invocations(
    fn: ast.AST, env: Tuple[str, ...]
) -> Dict[str, int]:
    """Env attrs *invoked* in ``fn``: direct calls ``self.x(...)``,
    method calls ``self.x.m(...)``, element-wise ``for f in self.x``
    loops that call the loop variable."""
    out: Dict[str, int] = {}

    def note(attr: str, line: int) -> None:
        if attr not in out or line < out[attr]:
            out[attr] = line

    for node in _local_walk(fn):
        if isinstance(node, ast.Call):
            root = _self_root(node.func)
            if root is not None and root in env:
                note(root, node.lineno)
        elif isinstance(node, ast.For):
            root = _self_root(node.iter)
            if (
                root is not None
                and root in env
                and isinstance(node.target, ast.Name)
            ):
                loopvar = node.target.id
                for inner in ast.walk(node):
                    if (
                        isinstance(inner, ast.Call)
                        and isinstance(inner.func, ast.Name)
                        and inner.func.id == loopvar
                    ):
                        note(root, node.iter.lineno)
                        break
    return out


@register
class ReplayPurityRule(Rule):
    """WAL replay must be a closed function of checkpoint + WAL + logged
    rng: no detached-hook effects, no ambient entropy, no wall clocks."""

    rule_id = "replay-purity"

    def check_project(self, project: LintProject) -> List[Finding]:
        ctxs = self._build_contexts(project)
        self._propagate(ctxs)
        out: List[Finding] = []
        for ctx in ctxs:
            if ctx.reached:
                out.extend(self._check_ctx(ctx))
        return out

    # -- context graph ----------------------------------------------------

    def _build_contexts(self, project: LintProject) -> List[_Ctx]:
        ctxs: List[_Ctx] = []
        for path in sorted(project.modules):
            if not path.startswith(REACH_SCOPE):
                continue
            mod = project.modules[path]
            if getattr(mod, "syntax_error", None) is not None:
                continue
            summary = module_summary(mod)
            for cls in sorted(
                summary.classes.values(), key=lambda c: c.node.lineno
            ):
                env, _ = parse_env_attrs(cls.node)
                for key in sorted(cls.methods):
                    self._add_ctx(
                        ctxs, path, cls, cls.methods[key], env
                    )
            for name in sorted(summary.functions):
                self._add_ctx(
                    ctxs, path, None, summary.functions[name], ()
                )
        return ctxs

    def _add_ctx(
        self,
        ctxs: List[_Ctx],
        path: str,
        cls: Optional[ClassSummary],
        summary: FunctionSummary,
        env: Tuple[str, ...],
    ) -> _Ctx:
        ctx = _Ctx(path, cls, summary, env)
        ctxs.append(ctx)
        for key in sorted(summary.nested):
            ctx.children.append(
                self._add_ctx(ctxs, path, cls, summary.nested[key], env)
            )
        return ctx

    def _propagate(self, ctxs: List[_Ctx]) -> None:
        by_name: Dict[str, List[_Ctx]] = {}
        by_class: Dict[Tuple[str, str, str], List[_Ctx]] = {}
        for ctx in ctxs:
            by_name.setdefault(ctx.summary.name, []).append(ctx)
            if ctx.cls is not None:
                key = (ctx.path, ctx.cls.name, ctx.summary.name)
                by_class.setdefault(key, []).append(ctx)

        work: List[_Ctx] = []

        def reach(ctx: _Ctx, via: Optional[_Ctx]) -> None:
            if ctx.reached:
                return
            ctx.reached = True
            ctx.via = via
            work.append(ctx)

        for ctx in ctxs:
            if (
                ctx.cls is not None
                and ctx.path.endswith(SEED_PATH_SUFFIX)
                and REPLAY_SEED.match(ctx.summary.name)
            ):
                reach(ctx, None)
        while work:
            ctx = work.pop()
            for child in ctx.children:
                reach(child, ctx)
            for site in ctx.summary.calls:
                if site.on_self and ctx.cls is not None:
                    for tgt in by_class.get(
                        (ctx.path, ctx.cls.name, site.name), []
                    ):
                        reach(tgt, ctx)
                    continue
                if site.name in SKIP_CALL_NAMES or site.name.startswith(
                    "__"
                ):
                    continue
                for tgt in by_name.get(site.name, []):
                    reach(tgt, ctx)

    # -- checks ------------------------------------------------------------

    def _via(self, ctx: _Ctx) -> str:
        chain = ctx.chain()
        if len(chain) > 4:
            chain = chain[:2] + ["…"] + chain[-1:]
        return "reached via " + " → ".join(chain)

    def _check_ctx(self, ctx: _Ctx) -> List[Finding]:
        out: List[Finding] = []
        fn = ctx.summary.node
        via = self._via(ctx)
        if ctx.env:
            invoked = _env_invocations(fn, ctx.env)
            for attr in sorted(invoked):
                out.append(
                    Finding(
                        self.rule_id,
                        ctx.path,
                        invoked[attr],
                        0,
                        f"replay path invokes checkpoint-detached hook "
                        f"self.{attr} in {ctx.qualname} ({via}); detached "
                        f"hooks must not steer WAL replay — route the "
                        f"effect through logged state or suppress with "
                        f"the replay-safety argument",
                    )
                )
            guarded = _guarded_env_attrs(fn, ctx.env)
            flagged: Set[str] = set(invoked)
            for r in ctx.summary.reads:
                attr = r.root
                if (
                    attr not in ctx.env
                    or attr in guarded
                    or attr in flagged
                ):
                    continue
                flagged.add(attr)
                out.append(
                    Finding(
                        self.rule_id,
                        ctx.path,
                        r.line,
                        r.col,
                        f"replay-path read of checkpoint-detached env attr "
                        f"self.{attr} in {ctx.qualname} ({via}); a restored "
                        f"node sees the class default — guard the read or "
                        f"carry the value in snapshotted state",
                    )
                )
        seen_dotted: Set[str] = set()
        for site in ctx.summary.calls:
            dotted = site.dotted
            if dotted is None or dotted in seen_dotted:
                continue
            if dotted.startswith("self.") or dotted.startswith("cls."):
                continue
            if dotted.startswith(ENTROPY_PREFIXES) or dotted in ENTROPY_EXACT:
                seen_dotted.add(dotted)
                out.append(
                    Finding(
                        self.rule_id,
                        ctx.path,
                        site.line,
                        site.col,
                        f"replay-path entropy outside the logged rng "
                        f"stream: {dotted}() in {ctx.qualname} ({via}); "
                        f"replay must draw from the WAL-logged rng only",
                    )
                )
            elif (
                dotted.startswith(WALLCLOCK_PREFIXES)
                or dotted in WALLCLOCK_EXACT
            ):
                seen_dotted.add(dotted)
                out.append(
                    Finding(
                        self.rule_id,
                        ctx.path,
                        site.line,
                        site.col,
                        f"replay-path wall-clock read: {dotted}() in "
                        f"{ctx.qualname} ({via}); replay timing must be "
                        f"virtual-clock only",
                    )
                )
        return out


def replay_reach_for_testing(
    project: LintProject,
) -> Dict[str, Tuple[str, ...]]:
    """qualname -> reach chain for every reached context (test hook)."""
    rule = ReplayPurityRule()
    ctxs = rule._build_contexts(project)
    rule._propagate(ctxs)
    return {
        f"{c.path}:{c.qualname}": tuple(c.chain())
        for c in ctxs
        if c.reached
    }
