"""seam-race: state crossing the submit/resolve boundary must be blessed.

Scope: the pipelined dispatch layer (``ops/pipeline.py``,
``ops/backend.py``) and the array engine (``engine/``) — the code the pipelined dispatch and the deferred verifies
made asynchronous.  A *submit-path* context runs between issuing a
dispatch and requesting its fetch (batch assembly, group sizing, chunk
staging); a *resolve-path* context runs when a deferred fetch delivers
(``on_result`` callbacks, returned resolvers, ``flush``/``_resolve``).
Under the bounded in-flight queue those two interleave in an order the
schedule controls, so any ``self`` attribute written on one side and
read on the other is schedule-sensitive state: its value at read time
depends on which pending dispatches have resolved.

The rule flags every such crossing.  Legal crossings carry a
``# lint: allow[seam-race] <why order cannot change observable results>``
suppression at the anchor line — making the seam inventory explicit and
reviewed (the dynamic explorer in ``analysis/schedules.py`` is the
matching runtime check).  Everything else must either ride the pipeline
API (the value travels inside the ``PendingDispatch``/``on_result``
plumbing, not ambient ``self`` state) or be write-once before submit
(assigned only in ``__init__``).

Classification is per class, name- and callgraph-based:

* submit seeds — methods named ``submit*``/``_submit*``/``dispatch*``/
  ``_dispatch*``/``*_deferred`` or whose body calls ``<x>.submit(...)``.
* resolve seeds — methods named ``resolve``/``_resolve``/``flush``/
  ``finish``/``fetch*``/``_fetch*`` or calling ``<x>.resolve()``/
  ``<x>.flush()``; nested functions/lambdas passed as ``on_result=`` or
  ``fetch=`` callbacks, named ``deliver``/``resume``/``resolve``/
  ``finish``, or returned from a submit-seeded function (deferred
  resolvers).
* tags flow caller→callee through same-class ``self.meth()`` calls to a
  fixpoint (a helper invoked while submitting is submit-path code); a
  context reachable from both sides contributes its accesses to both.

One finding per (class, attribute root): anchored at the earliest
offending access, naming a representative context on each side.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.analysis.dataflow import (
    Access,
    ClassSummary,
    FunctionSummary,
    paths_conflict,
    summarize_module,
)
from hbbft_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, register

#: the crash axis (net/crash.py) has the same two-sided shape: the LIVE
#: side (crank hooks logging the WAL/sent record, checkpointing) and the
#: RECOVERY side (_restart replaying against that record).  Live-side
#: methods seed "submit", recovery-side methods seed "resolve", so state
#: crossing checkpoint→replay is inventoried exactly like pipeline state
#: crossing submit→resolve.
SUBMIT_NAME = re.compile(
    r"(^|_)(submit|dispatch)|_deferred$|^(on_(deliver|send|input|enqueue)|_?checkpoint)"
)
RESOLVE_NAME = re.compile(r"^(resolve|_resolve|flush|finish|_?fetch|_restart|_replay)")
#: nested-callable names that identify a delivery/resolver closure
RESOLVER_NESTED = ("deliver", "resume", "resolve", "finish")
#: call kwargs that hand a closure to the pipeline as a resolve callback
CALLBACK_KWARGS = ("on_result", "fetch")


class _Context:
    """One function body (method or nested closure) with its seam tags."""

    __slots__ = ("summary", "tags", "owner_method", "parent", "is_resolver",
                 "is_returned")

    def __init__(self, summary: FunctionSummary, owner_method: str) -> None:
        self.summary = summary
        self.tags: Set[str] = set()
        self.owner_method = owner_method  # class-method name it lives under
        self.parent: Optional["_Context"] = None
        self.is_resolver = False  # callback/resolver closure
        self.is_returned = False  # returned from its enclosing function


def _seed_method(s: FunctionSummary) -> Set[str]:
    tags: Set[str] = set()
    if SUBMIT_NAME.search(s.name):
        tags.add("submit")
    if RESOLVE_NAME.search(s.name):
        tags.add("resolve")
    for site in s.calls:
        if site.name == "submit" and not site.on_self:
            tags.add("submit")
        elif site.name in ("resolve", "flush") and not site.on_self:
            tags.add("resolve")
    return tags


def _collect_contexts(cls: ClassSummary) -> List[_Context]:
    """Methods + (recursively) their nested closures, tags seeded."""
    out: List[_Context] = []

    def add_nested(parent: _Context, s: FunctionSummary) -> None:
        # only closures handed to the pipeline as DELIVERY callbacks
        # (on_result=/fetch= kwargs) are resolvers; a closure passed
        # POSITIONALLY — to a staging helper or as submit()'s launch
        # thunk — runs at submit time
        callback_names = {
            nm
            for (callee, slot, nm) in s.callbacks
            if slot in CALLBACK_KWARGS
        }
        for name, nested in s.nested.items():
            ctx = _Context(nested, parent.owner_method)
            ctx.parent = parent
            ctx.is_returned = name in s.returned_callables
            ctx.is_resolver = (
                name in callback_names or nested.name in RESOLVER_NESTED
            )
            if ctx.is_resolver:
                ctx.tags.add("resolve")
            ctx.tags |= _seed_method(nested)
            out.append(ctx)
            add_nested(ctx, nested)

    for mname, s in cls.methods.items():
        if mname == "__init__":
            continue  # construction is the write-once baseline
        ctx = _Context(s, mname)
        ctx.tags |= _seed_method(s)
        out.append(ctx)
        add_nested(ctx, s)
    return out


def _propagate(cls: ClassSummary, contexts: List[_Context]) -> None:
    """Tag flow to a fixpoint: caller→callee through same-class
    ``self.meth()`` calls, enclosing→nested for inline helpers, and
    resolver promotion for closures returned by a submit-tagged function
    (a deferred resolver)."""
    by_method: Dict[str, List[_Context]] = {}
    for ctx in contexts:
        if ctx.parent is None:
            by_method.setdefault(ctx.summary.name, []).append(ctx)
    changed = True
    while changed:
        changed = False

        def grow(ctx: _Context, tags: Set[str]) -> None:
            nonlocal changed
            new = tags - ctx.tags
            if new:
                ctx.tags |= new
                changed = True

        for ctx in contexts:
            if ctx.parent is not None:
                if ctx.is_returned and "submit" in ctx.parent.tags:
                    if not ctx.is_resolver:
                        ctx.is_resolver = True
                        grow(ctx, {"resolve"})
                if not ctx.is_resolver:
                    # inline helper: runs in the enclosing context
                    grow(ctx, ctx.parent.tags)
            if not ctx.tags:
                continue
            for site in ctx.summary.calls:
                if not site.on_self:
                    continue
                for callee in by_method.get(site.name, ()):
                    grow(callee, ctx.tags)


@register
class SeamRaceRule(Rule):
    rule_id = "seam-race"
    scope = (
        "hbbft_tpu_torch/ops/pipeline.py",
        "hbbft_tpu_torch/ops/backend.py",
        "hbbft_tpu_torch/engine/",
        "hbbft_tpu_torch/net/crash.py",
        # the mesh backend seam (ROADMAP item 1): cross-shard submit /
        # resolve ordering must hold before the pjit scale-out lands
        "hbbft_tpu_torch/parallel/",
        # the control loop's hook crossing: the traffic drivers'
        # admission/sampling methods call mempool ``submit`` (submit-
        # seeded), and any future deferred/resolver context added to the
        # tracker→controller→engine path gets inventoried here — state
        # shared between those sides must ride the hook APIs
        # (batch_size_provider / Observation), not ambient self attrs
        "hbbft_tpu_torch/traffic/driver.py",
        "hbbft_tpu_torch/control/",
        # the device erasure/hash plane — its delivery callbacks
        # (rs_enc/rs_dec/merkle dispatch kinds) must keep state in
        # closure locals, never ambient self attrs
        "hbbft_tpu_torch/ops/gf256.py",
        "hbbft_tpu_torch/ops/sha256.py",
        # the fused tower chain rides the same dispatch seam —
        # any future module-level mutable routing state (caches, mode
        # latches) shared with delivery callbacks gets inventoried here
        "hbbft_tpu_torch/ops/tower_fused.py",
        "hbbft_tpu_torch/ops/pairing_chain.py",
    )

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        summary = summarize_module(mod)
        for cls in summary.classes.values():
            findings.extend(self._check_class(mod, cls))
        return findings

    def _check_class(self, mod: ModuleSource, cls: ClassSummary) -> List[Finding]:
        contexts = _collect_contexts(cls)
        _propagate(cls, contexts)
        method_names = set(cls.methods)

        # accesses per seam side: (path, line, col, context qualname)
        sides: Dict[str, Dict[str, List[Tuple[Access, str]]]] = {
            "submit": {"read": [], "write": []},
            "resolve": {"read": [], "write": []},
        }
        for ctx in contexts:
            for tag in ctx.tags:
                for acc in ctx.summary.reads:
                    if acc.root in method_names:
                        continue  # bound-method reference, not state
                    sides[tag]["read"].append((acc, ctx.summary.qualname))
                for acc in ctx.summary.writes:
                    sides[tag]["write"].append((acc, ctx.summary.qualname))

        findings: List[Finding] = []
        seen_roots: Set[str] = set()
        # deterministic: iterate submit-side accesses in source order
        ordered = sorted(
            [(a, q, "write") for a, q in sides["submit"]["write"]]
            + [(a, q, "read") for a, q in sides["submit"]["read"]],
            key=lambda t: (t[0].line, t[0].col, t[0].path),
        )
        for acc, qual, kind in ordered:
            if acc.root in seen_roots:
                continue
            other_kind = "read" if kind == "write" else "write"
            # a partner in the SAME context is a sync point's own
            # sequential access pattern, not a seam crossing — require
            # the two sides to live in different function bodies
            partners = sorted(
                (
                    (b, bq)
                    for b, bq in sides["resolve"][other_kind]
                    if bq != qual and paths_conflict(acc.path, b.path)
                ),
                key=lambda t: (t[0].line, t[0].col),
            )
            if not partners:
                continue
            partner, partner_qual = partners[0]
            seen_roots.add(acc.root)
            if kind == "write":
                msg = (
                    f"self.{acc.root} is written on the submit path "
                    f"({qual}) and read on the resolve path ({partner_qual})"
                )
            else:
                msg = (
                    f"self.{acc.root} is read on the submit path ({qual}) "
                    f"and written on the resolve path ({partner_qual})"
                )
            findings.append(
                Finding(
                    self.rule_id,
                    mod.path,
                    acc.line,
                    acc.col,
                    msg
                    + "; seam-crossing state must ride the pipeline API "
                    "(on_result/PendingDispatch) or be write-once before "
                    "submit",
                )
            )
        return findings


def seam_contexts_for_testing(
    mod: ModuleSource, class_name: str
) -> Dict[str, Set[str]]:
    """Expose the per-context tag classification (tests + docs)."""
    summary = summarize_module(mod)
    cls = summary.classes[class_name]
    contexts = _collect_contexts(cls)
    _propagate(cls, contexts)
    return {c.summary.qualname: set(c.tags) for c in contexts}
