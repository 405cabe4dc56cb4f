"""Byzantine-input discipline: remote input faults, never raises.

Scope: ``hbbft_tpu_torch/protocols/`` plus the adversary/scenario harness
(``hbbft_tpu_torch/net/adversary.py``, ``hbbft_tpu_torch/net/scenarios.py``).  A
remote peer controls every byte that reaches a
``handle_*(self, sender_id, ...)`` entry point.  Two contracts:

* **No raising on remote input.** A malformed message is *evidence*
  (``Step.from_fault`` / ``PartOutcome(fault=...)``), not an exception —
  an uncaught exception from one crafted message is a remote crash of the
  replica (the cheapest possible Byzantine attack).  Any ``raise`` inside
  a remote-input handler is flagged; programming-error asserts belong in
  internal helpers, not on the network boundary.

* **Membership before state writes.** A handler must check the sender
  against the validator set (``node_index``/``is_node_validator``/
  ``in``-membership) before mutating ``self`` state, otherwise any
  non-member can grow per-sender maps or future-message queues without
  bound (memory DoS) or influence quorum counts.

The membership check is interprocedural ONE call level deep:
when a handler passes its sender parameter into a same-class helper
before any membership check, the helper body is scanned with the
argument mapped onto its parameter — a helper that itself checks
membership (or runs a ``*valid*``-named validation call on the sender)
*credits* the handler, and a helper that writes ``self`` state without
either is flagged at its write site, attributed through the calling
handler.  Helpers that are themselves remote handlers are scanned
independently, not re-entered.  Remote handlers are methods named
``handle_*`` whose parameter list includes ``sender_id`` or ``sender``
— matching ``ConsensusProtocol.handle_message`` and the SyncKeyGen
``handle_part``/``handle_ack`` family; ``handle_input`` (local input,
trusted embedder) is deliberately out of scope.

In the net/ harness scope the same discipline applies to the adversary
hook surface (``tamper`` / ``pre_crank`` / ``on_send``): a tamper hook
sees every message shape the protocols can emit — including shapes a
*different* adversary already mangled — so it must pass unknown payloads
through rather than raise (an attack harness that crashes on malformed
state can't compose into the scenario matrix), and it must not
dereference into ``msg.payload`` internals without an ``isinstance``
guard (the structural analogue of the sender-membership check).

In the traffic scope (``hbbft_tpu_torch/traffic/``) the client-facing submit
surface (``submit*`` methods) carries the analogous contract: a client
controls every byte of a submitted transaction, so the method must call
a validation helper (a ``*valid*``-named callable — the mempool's
shape/size check) BEFORE the first ``self`` state write, and a bad
transaction is an admission outcome, never an escaping raise.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from hbbft_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, register

_SENDER_PARAMS = ("sender_id", "sender")
_MEMBERSHIP_CALLS = ("node_index", "is_node_validator", "is_validator", "senders")
_MUTATING_METHODS = (
    "append",
    "add",
    "insert",
    "extend",
    "setdefault",
    "update",
    "pop",
    "popitem",
    "clear",
    "remove",
    "discard",
    "push",
)


def _sender_param(fn: ast.FunctionDef) -> Optional[str]:
    names = [a.arg for a in fn.args.args]
    for p in _SENDER_PARAMS:
        if p in names:
            return p
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_state_write(node: ast.AST) -> bool:
    """Does this statement/expression mutate ``self`` state?"""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)) and _root_name(t) == "self":
                return True
        return False
    if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        call = node.value
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _MUTATING_METHODS
            and _root_name(call.func.value) == "self"
        ):
            return True
    return False


def _mentions_membership_check(node: ast.AST, sender: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            # The check must be about the *sender*: `self.netinfo.
            # is_validator()` (our own membership) does not qualify.
            arg_names = {a.id for a in sub.args if isinstance(a, ast.Name)}
            if sub.func.attr in _MEMBERSHIP_CALLS and sender in arg_names:
                return True
            # index-map lookup idiom: `self.index.get(sender_id)`
            if sub.func.attr == "get" and sender in arg_names:
                return True
        if isinstance(sub, ast.Compare):
            if any(isinstance(op, (ast.In, ast.NotIn)) for op in sub.ops):
                if isinstance(sub.left, ast.Name) and sub.left.id == sender:
                    return True
    return False


#: adversary/scenario/crash hook surface checked in the net/ scope —
#: the crash axis's crank hooks (net/crash.py) carry the same contract:
#: a recovery failure becomes an attributed fault, never an exception
#: out of the crank loop
_HOOK_NAMES = (
    "tamper",
    "pre_crank",
    "on_send",
    "on_crank",
    "on_idle",
    "on_deliver",
    "on_input",
    "on_enqueue",
    "after_crank",
)
_NET_SCOPE = (
    "hbbft_tpu_torch/net/adversary.py",
    "hbbft_tpu_torch/net/scenarios.py",
    "hbbft_tpu_torch/net/crash.py",
)
#: client-facing admission surface checked in the traffic scope
_TRAFFIC_SCOPE = "hbbft_tpu_torch/traffic/"


def _is_validation_call(node: ast.AST) -> bool:
    """A call whose target name contains ``valid`` (``self._validate``,
    ``default_validate``, …) — the admission-layer shape check."""
    if not isinstance(node, ast.Call):
        return False
    fname = None
    if isinstance(node.func, ast.Name):
        fname = node.func.id
    elif isinstance(node.func, ast.Attribute):
        fname = node.func.attr
    return fname is not None and "valid" in fname.lower()


@register
class ByzantineInputRule(Rule):
    rule_id = "byzantine-input"
    scope = ("hbbft_tpu_torch/protocols/",) + _NET_SCOPE + (_TRAFFIC_SCOPE,)

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        in_net_scope = mod.path in _NET_SCOPE
        in_traffic_scope = mod.path.startswith(_TRAFFIC_SCOPE)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            methods = {
                f.name: f for f in node.body if isinstance(f, ast.FunctionDef)
            }
            seen_helper_writes: set = set()
            for fn in node.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                if in_net_scope and fn.name in _HOOK_NAMES:
                    findings.extend(self._check_hook(mod, node.name, fn))
                    continue
                if in_traffic_scope and fn.name.startswith("submit"):
                    findings.extend(self._check_submit(mod, node.name, fn))
                    continue
                if not fn.name.startswith("handle_") or fn.name == "handle_input":
                    continue
                sender = _sender_param(fn)
                if sender is None:
                    continue
                findings.extend(
                    self._check_handler(
                        mod, node.name, fn, sender, methods, seen_helper_writes
                    )
                )
        return findings

    def _check_submit(
        self, mod: ModuleSource, cls: str, fn: ast.FunctionDef
    ) -> List[Finding]:
        """Client-facing admission contract: validate before the first
        self-state write, and never raise on a submitted transaction."""
        findings: List[Finding] = []
        for sub in self._escaping_raises(fn):
            findings.append(
                Finding(
                    self.rule_id,
                    mod.path,
                    sub.lineno,
                    sub.col_offset,
                    f"{cls}.{fn.name} raises on client input; return an "
                    "admission outcome instead",
                )
            )
        validated = False
        for stmt in self._linear_statements(fn):
            if not validated and any(
                _is_validation_call(sub) for sub in ast.walk(stmt)
            ):
                validated = True
            if _is_state_write(stmt) and not validated:
                findings.append(
                    Finding(
                        self.rule_id,
                        mod.path,
                        stmt.lineno,
                        stmt.col_offset,
                        f"{cls}.{fn.name} writes state before validating "
                        "the submitted transaction",
                    )
                )
                break
        return findings

    def _check_hook(
        self, mod: ModuleSource, cls: str, fn: ast.FunctionDef
    ) -> List[Finding]:
        """Adversary-hook contract: never raise (malformed or foreign
        message shapes pass through), and don't reach past ``.payload``
        into message internals without an isinstance guard somewhere in
        the hook (tamper surgery must be type-checked)."""
        findings: List[Finding] = []
        for sub in self._escaping_raises(fn):
            findings.append(
                Finding(
                    self.rule_id,
                    mod.path,
                    sub.lineno,
                    sub.col_offset,
                    f"{cls}.{fn.name} raises inside an adversary hook; "
                    "pass unrecognized messages through instead",
                )
            )
        has_guard = any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id in ("isinstance", "locate_inner", "classify_inner")
            for sub in ast.walk(fn)
        )
        if not has_guard:
            for sub in ast.walk(fn):
                if (
                    isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Attribute)
                    and sub.value.attr == "payload"
                ):
                    findings.append(
                        Finding(
                            self.rule_id,
                            mod.path,
                            sub.lineno,
                            sub.col_offset,
                            f"{cls}.{fn.name} dereferences .payload internals "
                            "without an isinstance/locate_inner guard",
                        )
                    )
                    break
        return findings

    def _check_handler(
        self,
        mod: ModuleSource,
        cls: str,
        fn: ast.FunctionDef,
        sender: str,
        methods: Optional[dict] = None,
        seen_helper_writes: Optional[set] = None,
    ) -> List[Finding]:
        if seen_helper_writes is None:
            seen_helper_writes = set()
        findings: List[Finding] = []
        for sub in self._escaping_raises(fn):
            findings.append(
                Finding(
                    self.rule_id,
                    mod.path,
                    sub.lineno,
                    sub.col_offset,
                    f"{cls}.{fn.name} raises on remote input; "
                    "return a FaultLog entry instead",
                )
            )

        # Statement-ordered scan: first self-state write must be preceded
        # by a sender-membership check somewhere earlier in the body.
        # Interprocedural (one level): a pre-check delegation that passes
        # the sender into a same-class helper is followed — a helper that
        # itself checks membership credits the handler; one that writes
        # self state without a check is flagged at its write site.
        checked = False
        for stmt in self._linear_statements(fn):
            if not checked and _mentions_membership_check(stmt, sender):
                checked = True
            if not checked and methods is not None:
                verdict = self._follow_delegations(
                    mod, cls, fn, stmt, sender, methods,
                    seen_helper_writes, findings,
                )
                if verdict:
                    checked = True
            if _is_state_write(stmt) and not checked:
                findings.append(
                    Finding(
                        self.rule_id,
                        mod.path,
                        stmt.lineno,
                        stmt.col_offset,
                        f"{cls}.{fn.name} writes state before checking "
                        f"{sender} membership",
                    )
                )
                break
        return findings

    def _follow_delegations(
        self, mod, cls, fn, stmt, sender, methods, seen, findings
    ) -> bool:
        """Scan ``stmt`` for same-class calls forwarding ``sender``; check
        each target helper one level deep.  Returns True when some helper
        performs the membership check (credits the caller)."""
        credited = False
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if not (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
            ):
                continue
            helper = methods.get(func.attr)
            if helper is None or helper is fn:
                continue
            if helper.name.startswith("handle_") and _sender_param(helper):
                continue  # a remote handler itself: scanned independently
            mapped = self._mapped_param(sub, helper, sender)
            if mapped is None:
                continue
            # Statement-ordered, like the handler scan itself: a helper
            # write BEFORE the helper's check is still unguarded — the
            # check must dominate the write on the linear path.
            h_checked = False
            for h_stmt in self._linear_statements(helper):
                if not h_checked and (
                    _mentions_membership_check(h_stmt, mapped)
                    or self._validates_name(h_stmt, mapped)
                ):
                    h_checked = True
                if _is_state_write(h_stmt) and not h_checked:
                    key = (helper.name, h_stmt.lineno)
                    if key not in seen:
                        seen.add(key)
                        findings.append(
                            Finding(
                                self.rule_id,
                                mod.path,
                                h_stmt.lineno,
                                h_stmt.col_offset,
                                f"{cls}.{helper.name} writes state on "
                                f"sender-controlled input without checking "
                                f"{mapped} membership (reached from "
                                f"{cls}.{fn.name} before its own check)",
                            )
                        )
                    break
            if h_checked:
                credited = True
        return credited

    @staticmethod
    def _mapped_param(call: ast.Call, helper: ast.FunctionDef, sender: str):
        """The helper parameter that receives the caller's ``sender``
        argument, or None when the sender is not forwarded."""
        params = [a.arg for a in helper.args.args]
        if params and params[0] == "self":
            params = params[1:]
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Name) and a.id == sender and i < len(params):
                return params[i]
        for kw in call.keywords:
            if (
                isinstance(kw.value, ast.Name)
                and kw.value.id == sender
                and kw.arg in params
            ):
                return kw.arg
        return None

    @staticmethod
    def _validates_name(stmt: ast.AST, name: str) -> bool:
        """A ``*valid*``-named call receiving ``name`` — the dominating
        validation call the interprocedural contract accepts."""
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Call) or not _is_validation_call(sub):
                continue
            arg_names = {a.id for a in sub.args if isinstance(a, ast.Name)}
            arg_names |= {
                kw.value.id
                for kw in sub.keywords
                if isinstance(kw.value, ast.Name)
            }
            if name in arg_names:
                return True
        return False

    @classmethod
    def _escaping_raises(cls, node: ast.AST, in_try: bool = False):
        """Raise nodes not enclosed by a ``try`` with except handlers —
        the ``raise``-then-convert-to-fault idiom inside a local try/except
        (sync_key_gen validation) is legal; an escaping raise is not."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Raise):
                if not in_try:
                    yield child
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scope: only called, not part of this body
            if isinstance(child, ast.Try) and child.handlers:
                for grand in child.body + child.orelse:
                    yield from cls._escaping_raises(grand, in_try=True)
                # except/finally bodies propagate outward
                for handler in child.handlers:
                    for grand in handler.body:
                        yield from cls._escaping_raises(grand, in_try=in_try)
                for grand in child.finalbody:
                    yield from cls._escaping_raises(grand, in_try=in_try)
            else:
                yield from cls._escaping_raises(child, in_try=in_try)

    @staticmethod
    def _linear_statements(fn: ast.FunctionDef):
        """Statements in source order, descending into control flow."""
        stack = list(reversed(fn.body))
        while stack:
            stmt = stack.pop()
            yield stmt
            for field in ("body", "orelse", "finalbody"):
                for child in reversed(getattr(stmt, field, [])):
                    stack.append(child)
            for handler in getattr(stmt, "handlers", []):
                for child in reversed(handler.body):
                    stack.append(child)
