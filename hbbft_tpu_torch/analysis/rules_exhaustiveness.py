"""Handler-exhaustiveness rule: wire variants ↔ ``handle_message`` dispatch.

The wire codec (``hbbft_tpu_torch/utils/wire.py``) declares the full message
hierarchy in ``WIRE_VARIANTS``.  Every variant a peer can legally put on
the wire must be dispatched somewhere in the owning protocol's handler
class, and every kind string the handler dispatches on must exist on the
wire — otherwise one of two drift bugs has happened:

* **unhandled variant** — the codec decodes it, the protocol silently
  mis-files it (usually into an ``unknown_kind`` fault against an honest
  peer, which is itself a safety hazard: correct nodes must never accuse
  each other).
* **orphaned kind** — the handler dispatches on a kind the codec can
  never deliver; dead code that hides a missing wire registration.

Convention this rule relies on (documented here, checked by the tests):
handler classes compare the *message parameter*, named ``message`` or
``msg``, via ``message.kind == "..."`` or ``message.kind in (...)``.
Comparisons on other receivers (e.g. ``out.kind`` for protocol outputs)
are deliberately ignored.

The rule also drift-checks ``WIRE_VARIANTS`` against the codec itself:
every registered class must appear in an ``isinstance`` test in
``_to_tree``, and every registered tag/kind must occur as a string
literal in the module.

The same discipline covers fault kinds: ``core/fault_log.py`` declares
the full ``FAULT_KINDS`` registry, and this rule cross-checks it both
ways — every ``"prefix:name"`` literal a protocol module emits must be
registered, every registered kind must still be emitted by its protocol
module, and every fault kind the scenario harness (net/scenarios.py)
*expects* an attack to plant must exist in the registry.  Adding a fault
kind (or an attack expectation) without updating the registry breaks
lint and the scenario tests together — by design.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.analysis.engine import Finding, LintProject, ModuleSource, Rule, register

WIRE_PATH = "hbbft_tpu_torch/utils/wire.py"
FAULT_LOG_PATH = "hbbft_tpu_torch/core/fault_log.py"
SCENARIOS_PATH = "hbbft_tpu_torch/net/scenarios.py"

#: the canonical shape of a namespaced fault kind ("broadcast:multiple_echos")
FAULT_KIND_RE = re.compile(r"^[a-z][a-z_0-9]*:[a-z][a-z_0-9]*$")

#: fault-kind namespace prefix -> protocol module that emits it (the
#: unused-kind direction of the cross-check is gated per prefix on its
#: module being loaded, so --diff partial runs stay quiet)
FAULT_PREFIX_MODULES: Dict[str, str] = {
    "binary_agreement": "hbbft_tpu_torch/protocols/binary_agreement.py",
    "broadcast": "hbbft_tpu_torch/protocols/broadcast.py",
    # the crash/restart axis emits outside protocols/ — the emitted-kind
    # scan below covers every owner module, wherever it lives
    "crash": "hbbft_tpu_torch/net/crash.py",
    "dynamic_honey_badger": "hbbft_tpu_torch/protocols/dynamic_honey_badger.py",
    "honey_badger": "hbbft_tpu_torch/protocols/honey_badger.py",
    "sbv": "hbbft_tpu_torch/protocols/sbv_broadcast.py",
    "sender_queue": "hbbft_tpu_torch/protocols/sender_queue.py",
    "subset": "hbbft_tpu_torch/protocols/subset.py",
    "sync_key_gen": "hbbft_tpu_torch/protocols/sync_key_gen.py",
    "threshold_decrypt": "hbbft_tpu_torch/protocols/threshold_decrypt.py",
    "threshold_sign": "hbbft_tpu_torch/protocols/threshold_sign.py",
}

#: message class -> (module path, handler class) owning its dispatch
HANDLERS: Dict[str, Tuple[str, str]] = {
    "SbvMessage": ("hbbft_tpu_torch/protocols/sbv_broadcast.py", "SbvBroadcast"),
    "BroadcastMessage": ("hbbft_tpu_torch/protocols/broadcast.py", "Broadcast"),
    "BaMessage": ("hbbft_tpu_torch/protocols/binary_agreement.py", "BinaryAgreement"),
    "SubsetMessage": ("hbbft_tpu_torch/protocols/subset.py", "Subset"),
    "HbMessage": ("hbbft_tpu_torch/protocols/honey_badger.py", "HoneyBadger"),
    "SqMessage": ("hbbft_tpu_torch/protocols/sender_queue.py", "SenderQueue"),
}

_MSG_PARAM_NAMES = ("message", "msg")


def _load_wire_variants(tree: ast.AST) -> Optional[Dict[str, Tuple[str, Tuple[str, ...]]]]:
    """Extract the WIRE_VARIANTS literal from wire.py's AST (no import)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "WIRE_VARIANTS":
                    try:
                        value = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return None
                    return {
                        cls: (tag, tuple(kinds))
                        for cls, (tag, kinds) in value.items()
                    }
    return None


def _kind_literals_for_class(tree: ast.AST, class_name: str) -> Tuple[Set[str], int]:
    """Kind strings compared against ``message.kind``/``msg.kind`` inside
    ``class_name``, plus the class's definition line."""
    kinds: Set[str] = set()
    class_line = 1
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            class_line = node.lineno
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Compare):
                    continue
                left = sub.left
                if not (
                    isinstance(left, ast.Attribute)
                    and left.attr == "kind"
                    and isinstance(left.value, ast.Name)
                    and left.value.id in _MSG_PARAM_NAMES
                ):
                    continue
                for op, comparator in zip(sub.ops, sub.comparators):
                    if isinstance(op, (ast.Eq, ast.NotEq)) and isinstance(
                        comparator, ast.Constant
                    ):
                        if isinstance(comparator.value, str):
                            kinds.add(comparator.value)
                    elif isinstance(op, (ast.In, ast.NotIn)) and isinstance(
                        comparator, (ast.Tuple, ast.List, ast.Set)
                    ):
                        for elt in comparator.elts:
                            if isinstance(elt, ast.Constant) and isinstance(
                                elt.value, str
                            ):
                                kinds.add(elt.value)
    return kinds, class_line


def _isinstance_classes(tree: ast.AST, func_name: str) -> Set[str]:
    """Class names tested via isinstance(...) inside function ``func_name``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func_name:
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "isinstance"
                    and len(sub.args) == 2
                ):
                    cls = sub.args[1]
                    if isinstance(cls, ast.Name):
                        out.add(cls.id)
    return out


def _load_fault_kinds(tree: ast.AST) -> Optional[Dict[str, Tuple[str, ...]]]:
    """Extract the FAULT_KINDS literal from fault_log.py's AST (no import)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "FAULT_KINDS":
                    try:
                        value = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return None
                    return {
                        prefix: tuple(names) for prefix, names in value.items()
                    }
    return None


def _fault_kind_literals(mod: ModuleSource) -> Dict[str, int]:
    """Every ``prefix:name``-shaped string constant in the module -> its
    first line number (docstrings can't match the shape: a full kind
    string has no spaces)."""
    out: Dict[str, int] = {}
    for node in ast.walk(mod.tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and FAULT_KIND_RE.match(node.value)
        ):
            out.setdefault(node.value, node.lineno)
    return out


@register
class HandlerExhaustivenessRule(Rule):
    rule_id = "handler-exhaustiveness"
    scope = ("hbbft_tpu_torch/",)

    def check_project(self, project: LintProject) -> List[Finding]:
        findings = self._check_fault_kinds(project)
        wire = project.module(WIRE_PATH)
        if wire is None:
            return findings  # partial run (--diff) without wire.py: skip
        variants = _load_wire_variants(wire.tree)
        if variants is None:
            return [
                Finding(
                    self.rule_id,
                    WIRE_PATH,
                    1,
                    0,
                    "WIRE_VARIANTS registry missing or not a literal",
                )
            ]

        # -- registry ↔ codec drift ---------------------------------------
        codec_classes = _isinstance_classes(wire.tree, "_to_tree")
        # String literals outside the registry itself — the registry's own
        # entries must not satisfy their own presence check.
        registry_nodes = set()
        for node in ast.walk(wire.tree):
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "WIRE_VARIANTS"
                for t in node.targets
            ):
                registry_nodes = {id(sub) for sub in ast.walk(node)}
        wire_strings = {
            n.value
            for n in ast.walk(wire.tree)
            if isinstance(n, ast.Constant)
            and isinstance(n.value, str)
            and id(n) not in registry_nodes
        }
        for cls, (tag, kinds) in sorted(variants.items()):
            if cls not in codec_classes:
                findings.append(
                    Finding(
                        self.rule_id,
                        WIRE_PATH,
                        1,
                        0,
                        f"registered class {cls} is never encoded by _to_tree",
                    )
                )
            for lit in (tag, *kinds):
                if lit not in wire_strings:
                    findings.append(
                        Finding(
                            self.rule_id,
                            WIRE_PATH,
                            1,
                            0,
                            f"registered variant {cls}:{lit!r} does not appear in the wire codec",
                        )
                    )
        for cls in sorted(codec_classes - set(variants)):
            if cls in ("WireError",):
                continue
            findings.append(
                Finding(
                    self.rule_id,
                    WIRE_PATH,
                    1,
                    0,
                    f"class {cls} encoded by _to_tree but missing from WIRE_VARIANTS",
                )
            )

        # -- registry ↔ handler dispatch -----------------------------------
        for cls, (path, handler_cls) in sorted(HANDLERS.items()):
            reg = variants.get(cls)
            if reg is None:
                findings.append(
                    Finding(
                        self.rule_id,
                        WIRE_PATH,
                        1,
                        0,
                        f"handler mapping for {cls} has no WIRE_VARIANTS entry",
                    )
                )
                continue
            _tag, kinds = reg
            if not kinds:
                continue  # single-variant message: nothing to dispatch on
            mod = project.module(path)
            if mod is None:
                continue  # partial run without the handler module
            handled, class_line = _kind_literals_for_class(mod.tree, handler_cls)
            for k in sorted(set(kinds) - handled):
                findings.append(
                    Finding(
                        self.rule_id,
                        path,
                        class_line,
                        0,
                        f"{handler_cls} does not dispatch wire variant {cls}:{k!r}",
                    )
                )
            for k in sorted(handled - set(kinds)):
                findings.append(
                    Finding(
                        self.rule_id,
                        path,
                        class_line,
                        0,
                        f"{handler_cls} dispatches {cls}:{k!r} which no wire variant delivers",
                    )
                )
        return findings

    def _check_fault_kinds(self, project: LintProject) -> List[Finding]:
        """FAULT_KINDS registry ↔ emitted fault-kind literals, both ways,
        plus the scenario harness's attack expectations."""
        findings: List[Finding] = []
        fault_log = project.module(FAULT_LOG_PATH)
        if fault_log is None:
            return findings  # partial run without the registry: skip
        registry = _load_fault_kinds(fault_log.tree)
        if registry is None:
            return [
                Finding(
                    self.rule_id,
                    FAULT_LOG_PATH,
                    1,
                    0,
                    "FAULT_KINDS registry missing or not a literal",
                )
            ]
        registered: Set[str] = {
            f"{prefix}:{name}"
            for prefix, names in sorted(registry.items())
            for name in names
        }

        # every emitted literal must be registered
        emitted: Dict[str, Set[str]] = {}  # kind -> modules emitting it
        emitter_paths = set(FAULT_PREFIX_MODULES.values())
        for path in sorted(project.modules):
            if (
                not path.startswith("hbbft_tpu_torch/protocols/")
                and path not in emitter_paths
            ):
                continue
            mod = project.modules[path]
            for kind, line in sorted(_fault_kind_literals(mod).items()):
                emitted.setdefault(kind, set()).add(path)
                if kind not in registered:
                    findings.append(
                        Finding(
                            self.rule_id,
                            path,
                            line,
                            0,
                            f"fault kind {kind!r} is not registered in "
                            "core/fault_log.FAULT_KINDS",
                        )
                    )

        # every registered kind must still be emitted by its module
        for prefix, names in sorted(registry.items()):
            owner = FAULT_PREFIX_MODULES.get(prefix)
            if owner is None:
                findings.append(
                    Finding(
                        self.rule_id,
                        FAULT_LOG_PATH,
                        1,
                        0,
                        f"fault-kind prefix {prefix!r} has no owning module "
                        "in FAULT_PREFIX_MODULES",
                    )
                )
                continue
            if project.module(owner) is None:
                continue  # partial run without the emitter: skip
            for name in sorted(names):
                kind = f"{prefix}:{name}"
                if kind not in emitted:
                    findings.append(
                        Finding(
                            self.rule_id,
                            FAULT_LOG_PATH,
                            1,
                            0,
                            f"registered fault kind {kind!r} is emitted by "
                            "no protocol module",
                        )
                    )

        # scenario expectations must be registered kinds
        scenarios = project.module(SCENARIOS_PATH)
        if scenarios is not None:
            for kind, line in sorted(_fault_kind_literals(scenarios).items()):
                if kind not in registered:
                    findings.append(
                        Finding(
                            self.rule_id,
                            SCENARIOS_PATH,
                            line,
                            0,
                            f"scenario expects unregistered fault kind {kind!r}",
                        )
                    )
        return findings
