"""Tracer-safety rule: no host syncs inside jitted code or host loops.

Scope: ``hbbft_tpu_torch/engine/`` and ``hbbft_tpu_torch/ops/`` — the device layer.

Inside a jit-compiled function every array argument is a tracer; the
following force a host round-trip (``ConcretizationTypeError`` at best, a
silent per-call device sync at worst when tracing succeeds via weak
types) and are flagged:

* ``float(x)`` / ``int(x)`` / ``bool(x)`` on non-constant arguments —
  concretizes a tracer.
* ``.item()`` / ``.tolist()`` — explicit device→host transfer.
* ``np.asarray`` / ``np.array`` / ``onp.asarray`` on traced values —
  silently materializes on host (``jnp.asarray`` is the device-side
  spelling and is fine).
* ``jax.device_get`` — explicit transfer.

A function is considered jitted when it is decorated with ``@jax.jit`` /
``@partial(jax.jit, ...)`` / ``@functools.partial(jax.jit, ...)``, or its
name is passed to ``jax.jit(...)`` anywhere in the same module (the
``ops/backend.py`` ``_jitted_*`` factory idiom).  Inner ``def``\\ s of a
jitted function are jitted too.

Additionally, host-side crank loops must not sync per iteration:
``jax.device_get``/``.item()``/``.tolist()`` inside a ``for``/``while``
body is flagged even outside jit (one transfer per loop iteration is the
classic dispatch-throughput killer — batch the transfer after the loop).

PyTorch spells a host sync differently, and both rules know those
spellings too (the JAX ones stay, so one rule set reads either package):
``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``, ``.to("cpu")``
(or ``device="cpu"``), ``torch.cuda.synchronize()`` and ``.synchronize()``
on a stream or event.  A chain such as ``x.cpu().numpy()`` is one
finding, reported under its outermost call.

Static-argument hashability: calls to a function jitted with
``static_argnums`` must not pass ``list``/``dict``/``set`` literals in a
static position, and ``static_argnames`` must not receive them by
keyword — jit caches on static args by hash.

A second rule in the family, ``deferred-fetch``, guards the pipelined
dispatch seam (ops/pipeline.py): inside the dispatch layer
(``ops/backend.py`` and ``parallel/backend.py``) every device→host
fetch must route through the pipeline's single sync point
(``pipeline.fetch_to_host``), so ``np.asarray``/``numpy.asarray``/
``jax.device_get``/``.block_until_ready()`` reappearing there is
flagged — an ad-hoc fetch added next to a dispatch silently re-serializes
the host-assembly/device-execute overlap the pipeline exists to create.
(`np.array` on host literals and `jnp.asarray` staging remain fine.)
The torch spellings above are flagged there as well.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, register

_CONCRETIZERS = ("float", "int", "bool")
_SYNC_METHODS = ("item", "tolist")
_NUMPY_NAMES = ("np", "numpy", "onp")
#: torch's host-sync methods (no positional argument)
_TORCH_SYNC_METHODS = ("cpu", "numpy", "item", "tolist")


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_cpu_device(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value.split(":", 1)[0] == "cpu"
    )


def _torch_sync(call: ast.Call) -> Optional[str]:
    """The torch spelling of a host sync ``call`` is, or None:
    ``.cpu()``/``.numpy()``/``.item()``/``.tolist()``, ``.to("cpu")``,
    ``torch.cuda.synchronize()`` or ``.synchronize()``."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _TORCH_SYNC_METHODS and not call.args:
        return f".{func.attr}()"
    if func.attr == "to" and (
        (call.args and _is_cpu_device(call.args[0]))
        or any(kw.arg == "device" and _is_cpu_device(kw.value) for kw in call.keywords)
    ):
        return '.to("cpu")'
    if func.attr == "synchronize":
        if _dotted(func) == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        return ".synchronize()"
    return None


def _torch_syncs(root: ast.AST) -> List[Tuple[ast.Call, str]]:
    """Every torch host sync under ``root``, a chain (``x.cpu().numpy()``)
    once: a sync call whose result another sync call consumes is part of
    that outer call's finding."""
    found = []
    inner = set()
    for sub in ast.walk(root):
        if isinstance(sub, ast.Call) and _torch_sync(sub) is not None:
            spelling = _torch_sync(sub)
            receiver = sub.func.value
            while isinstance(receiver, ast.Call) and _torch_sync(receiver):
                inner.add(id(receiver))
                spelling = _torch_sync(receiver) + spelling
                receiver = receiver.func.value
            found.append((sub, spelling))
    return [(c, s) for c, s in found if id(c) not in inner]


def _is_jax_jit(node: ast.AST) -> bool:
    return _dotted(node) in ("jax.jit", "jit")


def _jit_call_info(call: ast.Call) -> Optional[Tuple[Optional[str], Set[int], Set[str]]]:
    """If ``call`` is ``jax.jit(target?, static_argnums=..., ...)`` return
    (target function name or None, static positions, static names)."""
    if not _is_jax_jit(call.func):
        return None
    target: Optional[str] = None
    if call.args and isinstance(call.args[0], ast.Name):
        target = call.args[0].id
    nums: Set[int] = set()
    names: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnums":
            try:
                v = ast.literal_eval(kw.value)
            except (ValueError, SyntaxError):
                continue
            nums.update([v] if isinstance(v, int) else list(v))
        elif kw.arg == "static_argnames":
            try:
                v = ast.literal_eval(kw.value)
            except (ValueError, SyntaxError):
                continue
            names.update([v] if isinstance(v, str) else list(v))
    return target, nums, names


def _decorator_jit_info(fn: ast.FunctionDef) -> Optional[Tuple[Set[int], Set[str]]]:
    """Static-arg info when ``fn`` is decorated as jitted, else None."""
    for dec in fn.decorator_list:
        if _is_jax_jit(dec):
            return set(), set()
        if isinstance(dec, ast.Call):
            if _is_jax_jit(dec.func):
                info = _jit_call_info(dec)
                if info:
                    return info[1], info[2]
                return set(), set()
            if _dotted(dec.func) in ("partial", "functools.partial"):
                if dec.args and _is_jax_jit(dec.args[0]):
                    info = _jit_call_info(
                        ast.Call(func=dec.args[0], args=[], keywords=dec.keywords)
                    )
                    if info:
                        return info[1], info[2]
                    return set(), set()
    return None


@register
class TracerSafetyRule(Rule):
    rule_id = "tracer-safety"
    # obs/: the critpath/timeseries/flight trio sits on the
    # engine's hot path (per-output stamps, per-epoch snaps) — a stray
    # device sync or device_get in a loop there would stall the pipeline
    # exactly like one in the engine
    scope = (
        "hbbft_tpu_torch/engine/",
        "hbbft_tpu_torch/ops/",
        "hbbft_tpu_torch/obs/critpath.py",
        "hbbft_tpu_torch/obs/timeseries.py",
        "hbbft_tpu_torch/obs/flight.py",
    )

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []

        # -- pass 1: which function *bodies* are traced, and which callable
        # names carry static-arg semantics.  For `alias = jax.jit(g, ...)`
        # the body is g's but the static contract lives on calls to
        # `alias`; calling raw `g` is plain Python and is exempt.
        jit_bodies: Set[str] = set()
        static_info: Dict[str, Tuple[Set[int], Set[str]]] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Call):
                    info = _jit_call_info(node.value)
                    if info:
                        if info[0] is not None:
                            jit_bodies.add(info[0])
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                static_info[t.id] = (info[1], info[2])
            elif isinstance(node, ast.Call):
                info = _jit_call_info(node)
                if info and info[0] is not None:
                    jit_bodies.add(info[0])
            elif isinstance(node, ast.FunctionDef):
                dec_info = _decorator_jit_info(node)
                if dec_info is not None:
                    jit_bodies.add(node.name)
                    static_info[node.name] = dec_info

        def emit(node: ast.AST, message: str) -> None:
            findings.append(
                Finding(self.rule_id, mod.path, node.lineno, node.col_offset, message)
            )

        # -- pass 2: host syncs inside jitted function bodies -------------
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.FunctionDef) and node.name in jit_bodies:
                self._scan_jit_body(node, emit)

        # -- pass 3: per-iteration syncs in host loops --------------------
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.For, ast.While)):
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    if _dotted(sub.func) == "jax.device_get":
                        emit(sub, "jax.device_get inside a loop; batch the transfer")
                for sub, spelling in _torch_syncs(node):
                    emit(sub, f"{spelling} inside a loop; batch the transfer")

        # -- pass 4: unhashable literals in static positions --------------
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = node.func.id if isinstance(node.func, ast.Name) else None
            if name not in static_info:
                continue
            nums, names = static_info[name]
            for i, arg in enumerate(node.args):
                if i in nums and isinstance(arg, (ast.List, ast.Dict, ast.Set)):
                    emit(
                        arg,
                        f"unhashable literal passed to static_argnums position {i} of {name}",
                    )
            for kw in node.keywords:
                if kw.arg in names and isinstance(kw.value, (ast.List, ast.Dict, ast.Set)):
                    emit(
                        kw.value,
                        f"unhashable literal passed to static arg {kw.arg!r} of {name}",
                    )
        return findings

    def _scan_jit_body(self, fn: ast.FunctionDef, emit) -> None:
        torch_syncs = {id(c): s for c, s in _torch_syncs(fn)}
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Name) and func.id in _CONCRETIZERS:
                if sub.args and not isinstance(sub.args[0], ast.Constant):
                    emit(
                        sub,
                        f"{func.id}() on a traced value inside jitted "
                        f"{fn.name}() concretizes the tracer",
                    )
            elif isinstance(func, ast.Attribute):
                dotted = _dotted(func)
                if dotted == "jax.device_get":
                    emit(sub, f"jax.device_get inside jitted {fn.name}()")
                elif func.attr in _SYNC_METHODS and not sub.args:
                    emit(sub, f".{func.attr}() inside jitted {fn.name}() is a host sync")
                elif id(sub) in torch_syncs:
                    emit(sub, f"{torch_syncs[id(sub)]} inside jitted {fn.name}() is a host sync")
                elif dotted is not None and any(
                    dotted == f"{m}.{a}"
                    for m in _NUMPY_NAMES
                    for a in ("asarray", "array")
                ):
                    emit(
                        sub,
                        f"{dotted} inside jitted {fn.name}() materializes on host; "
                        "use jnp",
                    )


@register
class DeferredFetchRule(Rule):
    """The dispatch layer's only host sync point is the deferred-fetch
    seam (ops/pipeline.py ``fetch_to_host``): flag any ``np.asarray``,
    ``jax.device_get`` or ``.block_until_ready()`` in ops/backend.py,
    parallel/backend.py, or the engine/ modules — an inline fetch there
    re-serializes the pipeline (host assembly can no longer overlap
    device execution) and bypasses the device-seconds/overlap
    attribution contract.  The engine/ scope guards the
    round-level assembly seam: the array engine now assembles round
    r+1's item lists while round r's dispatches execute, and a stray
    fetch in the engine would silently collapse that overlap too."""

    rule_id = "deferred-fetch"
    scope = (
        "hbbft_tpu_torch/ops/backend.py",
        "hbbft_tpu_torch/parallel/backend.py",
        "hbbft_tpu_torch/engine/",
        # the traffic driver and scenario harness hold engine hooks
        # (batch_listeners / contribution_source / pre_crank) that run
        # while pipeline dispatches may be in flight — a stray host fetch
        # there re-serializes the overlap exactly like one in the engine
        "hbbft_tpu_torch/traffic/driver.py",
        "hbbft_tpu_torch/net/scenarios.py",
        # the device erasure/hash plane kernels — their results
        # must flow back through the pipeline seam like every other
        # dispatch kind, so a stray fetch here is the same regression
        "hbbft_tpu_torch/ops/gf256.py",
        "hbbft_tpu_torch/ops/sha256.py",
        # the fused tower chain — its kernels/orchestration run
        # INSIDE backend dispatch graphs, so a host fetch here would
        # stall every fused_chain/rlc dispatch mid-trace
        "hbbft_tpu_torch/ops/tower_fused.py",
        "hbbft_tpu_torch/ops/pairing_chain.py",
    )

    def check_module(self, mod: ModuleSource) -> List[Finding]:
        findings: List[Finding] = []
        torch_syncs = {id(c): s for c, s in _torch_syncs(mod.tree)}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            message = None
            if dotted == "jax.device_get":
                message = "jax.device_get in the dispatch layer"
            elif dotted is not None and any(
                dotted == f"{m}.asarray" for m in _NUMPY_NAMES
            ):
                message = f"{dotted} in the dispatch layer"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "block_until_ready"
            ):
                message = ".block_until_ready() in the dispatch layer"
            elif id(node) in torch_syncs:
                message = f"{torch_syncs[id(node)]} in the dispatch layer"
            if message is not None:
                findings.append(
                    Finding(
                        self.rule_id,
                        mod.path,
                        node.lineno,
                        node.col_offset,
                        message + " — fetches must route through the "
                        "deferred-fetch seam (ops/pipeline.fetch_to_host)",
                    )
                )
        return findings
