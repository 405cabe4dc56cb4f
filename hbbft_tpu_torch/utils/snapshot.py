"""Checkpoint/resume: serialize a live protocol node, restore it elsewhere
— the port's copy of the JAX package's ``utils/snapshot.py``.

The reference keeps every protocol state type serde-serializable so an
embedder can persist a node and resume it (SURVEY.md §5 checkpoint row:
"all message/state types are serde-serializable, so embedders can
persist"; `JoinPlan` § is the built-in era snapshot).  This module is that
capability for the whole stack: :func:`save_node` walks a protocol
instance's object graph down to primitives and crypto elements and emits
canonical bytes (utils/canonical.py — the same no-code-exec discipline as
the wire layer, NOT pickle); :func:`load_node` rebuilds an equivalent
instance that continues the protocol deterministically.

Scope and semantics:

* **Quiescent points only.** Deferred :class:`~hbbft_tpu_torch.core.types.
  CryptoWork` items carry result callbacks (closures) and live in Steps,
  never in protocol instance state — so a node is snapshotable whenever no
  Step of its own is outstanding, i.e. between cranks once the round's
  crypto barrier has resolved.  :func:`save_node` refuses objects holding
  callables anywhere in their state, turning a violated assumption into an
  immediate error instead of a silently-wrong checkpoint.
  ``ArrayHoneyBadgerNet.checkpoint`` flushes the backend's pipeline before
  it saves.
* **The crypto backend is environment, not state.** Backends (device
  handles, compiled-kernel caches) and their stateless ``Group`` objects
  are encoded as placeholders; :func:`load_node` re-attaches the backend
  the caller provides.  Everything consensus-visible — key material,
  counters, RNG state, buffered messages, per-instance sub-protocol
  state — rides in the snapshot.
* **Shared mutable state stays shared.** The encoder memoizes every
  non-primitive node: the single ``random.Random`` the builders thread
  through all layers (SURVEY.md §4 determinism requirement) is serialized
  once and re-shared on restore, so a restored node's future coin flips and
  transaction samples match the original's exactly.  Cycles are handled
  the same way.

Security note: decoding instantiates only classes from the fixed registry
below (framework state types), sets attributes by name, and never executes
embedded code — malformed input raises :class:`SnapshotError`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hbbft_tpu_torch.utils import canonical


class SnapshotError(ValueError):
    """Malformed snapshot bytes or unsnapshotable state."""


# ---------------------------------------------------------------------------
# Class registry: every type allowed to appear in a snapshot.  Collected by
# module so new state dataclasses register automatically; decode rejects
# anything else.
# ---------------------------------------------------------------------------

_STATE_MODULES = (
    "hbbft_tpu_torch.core.types",
    "hbbft_tpu_torch.core.fault_log",
    "hbbft_tpu_torch.core.network_info",
    "hbbft_tpu_torch.crypto.keys",
    "hbbft_tpu_torch.crypto.poly",
    "hbbft_tpu_torch.crypto.merkle",
    "hbbft_tpu_torch.crypto.erasure",
    "hbbft_tpu_torch.protocols.bool_set",
    "hbbft_tpu_torch.protocols.broadcast",
    "hbbft_tpu_torch.protocols.sbv_broadcast",
    "hbbft_tpu_torch.protocols.binary_agreement",
    "hbbft_tpu_torch.protocols.threshold_sign",
    "hbbft_tpu_torch.protocols.threshold_decrypt",
    "hbbft_tpu_torch.protocols.subset",
    "hbbft_tpu_torch.protocols.honey_badger",
    "hbbft_tpu_torch.protocols.change",
    "hbbft_tpu_torch.protocols.votes",
    "hbbft_tpu_torch.protocols.sync_key_gen",
    "hbbft_tpu_torch.protocols.dynamic_honey_badger",
    "hbbft_tpu_torch.protocols.transaction_queue",
    "hbbft_tpu_torch.engine.array_engine",
    "hbbft_tpu_torch.protocols.queueing_honey_badger",
    "hbbft_tpu_torch.protocols.sender_queue",
    "hbbft_tpu_torch.utils.metrics",
    # Whole-network checkpoint: VirtualNet + Node + NetMessage + adversaries,
    # so an entire simulation (nodes, in-flight queue, shared RNG) resumes
    # deterministically from bytes.
    "hbbft_tpu_torch.net.virtual_net",
    "hbbft_tpu_torch.net.adversary",
    # crash axis: schedules, per-node tracks (checkpoint blobs, WALs,
    # parked traffic) — a whole-net snapshot taken mid-outage resumes
    # with the outage intact
    "hbbft_tpu_torch.net.crash",
    # control plane: the SLO spec, the adaptive batch controller (its B
    # trace, hysteresis counters, and rng are replay state), and load
    # traces — a soak resumed mid-run continues the same control law
    "hbbft_tpu_torch.control.slo",
    "hbbft_tpu_torch.control.controller",
    "hbbft_tpu_torch.control.trace",
)

_registry_cache: Optional[Dict[str, type]] = None


def _registry() -> Dict[str, type]:
    global _registry_cache
    if _registry_cache is None:
        import importlib
        import inspect

        reg: Dict[str, type] = {}
        for modname in _STATE_MODULES:
            mod = importlib.import_module(modname)
            for name, cls in inspect.getmembers(mod, inspect.isclass):
                if cls.__module__ != modname:
                    continue  # re-export, owned elsewhere
                reg[f"{modname}:{name}"] = cls
        _registry_cache = reg
    return _registry_cache


def _class_tag(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _state_attrs(obj: Any) -> List[Tuple[str, Any]]:
    """All instance attributes, whether slot- or dict-backed (or both).

    Walks the full ``__slots__`` chain (bases like ``typing.Generic``
    contribute none — that must not force the dict path) and merges any
    instance ``__dict__`` on top, so hybrid classes (slotted dataclass over
    a dict-backed base) serialize completely.  Sorted for determinism.

    Attributes named in the class's ``_SNAPSHOT_ENV_ATTRS`` are dropped:
    they hold environment (live observer callables, attached drivers —
    e.g. QueueingHoneyBadger.sample_listener, VirtualNet.traffic), not
    consensus state, and restore falls back to the class default exactly
    like the backend/tracer contract.
    """
    env = getattr(type(obj), "_SNAPSHOT_ENV_ATTRS", ())
    attrs: Dict[str, Any] = {}
    for c in reversed(type(obj).__mro__):
        s = c.__dict__.get("__slots__")
        if not s:
            continue
        for name in [s] if isinstance(s, str) else s:
            if name in ("__dict__", "__weakref__"):
                continue
            if hasattr(obj, name):
                attrs[name] = getattr(obj, name)
    attrs.update(getattr(obj, "__dict__", None) or {})
    return sorted((n, v) for n, v in attrs.items() if n not in env)


# ---------------------------------------------------------------------------
# Encoding.  Every tree node is a (tag, ...) tuple over canonical.py's
# primitive types.  Mutable/shareable nodes get a memo index on first
# encounter; later encounters encode as ("r", idx).
# ---------------------------------------------------------------------------

_PRIMITIVES = (bool, int, bytes, str, type(None))


class _Encoder:
    def __init__(self) -> None:
        self.memo: Dict[int, int] = {}
        self.next_idx = 0

    def _memoize(self, obj: Any) -> int:
        idx = self.next_idx
        self.next_idx += 1
        self.memo[id(obj)] = idx
        return idx

    def encode(self, obj: Any) -> Any:
        if isinstance(obj, bool) or obj is None:
            return ("p", obj)
        if isinstance(obj, int) or isinstance(obj, (bytes, str)):
            return ("p", obj)
        if isinstance(obj, bytearray):
            return ("ba", bytes(obj))
        if isinstance(obj, float):
            # Exact round-trip via IEEE bits (canonical has no float type).
            import struct

            return ("f", struct.pack(">d", obj))

        prior = self.memo.get(id(obj))
        if prior is not None:
            return ("r", prior)

        # -- environment leaves ------------------------------------------
        from hbbft_tpu_torch.crypto.backend import CryptoBackend
        from hbbft_tpu_torch.crypto.group import Group

        if isinstance(obj, CryptoBackend):
            return ("backend", self._memoize(obj))
        if isinstance(obj, Group):
            return ("group", self._memoize(obj))
        if isinstance(obj, random.Random):
            idx = self._memoize(obj)
            version, state, gauss = obj.getstate()
            return ("rng", idx, version, list(state), self.encode(gauss))
        if isinstance(obj, np.ndarray):
            idx = self._memoize(obj)
            if obj.dtype.hasobject:
                raise SnapshotError("object-dtype ndarray in state")
            return ("nd", idx, obj.dtype.str, list(obj.shape), obj.tobytes())

        # -- containers ---------------------------------------------------
        if isinstance(obj, list):
            idx = self._memoize(obj)
            return ("l", idx, [self.encode(x) for x in obj])
        if isinstance(obj, dict):
            idx = self._memoize(obj)
            return (
                "d",
                idx,
                [(self.encode(k), self.encode(v)) for k, v in obj.items()],
            )
        if isinstance(obj, tuple):
            # Immutable: no memo (cycles through tuples are impossible to
            # build in protocol code; sharing need not be preserved).
            return ("t", [self.encode(x) for x in obj])
        if isinstance(obj, (set, frozenset)):
            idx = self._memoize(obj)
            # Sort members BEFORE real encoding, each with a throwaway
            # encoder: sorting real encodings would reorder memo
            # definitions after the ("r", idx) references to them, making
            # the snapshot undecodable (dangling refs on restore).
            members = sorted(
                obj, key=lambda x: canonical.encode(_Encoder().encode(x))
            )
            items = [self.encode(x) for x in members]
            return ("s" if isinstance(obj, set) else "fs", idx, items)

        # -- module-level functions from registered modules ----------------
        # (e.g. SenderQueue's msg_epoch_fn default): encoded BY NAME and
        # re-looked-up on decode — never deserialized code.  Closures and
        # lambdas have no stable name and are rejected below.
        import types as _types

        if isinstance(obj, _types.FunctionType):
            mod = getattr(obj, "__module__", None)
            qn = getattr(obj, "__qualname__", "")
            if mod in _STATE_MODULES and "<" not in qn and "." not in qn:
                import importlib

                if getattr(importlib.import_module(mod), qn, None) is obj:
                    return ("fn", mod, qn)

        # -- registered framework objects ---------------------------------
        tag = _class_tag(type(obj))
        if tag not in _registry():
            if callable(obj):
                raise SnapshotError(
                    f"callable in state ({obj!r}): snapshot only at "
                    "quiescent points (no outstanding CryptoWork)"
                )
            raise SnapshotError(f"unregistered state class {tag}")
        idx = self._memoize(obj)
        return (
            "o",
            idx,
            tag,
            [(name, self.encode(val)) for name, val in _state_attrs(obj)],
        )


class _Decoder:
    def __init__(self, backend) -> None:
        self.backend = backend
        self.objects: Dict[int, Any] = {}

    def decode(self, node: Any) -> Any:
        if not isinstance(node, tuple) or not node:
            raise SnapshotError(f"bad node {node!r}")
        tag = node[0]
        if tag == "p":
            return node[1]
        if tag == "ba":
            return bytearray(node[1])
        if tag == "f":
            import struct

            return struct.unpack(">d", node[1])[0]
        if tag == "r":
            try:
                return self.objects[node[1]]
            except KeyError:
                raise SnapshotError(f"dangling ref {node[1]}")
        if tag == "backend":
            self.objects[node[1]] = self.backend
            return self.backend
        if tag == "group":
            self.objects[node[1]] = self.backend.group
            return self.backend.group
        if tag == "rng":
            _, idx, version, state, gauss = node
            # lint: allow[replay-purity] not an entropy draw: the fresh
            # Random is a shell whose state is overwritten on the next
            # line by the snapshot's (version, state, gauss) tuple
            r = random.Random()
            r.setstate((version, tuple(state), self.decode(gauss)))
            self.objects[idx] = r
            return r
        if tag == "nd":
            _, idx, dtype, shape, raw = node
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
            self.objects[idx] = arr
            return arr
        if tag == "l":
            _, idx, items = node
            out: List[Any] = []
            self.objects[idx] = out
            out.extend(self.decode(x) for x in items)
            return out
        if tag == "d":
            _, idx, items = node
            d: Dict[Any, Any] = {}
            self.objects[idx] = d
            for k, v in items:
                d[self.decode(k)] = self.decode(v)
            return d
        if tag == "t":
            return tuple(self.decode(x) for x in node[1])
        if tag in ("s", "fs"):
            _, idx, items = node
            if tag == "s":
                s: Any = set()
                self.objects[idx] = s
                s.update(self.decode(x) for x in items)
                return s
            fs = frozenset(self.decode(x) for x in items)
            self.objects[idx] = fs
            return fs
        if tag == "fn":
            _, mod, qn = node
            if mod not in _STATE_MODULES or "." in qn or "<" in qn:
                raise SnapshotError(f"function outside registry: {mod}:{qn}")
            import importlib
            import types as _types

            fn = getattr(importlib.import_module(mod), qn, None)
            if not isinstance(fn, _types.FunctionType):
                raise SnapshotError(f"unknown function {mod}:{qn}")
            return fn
        if tag == "o":
            _, idx, clstag, attrs = node
            cls = _registry().get(clstag)
            if cls is None:
                raise SnapshotError(f"unknown class {clstag!r}")
            obj = cls.__new__(cls)
            self.objects[idx] = obj
            for name, val in attrs:
                if not isinstance(name, str):
                    raise SnapshotError("non-str attribute name")
                # object.__setattr__: works for frozen dataclasses too.
                object.__setattr__(obj, name, self.decode(val))
            return obj
        raise SnapshotError(f"unknown tag {tag!r}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_MAGIC = b"HBTPUSNAP1"


def save_node(algo: Any) -> bytes:
    """Serialize a protocol instance (any layer: RBC/BA/…/QHB or a
    SenderQueue-wrapped stack) to canonical snapshot bytes."""
    tree = _Encoder().encode(algo)
    return _MAGIC + canonical.encode(tree)


def load_node(data: bytes, backend) -> Any:
    """Rebuild a protocol instance from :func:`save_node` bytes.

    ``backend`` supplies the crypto environment (device handles are not
    state); it must be protocol-compatible with the one used at save time
    (same group semantics — e.g. both BLS12-381, or both mock).
    """
    if not data.startswith(_MAGIC):
        raise SnapshotError("bad magic")
    # Every decode failure surfaces as SnapshotError (the module contract):
    # truncated/corrupted bytes otherwise raise TypeError/ValueError/
    # struct.error from canonical parsing, rng setstate, ndarray reshape…
    try:
        tree = canonical.decode(data[len(_MAGIC) :])
        return _Decoder(backend).decode(tree)
    except SnapshotError:
        raise
    except Exception as e:
        raise SnapshotError(f"malformed snapshot: {e!r}") from e
