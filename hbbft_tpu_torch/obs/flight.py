"""Failure flight recorder: an always-on ring of the last K epochs — the
port's copy of the JAX package's ``obs/flight.py``.

A :class:`FlightRecorder` keeps per-epoch *frames* — the epoch's
completion events (``obs/critpath.py``), its time-series row
(``obs/timeseries.py``), and optionally its spans — in a
``deque(maxlen=K)`` ring (K from ``HBBFT_TPU_FLIGHT_EPOCHS``, default
8).  When a run dies — ``CrankError`` or a failed verdict — the harness
(``net/scenarios.run_scenario``) dumps the ring as a *forensics bundle*:
a single JSON document holding the frames plus the reconstructed
critical path of the window (:func:`write_bundle`, :func:`load_bundle`,
:func:`validate_bundle`, :func:`summarize_bundle`).

Determinism: no wall-clock reads; bundles are pure functions of the
recorded frames, so a seeded replay reproduces them bit-identically.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

from hbbft_tpu_torch.obs import critpath as _critpath

#: ring size knob: how many epochs of evidence a bundle carries
FLIGHT_EPOCHS_ENV = "HBBFT_TPU_FLIGHT_EPOCHS"
DEFAULT_FLIGHT_EPOCHS = 8

REQUIRED_BUNDLE_KEYS = ("version", "kind", "reason", "frames", "critical_path")


def flight_epochs() -> int:
    raw = os.environ.get(FLIGHT_EPOCHS_ENV, "")
    try:
        k = int(raw)
    except ValueError:
        return DEFAULT_FLIGHT_EPOCHS
    return k if k > 0 else DEFAULT_FLIGHT_EPOCHS


class FlightRecorder:
    """Always-on per-epoch evidence ring; ``bundle()`` is the dump."""

    __slots__ = ("epochs", "frames", "context", "_recorded")

    def __init__(
        self, epochs: Optional[int] = None, context: Optional[Dict[str, Any]] = None
    ) -> None:
        self.epochs = epochs if epochs is not None else flight_epochs()
        self.frames: deque = deque(maxlen=max(1, self.epochs))
        self.context = context
        self._recorded = 0

    def record(
        self,
        epoch: int,
        series_row: Optional[Dict[str, Any]] = None,
        events: Any = (),
        spans: Any = (),
    ) -> None:
        """Append one epoch frame (oldest frame falls off the ring)."""
        frame: Dict[str, Any] = {"epoch": epoch, "events": list(events)}
        if series_row is not None:
            frame["series"] = series_row
        spans = list(spans)
        if spans:
            frame["spans"] = spans
        self.frames.append(frame)
        self._recorded += 1

    @property
    def recorded(self) -> int:
        return self._recorded

    def bundle(
        self,
        reason: str,
        why: Optional[Dict[str, Any]] = None,
        faults: Any = None,
        gate_hint: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The forensics dump: ring frames + the window's reconstructed
        critical path (gating chain per epoch, run-window gating
        histogram, and the latest gate one-liner).  ``gate_hint`` (e.g.
        a why-stalled summary line) overrides the gate label when the
        window holds no committed epoch to attribute."""
        frames = list(self.frames)
        events = [ev for fr in frames for ev in fr.get("events", ())]
        paths = _critpath.paths_from_events(events)
        gate = paths[-1].one_liner() if paths else None
        if gate_hint and not paths:
            gate = gate_hint
        return {
            "version": 1,
            "kind": "forensics",
            "reason": reason,
            "context": self.context,
            "frames": frames,
            "critical_path": {
                "gate": gate,
                "gating": _critpath.gating_histogram(paths),
                "paths": [p.to_dict() for p in paths],
            },
            "why": why,
            "faults": list(faults) if faults else [],
        }


def write_bundle(doc: Dict[str, Any], path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=repr)
        f.write("\n")
    return path


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def validate_bundle(doc: Any) -> List[str]:
    """Structural checks (``trace_report --forensics`` gate): required
    keys, monotonic frame epochs, well-formed critical path whose phase
    names stay inside the critpath registry."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not a JSON object"]
    for k in REQUIRED_BUNDLE_KEYS:
        if k not in doc:
            errors.append(f"missing key {k!r}")
    if errors:
        return errors
    if doc["version"] != 1:
        errors.append(f"unknown version {doc['version']!r}")
    if doc["kind"] != "forensics":
        errors.append(f"kind is {doc['kind']!r}, not 'forensics'")
    frames = doc["frames"]
    if not isinstance(frames, list) or not frames:
        errors.append("frames must be a non-empty list")
        return errors
    prev = None
    for i, fr in enumerate(frames):
        ep = fr.get("epoch") if isinstance(fr, dict) else None
        if not isinstance(ep, int):
            errors.append(f"frame {i} has no integer epoch")
            continue
        if prev is not None and ep < prev:
            errors.append(f"frame epochs not monotonic at index {i} ({ep} < {prev})")
        prev = ep
    cp = doc["critical_path"]
    if not isinstance(cp, dict) or "gating" not in cp or "paths" not in cp:
        errors.append("critical_path must hold 'gating' and 'paths'")
        return errors
    share_sum = 0.0
    for ph in sorted(cp["gating"]):
        share = cp["gating"][ph]
        if ph not in _critpath.PHASES:
            errors.append(f"gating phase {ph!r} not in critpath.PHASES")
        if not 0.0 <= share <= 1.0001:
            errors.append(f"gating share out of range for {ph!r}: {share}")
        share_sum += share
    if cp["gating"] and not 0.99 <= share_sum <= 1.01:
        errors.append(f"gating shares sum to {share_sum:.4f}, not 1")
    for j, p in enumerate(cp["paths"]):
        if p.get("gate_phase") not in _critpath.PHASES:
            errors.append(f"path {j} gate_phase {p.get('gate_phase')!r} unknown")
    return errors


def summarize_bundle(doc: Dict[str, Any]) -> List[str]:
    """Human summary lines (``trace_report --forensics`` output)."""
    frames = doc.get("frames", [])
    epochs = [fr.get("epoch") for fr in frames if isinstance(fr.get("epoch"), int)]
    span = f"epochs {min(epochs)}..{max(epochs)}" if epochs else "no epochs"
    lines = [
        f"forensics: reason={doc.get('reason')!r} frames={len(frames)} ({span})",
    ]
    ctx = doc.get("context") or {}
    cell = ctx.get("cell") if isinstance(ctx, dict) else None
    if isinstance(cell, dict):
        axes = "x".join(
            str(cell.get(k)) for k in ("attack", "schedule", "churn", "crash", "traffic")
        )
        lines.append(f"  cell: {axes} n={cell.get('n')} seed={cell.get('seed')}")
    cp = doc.get("critical_path") or {}
    if cp.get("gate"):
        lines.append(f"  gate: {cp['gate']}")
    gating = cp.get("gating") or {}
    for ph in sorted(gating, key=lambda p: -gating[p]):
        lines.append(f"  gating {ph}: {gating[ph] * 100:.1f}%")
    why = doc.get("why") or {}
    summary = why.get("summary") if isinstance(why, dict) else None
    if summary:
        lines.append(f"  why: {summary[0]}")
    faults = doc.get("faults") or []
    kinds: Dict[str, int] = {}
    for t in faults:
        kind = t[2] if isinstance(t, (list, tuple)) and len(t) == 3 else repr(t)
        kinds[kind] = kinds.get(kind, 0) + 1
    for kind in sorted(kinds):
        lines.append(f"  fault {kind}: {kinds[kind]}")
    return lines
