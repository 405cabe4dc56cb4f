"""Per-epoch telemetry time-series (`MetricsLog`) — the port's copy of
the JAX package's ``obs/timeseries.py``.

A :class:`MetricsLog` is a bounded ring of per-epoch snapshot rows —
counter deltas (against the previous snapshot, never a mid-run
``reset()``), histogram windows, host-bucket splits, the controller's
live batch size B, mempool depth, crash state, and the epoch's
critical-path gate — JSONL-exportable; :func:`snap_net` takes one row of
a ``VirtualNet``.

Determinism: no wall-clock reads — rows carry only caller-provided
values — and, by default, float-valued (wall-derived ``*_seconds``)
counter fields are EXCLUDED from rows so a seeded replay reproduces the
series bit-identically (``include_timing=True`` opts timings back in).
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional


class MetricsLog:
    """Bounded per-epoch snapshot ring (``deque(maxlen=capacity)``)."""

    __slots__ = ("capacity", "include_timing", "rows", "_last", "_last_hist", "_emitted")

    def __init__(self, capacity: int = 4096, include_timing: bool = False) -> None:
        self.capacity = capacity
        self.include_timing = include_timing
        self.rows: deque = deque(maxlen=capacity)
        self._last: Dict[str, Any] = {}
        self._last_hist: Dict[str, int] = {}
        self._emitted = 0

    # -- snapshotting ------------------------------------------------------

    def snap(
        self,
        epoch: int,
        counters: Optional[Dict[str, Any]] = None,
        tracer: Any = None,
        crash: Optional[Dict[str, Any]] = None,
        controller_b: Optional[int] = None,
        mempool_depth: Optional[int] = None,
        gate: Any = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Append one epoch row.  ``counters`` is a merged
        ``Counters.snapshot()`` dict (net + backend); the row records the
        DELTA against the previous snap, so the underlying counters stay
        monotonic and run-end aggregates stay unskewed.  ``gate`` is the
        epoch's :class:`~hbbft_tpu_torch.obs.critpath.EpochCritPath` (or an
        equivalent dict)."""
        row: Dict[str, Any] = {"epoch": epoch}
        if counters is not None:
            prev = self._last
            delta: Dict[str, Any] = {}
            buckets: Dict[str, float] = {}
            for k in sorted(counters):
                d = counters[k] - prev.get(k, 0)
                if not d:
                    continue
                if isinstance(d, float):
                    if not self.include_timing:
                        continue  # wall-derived: excluded for replay identity
                    d = round(d, 9)
                if k.startswith("host_bucket_"):
                    buckets[k[len("host_bucket_"):]] = d
                else:
                    delta[k] = d
            self._last = dict(counters)
            row["counters"] = delta
            if buckets:
                row["host_buckets"] = buckets
        if tracer is not None:
            window: Dict[str, Dict[str, float]] = {}
            summary = tracer.hist_summary()
            for name in sorted(summary):
                s = dict(summary[name])
                count = int(s.get("count", 0))
                s["window_count"] = count - self._last_hist.get(name, 0)
                self._last_hist[name] = count
                if s["window_count"]:
                    window[name] = s
            if window:
                row["hist"] = window
        if crash is not None:
            row["crash"] = crash
        if controller_b is not None:
            row["b"] = controller_b
        if mempool_depth is not None:
            row["mempool"] = mempool_depth
        if gate is not None:
            g = gate.to_dict() if hasattr(gate, "to_dict") else dict(gate)
            row["gate"] = {
                "phase": g.get("gate_phase", g.get("phase")),
                "instance": g.get("gate_instance", g.get("instance")),
                "node": g.get("gate_node", g.get("node")),
                "round": g.get("gate_round", g.get("round")),
                "cranks": g.get("cranks", 0),
            }
        if extra:
            for k in sorted(extra):
                row[k] = extra[k]
        self.rows.append(row)
        self._emitted += 1
        return row

    # -- access / export ---------------------------------------------------

    @property
    def dropped(self) -> int:
        return self._emitted - len(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def last(self) -> Optional[Dict[str, Any]]:
        return self.rows[-1] if self.rows else None

    def rows_list(self) -> List[Dict[str, Any]]:
        return list(self.rows)

    def to_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for row in self.rows:
                f.write(json.dumps(row, sort_keys=True, default=repr) + "\n")


def snap_net(
    log: MetricsLog,
    net: Any,
    epoch: int,
    gate: Any = None,
    controller_b: Optional[int] = None,
    mempool_depth: Optional[int] = None,
) -> Dict[str, Any]:
    """One VirtualNet epoch row: merged counters, crash state, and the
    crank/virtual-clock context (duck-typed — any net exposing
    ``metrics()``/``cranks``/``now`` works)."""
    crash = None
    cm = getattr(net, "crash", None)
    if cm is not None:
        st = cm.stats()
        crash = {
            "crashes": st["crashes"],
            "restarts": st["restarts"],
            "down": sorted(repr(i) for i in net.down_node_ids()),
        }
    return log.snap(
        epoch,
        counters=net.metrics(),
        crash=crash,
        controller_b=controller_b,
        mempool_depth=mempool_depth,
        gate=gate,
        extra={"cranks": net.cranks, "now": net.now},
    )
