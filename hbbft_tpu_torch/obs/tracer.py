"""Tracer — hierarchical protocol/device spans with Perfetto export.

A span marks one interval of work (an epoch, one ACS, one BA instance,
one coin round, one batched device dispatch) on a named **track**.
Tracks map to Chrome-trace ``tid``\\ s, so spans on one track must nest
(begin/end as a stack) while spans on different tracks overlap freely —
which is exactly the lockstep engine's shape: all N BA-instance spans run
concurrently, each on its own ``ba/<idx>`` track, under one ``subset``
span on the main track.  The pipelined dispatch seam (ops/pipeline.py)
uses the same mechanism for overlapping device intervals: synchronous
dispatches span the ``device`` track, while each in-flight slot of the
deferred-fetch queue spans its own ``device/<slot>`` track — a slot is
reused only after its previous span's fetch completed, so per-track
nesting holds even though dispatch+fetch intervals overlap in wall time.

Export targets:

* :meth:`write_chrome` — Chrome trace-event JSON (``{"traceEvents":
  [...]}``), loadable in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``.  Spans are matched ``B``/``E`` pairs with
  microsecond ``ts``; span categories reuse the ``device_seconds_*``
  kind labels (pairing, rlc_sig, combine, sign, decrypt, ...).
* :meth:`write_jsonl` — one raw event per line for offline tooling
  (``tools/trace_report.py``).

The tracer also owns a registry of log-bucketed
:class:`~hbbft_tpu_torch.obs.histogram.Histogram`\\ s (per-crank latency,
dispatch batch sizes, RLC group sizes, queue depths) so one object
threads through runtime, engine, and backend.

Zero-cost when absent: every instrumentation site guards with
``if tracer is not None`` (the EventLog discipline).  ``Tracer(spans=
False)`` keeps the histogram registry live but makes span emission a
no-op — bench rows collect distributions without paying event-list
growth on million-dispatch runs.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from hbbft_tpu_torch.obs.histogram import Histogram


class Tracer:
    """Collects span events + histograms; exports Chrome trace / JSONL."""

    def __init__(
        self,
        spans: bool = True,
        capacity: int = 2_000_000,
        clock=time.perf_counter,
    ) -> None:
        self.spans_enabled = spans
        self.capacity = capacity
        self.clock = clock
        self._t0 = clock()
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self.histograms: Dict[str, Histogram] = {}
        self.pid = os.getpid()
        self._tids: Dict[str, int] = {}
        self._stacks: Dict[int, List[str]] = {}
        #: opt-in per-crank spans in VirtualNet (histograms are always on;
        #: a span per delivered message is only worth it on small runs)
        self.crank_spans = False

    # -- clock/track plumbing ------------------------------------------------

    def _now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
        return tid

    # -- spans ---------------------------------------------------------------
    #
    # Capacity is enforced in WHOLE-SPAN units: a B whose E could not be
    # recorded would leave an unclosed span that fails the trace-event
    # validator, so begin() drops the B at capacity (remembering that on
    # the stack) and end() closes only what was actually opened —
    # overshooting capacity by at most the spans already open when the
    # limit was hit.  complete() emits its B/E pair atomically or drops
    # both.

    def begin(self, name: str, cat: str = "", track: str = "main", **args: Any) -> None:
        """Open a span on ``track`` (close with :meth:`end` on the same track)."""
        if not self.spans_enabled:
            return
        tid = self._tid(track)
        emitted = len(self.events) < self.capacity
        self._stacks.setdefault(tid, []).append((name, emitted))
        if not emitted:
            self.dropped += 1
            return
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat or "span",
            "ph": "B",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, track: str = "main", **args: Any) -> None:
        """Close the innermost open span on ``track``."""
        if not self.spans_enabled:
            return
        tid = self._tid(track)
        stack = self._stacks.get(tid)
        if not stack:
            raise ValueError(f"Tracer.end on track {track!r} with no open span")
        name, emitted = stack.pop()
        if not emitted:  # its B was dropped at capacity: drop the E too
            self.dropped += 1
            return
        ev: Dict[str, Any] = {
            "name": name,
            "cat": "span",
            "ph": "E",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "", track: str = "main", **args: Any):
        self.begin(name, cat=cat, track=track, **args)
        try:
            yield self
        finally:
            self.end(track=track)

    def complete(
        self,
        name: str,
        t0: float,
        t1: float,
        cat: str = "",
        track: str = "main",
        **args: Any,
    ) -> None:
        """Record a finished span retroactively from two ``clock()`` stamps.

        Used where the caller already timed the interval (the backend's
        dispatch+fetch seam bills the identical ``t1 - t0`` to
        ``counters.device_seconds``, so traced device time and counter
        attribution agree exactly)."""
        if not self.spans_enabled:
            return
        tid = self._tid(track)
        if self._stacks.get(tid):
            raise ValueError(
                f"Tracer.complete on track {track!r} inside an open span"
            )
        if len(self.events) + 2 > self.capacity:  # whole pair or nothing
            self.dropped += 2
            return
        base = {"name": name, "cat": cat or "span", "pid": self.pid, "tid": tid}
        b = dict(base, ph="B", ts=(t0 - self._t0) * 1e6)
        if args:
            b["args"] = args
        self.events.append(b)
        self.events.append(dict(base, ph="E", ts=(t1 - self._t0) * 1e6))

    def open_spans(self) -> int:
        return sum(len(s) for s in self._stacks.values())

    # -- histograms ----------------------------------------------------------

    def hist(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def hist_summary(self) -> Dict[str, Dict[str, float]]:
        """All non-empty histogram summaries (bench-row / heartbeat shape)."""
        return {
            name: h.summary()
            for name, h in sorted(self.histograms.items())
            if h.count
        }

    # -- export --------------------------------------------------------------

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Events in Chrome trace-event form: ts-sorted B/E spans plus
        thread-name metadata so Perfetto labels the tracks."""
        meta: List[Dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": "hbbft_tpu"},
            }
        ]
        for track, tid in self._tids.items():
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid,
                    "ts": 0,
                    "args": {"name": track},
                }
            )
        # Stable sort: retroactive `complete` spans interleave with live
        # begin/end stamps; Perfetto requires neither order nor nesting
        # across tids, but monotonic ts makes the file diffable/validatable.
        body = sorted(self.events, key=lambda e: e["ts"])
        return meta + body

    @staticmethod
    def _ensure_parent(path: str) -> None:
        # a missing artifacts/ dir must not discard a multi-hour run's
        # trace at the very last write
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def write_chrome(self, path: str) -> None:
        if self.open_spans():
            raise ValueError(
                f"{self.open_spans()} span(s) still open — end them before export"
            )
        self._ensure_parent(path)
        doc = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": self.dropped,
                "histograms": self.hist_summary(),
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)

    def write_jsonl(self, path: str) -> None:
        """One event per line, ts-sorted (retroactive ``complete`` spans
        interleave with live stamps in emission order; sorting gives the
        same monotonic-ts guarantee the Chrome export has)."""
        self._ensure_parent(path)
        with open(path, "w") as f:
            for ev in sorted(self.events, key=lambda e: e["ts"]):
                f.write(json.dumps(ev, default=repr) + "\n")

    def write(self, path: str) -> None:
        """Chrome trace for ``*.json``, raw JSONL for ``*.jsonl``."""
        if path.endswith(".jsonl"):
            self.write_jsonl(path)
        else:
            self.write_chrome(path)

    def __len__(self) -> int:
        return len(self.events)
