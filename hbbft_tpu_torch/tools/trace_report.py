"""trace_report — summarize obs traces; diff BENCH_rows.json artifacts (the
port's copy of the JAX package's ``tools/trace_report.py``: the same
functions, CLI and exit codes).

Two subcommands on one small CLI:

* ``python -m hbbft_tpu_torch.tools.trace_report TRACE`` — load a Chrome-trace-event
  ``trace.json`` (or raw event ``.jsonl``) written by
  :class:`hbbft_tpu_torch.obs.tracer.Tracer`, validate it against the
  trace-event schema (required keys, monotonic ``ts``, matched B/E
  pairs), and print the per-kind time table: span category, span count,
  total seconds, share — the device rows reproduce the
  ``device_seconds_*`` counter split from the trace alone.
* ``python -m hbbft_tpu_torch.tools.trace_report --diff OLD NEW`` — compare two
  ``BENCH_rows.json`` files metric by metric and flag regressions where
  the new value dropped more than ``--tol`` (default 10%) below the old
  (all bench metrics are higher-is-better rates).  Exit code 1 when any
  regression is flagged, so the check can gate CI.
* ``python -m hbbft_tpu_torch.tools.trace_report --faults OLD NEW`` — diff the
  fault-kind counts carried by rows with a ``fault_kinds`` field
  (scenario_matrix / adv_matrix captures): count changes print, and a
  kind that VANISHED while its row persists (an attack that stopped
  being detected) exits 1.
* ``python -m hbbft_tpu_torch.tools.trace_report --traffic OLD NEW`` — diff the
  ``qhb_traffic``/``slo_traffic`` throughput/latency curves cell by
  cell: a sustained tx/s drop beyond ``--tol`` (default 10%) OR a p99
  commit-latency increase beyond it is a regression (exit 1) — latency
  is lower-is-better, unlike every other bench metric, so the generic
  ``--diff`` mode cannot gate it.  ``slo_traffic`` cells additionally
  gate SLO COMPLIANCE: a cell (the controller's ``adaptive`` cell
  above all) that held the declared SLO in OLD and lost it in NEW
  exits 1 whatever the ratios.
* ``python -m hbbft_tpu_torch.tools.trace_report --critical-path PATH [PATH2]`` — print
  the run-level gating histogram (fraction of epochs each phase gated,
  obs/critpath.py) from any gating evidence: a per-epoch series
  ``.jsonl`` (rows carry ``gate.phase``), a forensics bundle
  (``critical_path.gating``), a BENCH capture whose rows carry a
  ``gating`` field, or a raw Chrome trace (epoch windows re-gated from
  the phase span categories).  With two paths, diff them: any phase
  whose gating share shifted more than ``--tol`` absolute share points
  (default 0.10) exits 1 — the commit-latency-attribution regression
  gate.
* ``python -m hbbft_tpu_torch.tools.trace_report --forensics BUNDLE...`` — validate
  each flight-recorder forensics bundle (required keys, monotonic frame
  epochs, gating shares sane, phase names inside the critpath registry)
  and print its summary (reason, cell, gate one-liner, gating table,
  fault kinds).  Exit 1 when any bundle is invalid.

The validation helpers are imported by the tests and by ``chip_smoke.py``
— keep them dependency-free (no torch, no package import).  The critpath
phase vocabulary below is a deliberate inline COPY of
hbbft_tpu_torch/obs/critpath.py (this tool must not import the package);
the phase-label guard test pins the two against each other.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

#: keys every span event must carry (Chrome trace-event format)
REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")

#: inline copy of hbbft_tpu_torch/obs/critpath.py PHASES — the closed
#: critpath phase vocabulary (the phase-label guard test pins the two lists)
CRITPATH_PHASES = (
    "rbc.output",
    "ba.decide",
    "coin.reveal",
    "decrypt.combine",
    "epoch.commit",
    "crank",
    "crash:recovery",
)

#: tracer span category -> critpath phase (inverse of critpath
#: PHASE_SPAN_CATS; same guard test pins it) — how a raw Chrome trace's
#: spans re-derive per-epoch gating without importing the package
SPAN_CAT_PHASES = {
    "rbc": "rbc.output",
    "ba": "ba.decide",
    "coin": "coin.reveal",
    "decrypt": "decrypt.combine",
    "epoch": "epoch.commit",
    "crank": "crank",
    "crash": "crash:recovery",
}

#: inline copy of hbbft_tpu_torch/obs/flight.py REQUIRED_BUNDLE_KEYS
REQUIRED_FORENSICS_KEYS = ("version", "kind", "reason", "frames", "critical_path")


def load_events(path: str) -> List[Dict[str, Any]]:
    """Events from a Chrome trace (``{"traceEvents": [...]}``) or JSONL."""
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return doc["traceEvents"]
    raise ValueError(f"{path}: not a Chrome trace or event JSONL")


def validate_chrome_trace(events: List[Dict[str, Any]]) -> List[str]:
    """Schema errors (empty list = valid).

    Checks: every event carries the required keys; ``ts`` is monotonic
    non-decreasing in file order; on each (pid, tid) the B/E events form
    a properly nested stack with matching names; no span left open.
    """
    errors: List[str] = []
    last_ts = None
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    for i, ev in enumerate(events):
        for k in REQUIRED_KEYS:
            if k not in ev:
                errors.append(f"event {i}: missing key {k!r}")
        ph = ev.get("ph")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(f"event {i}: ts {ts} < previous {last_ts}")
        last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i}: E with no open B on tid {key[1]}")
            elif stack[-1] != ev.get("name", ""):
                errors.append(
                    f"event {i}: E {ev.get('name')!r} closes "
                    f"open B {stack[-1]!r} on tid {key[1]}"
                )
                stack.pop()
            else:
                stack.pop()
        elif ph not in ("M",):
            errors.append(f"event {i}: unknown ph {ph!r}")
    for key, stack in stacks.items():
        for name in stack:
            errors.append(f"unclosed span {name!r} on tid {key[1]}")
    return errors


def span_durations(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Closed spans as {name, cat, tid, dur_us, device, args}."""
    out: List[Dict[str, Any]] = []
    stacks: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for ev in events:
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if stack:
                b = stack.pop()
                args = b.get("args", {})
                out.append(
                    {
                        "name": b.get("name", ""),
                        "cat": b.get("cat", ""),
                        "tid": key[1],
                        "dur_us": ev["ts"] - b["ts"],
                        "device": bool(args.get("device")),
                        "args": args,
                    }
                )
    return out


def device_span_seconds(events: List[Dict[str, Any]]) -> float:
    """Total wall seconds of device=True dispatch spans — should agree
    with counters.device_seconds (±5%; both bill the same dispatch+fetch
    interval).  Under pipelined dispatch the spans OVERLAP in wall time
    (each in-flight slot spans its own ``device/<slot>`` track), but the
    per-span durations still sum to the counter, because both bill the
    same per-dispatch dispatch→fetch interval."""
    return sum(
        s["dur_us"] for s in span_durations(events) if s["device"]
    ) / 1e6


def check_device_seconds(
    events: List[Dict[str, Any]], expected: float, tol: float = 0.05
) -> Tuple[bool, float]:
    """Acceptance check: Σ device=True span durations == ``expected``
    (counters.device_seconds, or device_seconds_per_epoch × epochs from
    a bench row) within ``tol`` relative.  Returns (ok, measured).

    This is the invariant that keeps the pipeline honest: deferring
    fetches must not lose or double-bill device time — overlapped spans
    still sum to the counter, so a traced run validates the attribution
    without hardware-side profiling."""
    got = device_span_seconds(events)
    if expected <= 0:
        return (got == 0.0, got)
    return (abs(got - expected) <= tol * expected, got)


def track_name_map(events: List[Dict[str, Any]]) -> Dict[Any, str]:
    """tid -> tracer track name, from the ``thread_name`` metadata
    events obs/tracer.py emits for every track."""
    out: Dict[Any, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            out[ev.get("tid")] = (ev.get("args") or {}).get("name", "")
    return out


def per_device_span_seconds(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """``device=True`` span seconds grouped by tracer track — the shard
    pipeline's per-device attribution surface (parallel/shardpipe.py).

    Sharded dispatches span ``device/<n>`` (their device's track);
    unreserved async entries span ``device/q<slot>`` and sync entries
    the classic ``device`` track, so the values sum to the SAME total as
    :func:`device_span_seconds` however the run was routed."""
    names = track_name_map(events)
    out: Dict[str, float] = {}
    for s in span_durations(events):
        if not s["device"]:
            continue
        track = names.get(s["tid"], str(s["tid"]))
        out[track] = out.get(track, 0.0) + s["dur_us"] / 1e6
    return out


def check_per_device_seconds(
    events: List[Dict[str, Any]], expected: float, tol: float = 0.05
) -> Tuple[bool, Dict[str, float]]:
    """Acceptance check: the per-device span partition must sum
    to ``expected`` (counters.device_seconds) within ``tol`` relative —
    per-device attribution may not lose or double-bill device time
    relative to the global counter.  Returns (ok, per-track seconds)."""
    per = per_device_span_seconds(events)
    got = sum(per.values())
    if expected <= 0:
        return (got == 0.0, per)
    return (abs(got - expected) <= tol * expected, per)


def host_bucket_seconds(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """Per-bucket host seconds from the ``host=True`` region spans.

    Regions NEST (dispatch ⊃ staging), so summing span durations would
    double-count; each span instead carries its EXCLUSIVE seconds in
    ``args.exclusive_s`` (obs/hostbuckets.py), and those reproduce the
    ``host_bucket_*`` counter partition from the trace alone."""
    out: Dict[str, float] = {}
    for s in span_durations(events):
        args = s["args"]
        if not args.get("host"):
            continue
        bucket = args.get("bucket", s["name"])
        sec = args.get("exclusive_s")
        if not isinstance(sec, (int, float)):
            sec = s["dur_us"] / 1e6
        out[bucket] = out.get(bucket, 0.0) + float(sec)
    return out


def check_host_buckets(
    events: List[Dict[str, Any]],
    expected: float,
    tol: float = 0.05,
    max_unattributed: float = 0.10,
    folded_device_seconds: float = 0.0,
) -> Tuple[bool, Dict[str, float]]:
    """Acceptance check for the host attribution: the traced
    bucket partition must sum to ``expected`` (counters.host_seconds, or
    host_seconds_per_epoch × epochs from a bench row) within ``tol``
    relative, AND the residual ``other`` bucket must stay under
    ``max_unattributed`` of the total — i.e. the named buckets cover
    ≥ 1 − max_unattributed of the epoch's host time.

    ``folded_device_seconds`` is the device time of work that
    used to be host buckets — with the device erasure/hash plane on,
    encode/rs_merkle legitimately fall to ~0 and host_seconds shrinks by
    the folded amount, which would inflate every remaining bucket's
    SHARE; the unattributed bound is therefore judged against the
    pre-fold scale (expected + folded).  The sum check is unchanged:
    the buckets must still account for the host time that remains.
    Returns (ok, buckets)."""
    buckets = host_bucket_seconds(events)
    total = sum(buckets.values())
    if expected <= 0:
        return (total == 0.0, buckets)
    ok = (
        abs(total - expected) <= tol * expected
        and buckets.get("other", 0.0)
        <= max_unattributed * (expected + max(0.0, folded_device_seconds))
    )
    return ok, buckets


def kind_table(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-category totals, device dispatches split from protocol spans.

    ``share`` is each category's total against the trace's WALL duration
    (first B to last E), not the sum of all span durations — spans nest
    (epoch ⊃ subset ⊃ rbc) and the lockstep engine replicates per-proposer
    instance spans across tracks, so a duration-sum denominator would
    understate enclosing spans.  Shares can therefore sum past 100%: an
    ``epoch`` row near 100% wall is the expected reading."""
    agg: Dict[Tuple[str, bool], Dict[str, float]] = {}
    for s in span_durations(events):
        key = (s["cat"] or "span", s["device"])
        a = agg.setdefault(key, {"count": 0, "us": 0.0})
        a["count"] += 1
        a["us"] += s["dur_us"]
    ts = [e["ts"] for e in events if e.get("ph") in ("B", "E")]
    wall_us = (max(ts) - min(ts)) if ts else 0.0
    rows = [
        {
            "cat": cat,
            "device": device,
            "count": int(a["count"]),
            "seconds": a["us"] / 1e6,
            "share": a["us"] / wall_us if wall_us else 0.0,
        }
        for (cat, device), a in agg.items()
    ]
    rows.sort(key=lambda r: -r["seconds"])
    return rows


def report(
    path: str,
    device_seconds: Optional[float] = None,
    tol: float = 0.05,
    host_buckets: Optional[float] = None,
    host_unattributed_max: float = 0.10,
    host_folded_device: float = 0.0,
) -> int:
    events = load_events(path)
    errors = validate_chrome_trace(events)
    if errors:
        print(f"{path}: INVALID ({len(errors)} schema errors)")
        for e in errors[:20]:
            print("  " + e)
        return 1
    spans = [e for e in events if e.get("ph") in ("B", "E")]
    print(f"{path}: valid; {len(spans) // 2} spans")
    dev = device_span_seconds(events)
    print(f"device dispatch time (device=True spans): {dev:.4f} s")
    print(f"{'cat':>12} {'where':>7} {'count':>8} {'seconds':>10} {'wall%':>7}")
    for r in kind_table(events):
        where = "device" if r["device"] else "host"
        print(
            f"{r['cat']:>12} {where:>7} {r['count']:>8} "
            f"{r['seconds']:>10.4f} {r['share']:>6.1%}"
        )
    per = per_device_span_seconds(events)
    if any(t.startswith("device/") for t in per):
        print(f"{'device track':>14} {'seconds':>10}")
        for track in sorted(per):
            print(f"{track:>14} {per[track]:>10.4f}")
    if device_seconds is not None:
        ok, got = check_device_seconds(events, device_seconds, tol)
        verdict = "OK" if ok else "MISMATCH"
        print(
            f"device-seconds check: spans {got:.4f} s vs counter "
            f"{device_seconds:.4f} s (±{tol:.0%}) — {verdict}"
        )
        if not ok:
            return 1
        ok, per = check_per_device_seconds(events, device_seconds, tol)
        verdict = "OK" if ok else "MISMATCH"
        print(
            f"per-device check: {len(per)} track(s) sum "
            f"{sum(per.values()):.4f} s vs counter {device_seconds:.4f} s "
            f"(±{tol:.0%}) — {verdict}"
        )
        if not ok:
            return 1
    if host_buckets is not None:
        ok, buckets = check_host_buckets(
            events, host_buckets, tol, host_unattributed_max,
            host_folded_device,
        )
        total = sum(buckets.values())
        print(f"{'host bucket':>12} {'seconds':>10} {'share':>7}")
        for name, sec in sorted(buckets.items(), key=lambda kv: -kv[1]):
            share = sec / host_buckets if host_buckets else 0.0
            print(f"{name:>12} {sec:>10.4f} {share:>6.1%}")
        verdict = "OK" if ok else "MISMATCH"
        folded = (
            f", folded device {host_folded_device:.4f} s"
            if host_folded_device
            else ""
        )
        print(
            f"host-buckets check: buckets {total:.4f} s vs counter "
            f"{host_buckets:.4f} s (±{tol:.0%}), unattributed "
            f"{buckets.get('other', 0.0):.4f} s "
            f"(max {host_unattributed_max:.0%}{folded}) — {verdict}"
        )
        if not ok:
            return 1
    return 0


# ---------------------------------------------------------------------------
# BENCH_rows.json diff
# ---------------------------------------------------------------------------


def _rows_by_metric(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    rows = doc["rows"] if isinstance(doc, dict) else doc
    return {
        r["metric"]: r
        for r in rows
        if isinstance(r.get("value"), (int, float))
    }


#: A/B rows whose secondary arm / ratio must diff alongside the headline
#: value — the rs_plane_ab row's ``value`` is the device-plane rate, so
#: without these sub-metrics a host-arm collapse (or the device-vs-host
#: ratio sliding under 1.0) would pass the diff unnoticed
_AB_SUBMETRICS: Dict[str, Tuple[str, ...]] = {
    "rs_plane_ab": ("host_blocks_per_sec", "device_vs_host"),
}


def diff_rows(
    old_path: str, new_path: str, tol: float = 0.10
) -> List[Dict[str, Any]]:
    """Per-metric comparison; ``regression`` flags a >tol drop (all bench
    metrics are higher-is-better rates)."""
    old, new = _rows_by_metric(old_path), _rows_by_metric(new_path)
    out = []
    for metric in sorted(set(old) | set(new)):
        o, n = old.get(metric), new.get(metric)
        entry: Dict[str, Any] = {"metric": metric}
        if o is None or n is None:
            entry["status"] = "only_in_new" if o is None else "only_in_old"
            entry["regression"] = False
            out.append(entry)
            continue
        entry["old"] = o["value"]
        entry["new"] = n["value"]
        entry["ratio"] = n["value"] / o["value"] if o["value"] else None
        entry["regression"] = bool(
            o["value"] and n["value"] < o["value"] * (1.0 - tol)
        )
        out.append(entry)
        for field in _AB_SUBMETRICS.get(metric, ()):
            ov, nv = o.get(field), n.get(field)
            if not isinstance(ov, (int, float)) or not isinstance(
                nv, (int, float)
            ):
                continue
            out.append(
                {
                    "metric": f"{metric}.{field}",
                    "old": ov,
                    "new": nv,
                    "ratio": nv / ov if ov else None,
                    "regression": bool(ov and nv < ov * (1.0 - tol)),
                }
            )
    return out


def _fault_rows(path: str) -> Dict[str, Dict[str, int]]:
    """metric -> fault-kind counts for every row carrying a
    ``fault_kinds`` field (scenario_matrix, adv_matrix captures)."""
    with open(path) as f:
        doc = json.load(f)
    rows = doc["rows"] if isinstance(doc, dict) else doc
    out: Dict[str, Dict[str, int]] = {}
    for r in rows:
        if not isinstance(r.get("fault_kinds"), dict):
            continue
        kinds = dict(r["fault_kinds"])
        # crash-axis rows (crash_matrix): the injected-crash and
        # completed-restart counts ride as synthetic kinds, so the axis
        # silently ceasing to crash/recover (counts -> 0 while the row
        # persists) is a detection loss exactly like a vanished
        # crash:recovery_failed / crash:replay_divergence fault count
        for key, pseudo in (
            ("crashes", "axis:crashes_injected"),
            ("restarts", "axis:restarts_completed"),
        ):
            if isinstance(r.get(key), int) and r[key]:
                kinds[pseudo] = r[key]
        out[r["metric"]] = kinds
    return out


def diff_faults(old_path: str, new_path: str) -> List[Dict[str, Any]]:
    """Per-metric fault-kind count deltas between two BENCH_rows files.

    A changed count is not automatically a regression (more epochs plant
    more faults) but a kind that DISAPPEARS while its metric persists
    means an attack stopped being detected — that is flagged."""
    old, new = _fault_rows(old_path), _fault_rows(new_path)
    out: List[Dict[str, Any]] = []
    for metric in sorted(set(old) | set(new)):
        o, n = old.get(metric, {}), new.get(metric, {})
        for kind in sorted(set(o) | set(n)):
            oc, nc = o.get(kind, 0), n.get(kind, 0)
            if oc == nc:
                continue
            out.append(
                {
                    "metric": metric,
                    "kind": kind,
                    "old": oc,
                    "new": nc,
                    # detection loss: the kind vanished while the metric row
                    # still exists in the new capture
                    "lost": bool(oc and not nc and metric in new),
                }
            )
    return out


def report_faults(old_path: str, new_path: str) -> int:
    entries = diff_faults(old_path, new_path)
    if not entries:
        print("fault-kind counts identical")
        return 0
    lost = [e for e in entries if e["lost"]]
    for e in entries:
        flag = "  LOST" if e["lost"] else ""
        print(
            f"{e['metric']:>20} {e['kind']:>45} "
            f"{e['old']:>6} -> {e['new']:>6}{flag}"
        )
    print(
        f"{len(entries)} fault-kind count change(s), "
        f"{len(lost)} detection loss(es)"
    )
    return 1 if lost else 0


def _traffic_cells(path: str) -> Dict[Tuple, Dict[str, Any]]:
    """(metric, n, batch_size, rate_frac) -> cell for every traffic-curve
    row (a ``curve`` list of cells plus the optional ``n100`` cell)."""
    with open(path) as f:
        doc = json.load(f)
    rows = doc["rows"] if isinstance(doc, dict) else doc
    out: Dict[Tuple, Dict[str, Any]] = {}
    for r in rows:
        if not isinstance(r.get("curve"), list):
            continue
        cells = list(r["curve"])
        if isinstance(r.get("n100"), dict):
            cells.append(r["n100"])
        for c in cells:
            if not isinstance(c, dict) or "batch_size" not in c:
                continue
            key = (
                r["metric"],
                c.get("n"),
                c["batch_size"],
                c.get("rate_frac"),
            )
            out[key] = c
    return out


def diff_traffic(
    old_path: str, new_path: str, tol: float = 0.10
) -> List[Dict[str, Any]]:
    """Cell-by-cell comparison of traffic curves.  Two regression axes,
    because latency is lower-is-better: sustained tx/s dropping more than
    ``tol``, or p99 commit latency rising more than ``tol``."""
    old, new = _traffic_cells(old_path), _traffic_cells(new_path)
    out: List[Dict[str, Any]] = []
    for key in sorted(set(old) | set(new), key=repr):
        o, n = old.get(key), new.get(key)
        entry: Dict[str, Any] = {
            "cell": {
                "metric": key[0], "n": key[1],
                "batch_size": key[2], "rate_frac": key[3],
            }
        }
        if o is None or n is None:
            entry["status"] = "only_in_new" if o is None else "only_in_old"
            entry["regression"] = False
            out.append(entry)
            continue
        o_tx, n_tx = o.get("tx_per_s", 0), n.get("tx_per_s", 0)
        o_p99, n_p99 = o.get("latency_p99", 0), n.get("latency_p99", 0)
        entry["old_tx_per_s"], entry["new_tx_per_s"] = o_tx, n_tx
        entry["old_p99"], entry["new_p99"] = o_p99, n_p99
        entry["tx_regression"] = bool(o_tx and n_tx < o_tx * (1.0 - tol))
        entry["p99_regression"] = bool(o_p99 and n_p99 > o_p99 * (1.0 + tol))
        # SLO-compliance gate (slo_traffic cells carry slo_compliant):
        # a cell — above all the controller's "adaptive" cell — that
        # held the declared SLO in the old capture and lost it in the
        # new one is a regression regardless of throughput ratios
        entry["slo_regression"] = bool(
            o.get("slo_compliant") and n.get("slo_compliant") is False
        )
        entry["regression"] = (
            entry["tx_regression"]
            or entry["p99_regression"]
            or entry["slo_regression"]
        )
        out.append(entry)
    return out


def report_traffic(old_path: str, new_path: str, tol: float) -> int:
    entries = diff_traffic(old_path, new_path, tol)
    if not entries:
        print("no traffic-curve rows found in either capture")
        return 0
    regressed = [e for e in entries if e["regression"]]
    for e in entries:
        c = e["cell"]
        label = f"{c['metric']} n={c['n']} B={c['batch_size']} r={c['rate_frac']}"
        if "status" in e:
            print(f"{label:>44} {e['status']}")
            continue
        flags = "".join(
            f"  {name}" for name, hit in (
                ("TX-REGRESSION", e["tx_regression"]),
                ("P99-REGRESSION", e["p99_regression"]),
                ("SLO-REGRESSION", e.get("slo_regression", False)),
            ) if hit
        )
        print(
            f"{label:>44} tx/s {e['old_tx_per_s']:>10} -> {e['new_tx_per_s']:>10}"
            f"  p99 {e['old_p99']:>7} -> {e['new_p99']:>7}{flags}"
        )
    print(
        f"{len(regressed)} traffic regression(s) beyond {tol:.0%} "
        f"across {len(entries)} cells"
    )
    return 1 if regressed else 0


def report_diff(old_path: str, new_path: str, tol: float) -> int:
    entries = diff_rows(old_path, new_path, tol)
    regressed = [e for e in entries if e["regression"]]
    for e in entries:
        if "ratio" in e:
            flag = "  REGRESSION" if e["regression"] else ""
            ratio = f"{e['ratio']:.3f}x" if e["ratio"] is not None else "n/a"
            print(f"{e['metric']:>40} {e['old']:>12} -> {e['new']:>12} {ratio}{flag}")
        else:
            print(f"{e['metric']:>40} {e['status']}")
    print(
        f"{len(regressed)} regression(s) beyond {tol:.0%} "
        f"across {len(entries)} metrics"
    )
    return 1 if regressed else 0


# ---------------------------------------------------------------------------
# critical-path gating (obs/critpath.py evidence, read dependency-free)
# ---------------------------------------------------------------------------


def _gating_from_gate_rows(rows: List[Dict[str, Any]]) -> Dict[str, float]:
    """Gating histogram from per-epoch series rows (their ``gate.phase``
    field, obs/timeseries.py) — one count per committed epoch."""
    counts: Dict[str, int] = {}
    for r in rows:
        if not isinstance(r, dict):
            continue
        g = r.get("gate")
        if isinstance(g, dict) and g.get("phase"):
            counts[g["phase"]] = counts.get(g["phase"], 0) + 1
    total = sum(counts[k] for k in sorted(counts))
    if not total:
        return {}
    return {k: round(counts[k] / total, 4) for k in sorted(counts)}


def gating_from_trace(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """Per-epoch gating re-derived from a raw Chrome trace: each
    ``cat="epoch"`` span is an epoch window; the phase category (rbc /
    ba / coin / decrypt / crash) with the largest summed duration inside
    the window gates that epoch — the trace-side mirror of
    ``critpath.path_from_phase_seconds``.  ``epoch``/``crank`` spans are
    containers, not phases, so they never gate."""
    spans: List[Dict[str, Any]] = []
    stacks: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for ev in events:
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if stack:
                b = stack.pop()
                spans.append({"cat": b.get("cat", ""), "b": b["ts"], "e": ev["ts"]})
    windows = sorted(
        (s["b"], s["e"]) for s in spans if s["cat"] == "epoch"
    )
    counts: Dict[str, int] = {}
    for wb, we in windows:
        durs: Dict[str, float] = {}
        for s in spans:
            phase = SPAN_CAT_PHASES.get(s["cat"])
            if phase is None or phase in ("epoch.commit", "crank"):
                continue
            if wb <= s["b"] <= we:
                durs[phase] = durs.get(phase, 0.0) + (s["e"] - s["b"])
        if not durs:
            continue
        gate, best = "epoch.commit", -1.0
        for phase in sorted(durs):
            if durs[phase] > best:
                best = durs[phase]
                gate = phase
        counts[gate] = counts.get(gate, 0) + 1
    total = sum(counts[k] for k in sorted(counts))
    if not total:
        return {}
    return {k: round(counts[k] / total, 4) for k in sorted(counts)}


def load_gating(path: str) -> Dict[str, float]:
    """The gating histogram from whichever evidence ``path`` holds:
    a per-epoch series ``.jsonl`` (rows carry ``gate``), a forensics
    bundle (``critical_path.gating``), a BENCH/soak capture whose rows
    carry a ``gating`` field (averaged across rows), or a raw Chrome
    trace (re-gated from span categories)."""
    if path.endswith(".jsonl"):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return _gating_from_gate_rows(rows)
    with open(path) as f:
        doc = json.load(f)
    rows: Any = None
    if isinstance(doc, dict):
        if doc.get("kind") == "forensics":
            cp = doc.get("critical_path") or {}
            return dict(cp.get("gating") or {})
        if "traceEvents" in doc:
            return gating_from_trace(doc["traceEvents"])
        rows = doc.get("rows")
    elif isinstance(doc, list):
        rows = doc
    if isinstance(rows, list):
        g = _gating_from_gate_rows(rows)
        if g:
            return g
        per_row = [
            r["gating"]
            for r in rows
            if isinstance(r, dict) and isinstance(r.get("gating"), dict) and r["gating"]
        ]
        if per_row:
            acc: Dict[str, float] = {}
            for g in per_row:
                for phase in sorted(g):
                    acc[phase] = acc.get(phase, 0.0) + g[phase]
            return {phase: round(acc[phase] / len(per_row), 4) for phase in sorted(acc)}
    raise ValueError(
        f"{path}: no gating evidence (expected series .jsonl, forensics "
        "bundle, rows with a 'gating' field, or a Chrome trace)"
    )


def gating_shifts(
    old: Dict[str, float], new: Dict[str, float], tol: float = 0.10
) -> List[Dict[str, Any]]:
    """Phase-share shifts beyond ``tol`` ABSOLUTE share points between
    two gating histograms (inline twin of ``critpath.diff_gating``) —
    'coin went from gating 20% of epochs to 45%' is a >tol shift even
    though both captures pass every throughput gate."""
    out: List[Dict[str, Any]] = []
    for phase in sorted(set(old) | set(new)):
        a, b = old.get(phase, 0.0), new.get(phase, 0.0)
        if abs(b - a) > tol:
            out.append(
                {
                    "phase": phase,
                    "old": round(a, 4),
                    "new": round(b, 4),
                    "shift": round(b - a, 4),
                }
            )
    return out


def report_critical_path(paths: List[str], tol: float) -> int:
    if len(paths) == 1:
        gating = load_gating(paths[0])
        if not gating:
            print(f"{paths[0]}: no gated epochs")
            return 0
        print(f"{'gating phase':>18} {'share':>7}")
        for phase in sorted(gating, key=lambda p: (-gating[p], p)):
            print(f"{phase:>18} {gating[phase]:>6.1%}")
        return 0
    old, new = load_gating(paths[0]), load_gating(paths[1])
    shifts = gating_shifts(old, new, tol)
    shifted = {s["phase"] for s in shifts}
    print(f"{'gating phase':>18} {'old':>7} {'new':>7} {'shift':>8}")
    for phase in sorted(set(old) | set(new)):
        a, b = old.get(phase, 0.0), new.get(phase, 0.0)
        flag = "  SHIFT" if phase in shifted else ""
        print(f"{phase:>18} {a:>6.1%} {b:>6.1%} {b - a:>+7.1%}{flag}")
    print(
        f"{len(shifts)} gating shift(s) beyond {tol:.0%} share points "
        f"across {len(set(old) | set(new))} phases"
    )
    return 1 if shifts else 0


# ---------------------------------------------------------------------------
# forensics bundles (obs/flight.py dumps, validated dependency-free)
# ---------------------------------------------------------------------------


def validate_forensics(doc: Any) -> List[str]:
    """Structural checks on a flight-recorder bundle (inline twin of
    ``obs/flight.validate_bundle``): required keys, version/kind,
    monotonic frame epochs, gating shares in range and summing to 1,
    every phase name inside the critpath registry."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not a JSON object"]
    for k in REQUIRED_FORENSICS_KEYS:
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
    for phase in sorted(cp["gating"]):
        share = cp["gating"][phase]
        if phase not in CRITPATH_PHASES:
            errors.append(f"gating phase {phase!r} not in the critpath registry")
        if not 0.0 <= share <= 1.0001:
            errors.append(f"gating share out of range for {phase!r}: {share}")
        share_sum += share
    if cp["gating"] and not 0.99 <= share_sum <= 1.01:
        errors.append(f"gating shares sum to {share_sum:.4f}, not 1")
    for j, p in enumerate(cp["paths"]):
        if p.get("gate_phase") not in CRITPATH_PHASES:
            errors.append(f"path {j} gate_phase {p.get('gate_phase')!r} unknown")
    return errors


def summarize_forensics(doc: Dict[str, Any]) -> List[str]:
    """Human summary lines for a valid bundle (mirrors
    ``obs/flight.summarize_bundle``)."""
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
            str(cell.get(k))
            for k in ("attack", "schedule", "churn", "crash", "traffic")
        )
        lines.append(f"  cell: {axes} n={cell.get('n')} seed={cell.get('seed')}")
    cp = doc.get("critical_path") or {}
    if cp.get("gate"):
        lines.append(f"  gate: {cp['gate']}")
    gating = cp.get("gating") or {}
    for phase in sorted(gating, key=lambda p: (-gating[p], p)):
        lines.append(f"  gating {phase}: {gating[phase] * 100:.1f}%")
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


def report_forensics(paths: List[str]) -> int:
    rc = 0
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: UNREADABLE ({e})")
            rc = 1
            continue
        errors = validate_forensics(doc)
        if errors:
            print(f"{path}: INVALID ({len(errors)} error(s))")
            for e in errors[:20]:
                print("  " + e)
            rc = 1
            continue
        lines = summarize_forensics(doc)
        print(f"{path}: valid")
        for line in lines:
            print("  " + line)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+", help="TRACE, or OLD NEW with --diff")
    p.add_argument(
        "--diff", action="store_true",
        help="treat the two paths as BENCH_rows.json files to compare",
    )
    p.add_argument(
        "--faults", action="store_true",
        help="diff fault-kind counts between two BENCH_rows.json files "
        "(rows carrying a fault_kinds field, e.g. scenario_matrix); "
        "exit 1 when a previously-detected kind vanished",
    )
    p.add_argument(
        "--traffic", action="store_true",
        help="diff qhb_traffic throughput/latency curves cell by cell "
        "between two BENCH_rows.json files; a >tol tx/s drop or >tol "
        "p99 commit-latency rise exits 1",
    )
    p.add_argument(
        "--critical-path", action="store_true",
        help="print the run-level gating histogram from gating evidence "
        "(series .jsonl / forensics bundle / rows with 'gating' / Chrome "
        "trace); with two paths, diff them — a phase share shifting more "
        "than --tol absolute points exits 1",
    )
    p.add_argument(
        "--forensics", action="store_true",
        help="validate each flight-recorder forensics bundle and print "
        "its summary; exit 1 when any bundle is invalid",
    )
    p.add_argument(
        "--tol", type=float, default=0.10,
        help="relative drop flagged as a regression (default 0.10)",
    )
    p.add_argument(
        "--device-seconds", type=float, default=None,
        help="validate that the trace's device=True spans sum to this "
        "counter value within --device-tol (exit 1 on mismatch) — the "
        "pipelined-dispatch acceptance check",
    )
    p.add_argument(
        "--device-tol", type=float, default=0.05,
        help="relative tolerance for --device-seconds (default 0.05)",
    )
    p.add_argument(
        "--host-buckets", type=float, default=None,
        help="validate that the trace's host=True bucket spans sum to "
        "this counter value (counters.host_seconds) within --device-tol "
        "AND that the 'other' (unattributed) bucket stays under "
        "--host-unattributed-max of it; exit 1 on mismatch — the host-"
        "attribution acceptance check",
    )
    p.add_argument(
        "--host-unattributed-max", type=float, default=0.10,
        help="max unattributed ('other') share for --host-buckets "
        "(default 0.10)",
    )
    p.add_argument(
        "--host-folded-device", type=float, default=0.0,
        help="device seconds of work folded OUT of the host buckets by "
        "the device erasure/hash plane (counters.device_seconds_rs_enc "
        "+ _rs_dec + _merkle); the --host-buckets unattributed bound is "
        "judged against host_seconds + this, so a run with encode/"
        "rs_merkle legitimately ~0 does not trip the gate",
    )
    args = p.parse_args(argv)
    if args.forensics:
        return report_forensics(args.paths)
    if args.critical_path:
        if len(args.paths) not in (1, 2):
            p.error("--critical-path takes one path (report) or two (diff)")
        return report_critical_path(args.paths, args.tol)
    if args.traffic:
        if len(args.paths) != 2:
            p.error("--traffic needs exactly two BENCH_rows.json paths")
        rc = report_traffic(args.paths[0], args.paths[1], args.tol)
        if args.diff:
            rc = max(rc, report_diff(args.paths[0], args.paths[1], args.tol))
        return rc
    if args.faults:
        if len(args.paths) != 2:
            p.error("--faults needs exactly two BENCH_rows.json paths")
        rc = report_faults(args.paths[0], args.paths[1])
        if args.diff:
            rc = max(rc, report_diff(args.paths[0], args.paths[1], args.tol))
        return rc
    if args.diff:
        if len(args.paths) != 2:
            p.error("--diff needs exactly two BENCH_rows.json paths")
        return report_diff(args.paths[0], args.paths[1], args.tol)
    if len(args.paths) != 1:
        p.error("exactly one trace path (or --diff OLD NEW)")
    return report(
        args.paths[0], args.device_seconds, args.device_tol,
        args.host_buckets, args.host_unattributed_max,
        args.host_folded_device,
    )


if __name__ == "__main__":
    sys.exit(main())
