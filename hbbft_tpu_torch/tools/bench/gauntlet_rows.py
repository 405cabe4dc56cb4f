"""The gauntlet, traffic and mesh rows: the adversary × schedule matrix,
the composed crash gauntlet, the QueueingHoneyBadger traffic curve, the
SLO-driven batch controller, and the per-entry dispatcher's structure.

The JAX bench runs the first four on the reference library's mock (its
default, or its knobs' ``mock``).  The port's library defaults to the
card, so these rows name the port's ``MockBackend`` themselves, and their
``backend`` field says so: a mock row measures the protocol layer, as the
JAX bench defines it.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import time

from hbbft_tpu_torch.tools.bench.common import ROOT, _env_int, device, make_backend


def bench_scenario_matrix() -> dict:
    """The adversary × network-schedule liveness matrix (net/scenarios.py)
    at the fast shape (N∈{4,7}, all attacks × 2 schedules, MockBackend):
    every cell must commit identical Batches on all honest nodes with the
    expected fault kinds attributed.  ``fault_kinds`` feeds
    ``tools/trace_report.py --faults``."""
    from hbbft_tpu_torch.crypto.backend import MockBackend
    from hbbft_tpu_torch.net.scenarios import run_matrix

    ns = [int(x) for x in os.environ.get("BENCH_SCEN_NS", "4,7").split(",")]
    schedules = os.environ.get("BENCH_SCEN_SCHEDULES", "uniform,partition_heal")
    t0 = time.perf_counter()
    results = run_matrix(ns=ns, schedules=tuple(schedules.split(",")), epochs=1,
                         backend_factory=MockBackend)
    dt = time.perf_counter() - t0
    n_ok = sum(1 for r in results if r.ok)
    fault_kinds: dict = {}
    for r in results:
        for kind, cnt in r.fault_kinds.items():
            fault_kinds[kind] = fault_kinds.get(kind, 0) + cnt
    failed = [
        {"attack": r.attack, "schedule": r.schedule, "n": r.n, "error": r.error}
        for r in results
        if not r.ok
    ]
    return {
        "metric": "scenario_matrix",
        "value": round(len(results) / dt, 2),
        "unit": "cells/s",
        "vs_baseline": 1.0,
        "baseline": "estimated",
        "cells": len(results),
        "cells_ok": n_ok,
        "all_ok": n_ok == len(results),
        "fault_kinds": dict(sorted(fault_kinds.items())),
        "failed_cells": failed,
        "backend": "MockBackend",
    }


def _histogram_summary(values: list) -> dict:
    if not values:
        return {"count": 0}
    s = sorted(values)
    return {
        "count": len(s),
        "min": s[0],
        "max": s[-1],
        "mean": round(sum(s) / len(s), 1),
    }


def bench_crash_matrix() -> dict:
    """The composed gauntlet (net/scenarios.py Cell runner): attack ×
    net-schedule × churn × crash+restart × traffic soaks with the full
    verdict set — honest Batches bit-identical, every fault attributed,
    restarted nodes recommitted within the gate, stable seeded-replay
    fingerprints.  Knobs: BENCH_CRASH_N / BENCH_CRASH_EPOCHS /
    BENCH_CRASH_CELLS (cell specs, comma-separated) / BENCH_CRASH_BACKEND
    (mock|cpu|torch: real crypto routes the restored node's replay
    re-verifies through the device)."""
    from hbbft_tpu_torch.net.scenarios import Cell, run_cell

    backend_name = os.environ.get("BENCH_CRASH_BACKEND", "mock")
    n = int(os.environ.get("BENCH_CRASH_N", "5"))
    epochs = int(os.environ.get("BENCH_CRASH_EPOCHS", "12"))
    specs = os.environ.get(
        "BENCH_CRASH_CELLS",
        "equivocate:partition_heal:era_flip:one_restart:one_x,"
        "crafted_shares:wan:era_flip:two_restarts:two_x,"
        "replay_flood:lan:none:one_restart:half_x",
    ).split(",")
    t0 = time.perf_counter()
    results = []
    for spec in specs:
        parts = (spec.split(":") + ["none"] * 5)[:5]
        cell = Cell(
            attack=parts[0], schedule=parts[1], churn=parts[2],
            crash=parts[3], traffic=parts[4], n=n, epochs=epochs, seed=1,
        )
        results.append(run_cell(cell, backend=make_backend(backend_name)))
    dt = time.perf_counter() - t0
    n_ok = sum(1 for r in results if r.ok)
    fault_kinds: dict = {}
    recovery_cranks = []
    for r in results:
        for kind, cnt in r.fault_kinds.items():
            fault_kinds[kind] = fault_kinds.get(kind, 0) + cnt
        recovery_cranks.extend(rec.get("down_cranks", 0) for rec in r.recoveries)
    failed = [
        {"cell": r.cell.cell_id(), "error": r.error,
         "missing": r.missing_expected, "misattributed": r.misattributed[:4]}
        for r in results
        if not r.ok
    ]
    return {
        "metric": "crash_matrix",
        "value": round(len(results) / dt, 2),
        "unit": "cells/s",
        "vs_baseline": 1.0,
        "baseline": "estimated",
        "cells": len(results),
        "cells_ok": n_ok,
        "all_ok": n_ok == len(results),
        "crashes": sum(r.crashes for r in results),
        "restarts": sum(r.restarts for r in results),
        "recovered_in_time": all(r.recovered_in_time for r in results),
        "recovery_cranks": _histogram_summary(recovery_cranks),
        "tx_committed": sum(r.tx_committed for r in results),
        "commit_p99_max": max((r.commit_p99 for r in results), default=0.0),
        "fault_kinds": dict(sorted(fault_kinds.items())),
        "failed_cells": failed,
        "backend": backend_name,
    }


def bench_qhb_traffic() -> dict:
    """The QueueingHoneyBadger batch-size × arrival-rate curve: open-loop
    Poisson client load (Zipf population, BENCH_QHB_CLIENTS) against
    per-node bounded mempools, QHB-style random samples driven through
    ArrayHoneyBadgerNet lockstep epochs, per-tx commit latency tracked end
    to end.  Each grid cell records committed tx/s (wall), tx/epoch,
    p50/p90/p99 commit latency in epochs, mempool depth and admission
    drops; arrival rates are fractions of the nominal per-epoch proposal
    capacity N·batch_size, so >1.0 cells measure overload (``overload``
    summary fields).  One N=100 f=33 point rides along (fanout="one").
    ``vs_baseline`` compares wall tx/s against the single-core reference
    committing the same tx/epoch at the estimated 0.25 epochs/s."""
    from hbbft_tpu_torch.engine import ArrayHoneyBadgerNet
    from hbbft_tpu_torch.obs import Tracer
    from hbbft_tpu_torch.traffic import (
        ArrayTrafficDriver,
        OpenLoopSource,
        PayloadSizes,
        ZipfPopulation,
    )

    n = _env_int("BENCH_QHB_N", 16)
    epochs = _env_int("BENCH_QHB_EPOCHS", 4)
    clients = _env_int("BENCH_QHB_CLIENTS", 10_000)
    batches = [int(x) for x in os.environ.get("BENCH_QHB_BATCHES", "16,64,256").split(",")]
    fracs = [float(x) for x in os.environ.get("BENCH_QHB_RATES", "0.5,1.0,2.0").split(",")]
    backend_name = os.environ.get("BENCH_QHB_BACKEND", "mock")
    backend_label = backend_name  # refined to backend.name by the first cell

    def cell(n_, batch_size, frac, epochs_, fanout):
        nonlocal backend_label
        backend = make_backend(backend_name)
        backend_label = backend.name
        tracer = Tracer(spans=False)
        backend.tracer = tracer
        net = ArrayHoneyBadgerNet(range(n_), backend=backend, seed=0, dynamic=True,
                                  tracer=tracer)
        rate = frac * n_ * batch_size
        # capacity ~2 epochs of offered load at saturation: small enough
        # that the overload cells actually exercise the bound
        cap = max(64, 2 * n_ * batch_size)
        src = OpenLoopSource(rate, ZipfPopulation(clients, 1.1), PayloadSizes("fixed", 32))
        drv = ArrayTrafficDriver(
            net, src, random.Random(1234), batch_size=batch_size,
            mempool_capacity=cap, fanout=fanout, tracer=tracer,
        )
        t0 = time.perf_counter()
        rep = drv.run(epochs_)
        dt = time.perf_counter() - t0
        lat = rep["tracker"]["commit_latency"]
        return {
            "n": n_,
            "batch_size": batch_size,
            "rate_frac": frac,
            "rate_per_epoch": round(rate, 1),
            "epochs": epochs_,
            "committed": rep["committed"],
            "tx_per_epoch": rep["tx_per_epoch"],
            "tx_per_s": round(rep["committed"] / dt, 2) if dt > 0 else 0.0,
            "epochs_per_s": round(epochs_ / dt, 4) if dt > 0 else 0.0,
            "latency_p50": lat.get("p50", 0.0),
            "latency_p90": lat.get("p90", 0.0),
            "latency_p99": lat.get("p99", 0.0),
            "mempool_capacity": cap,
            "mempool_peak_depth": rep["mempool_peak_depth"],
            "dropped": rep["mempool_dropped"],
            "backpressure_epochs": rep["backpressure_epochs"],
            "state": rep["status"]["state"],
            "fanout": fanout,
        }

    curve = [cell(n, b, frac, epochs, "all") for b in batches for frac in fracs]

    # overload acceptance summary: per batch size, committed tx/epoch at
    # every rate above saturation vs the frac==1.0 plateau, and whether
    # the mempool bound held (peak depth never exceeded capacity)
    overload = []
    for b in batches:
        plateau = next(
            (c["tx_per_epoch"] for c in curve
             if c["batch_size"] == b and abs(c["rate_frac"] - 1.0) < 1e-9),
            None,
        )
        for c in curve:
            if c["batch_size"] != b or c["rate_frac"] <= 1.0 or not plateau:
                continue
            overload.append(
                {
                    "batch_size": b,
                    "rate_frac": c["rate_frac"],
                    "plateau_ratio": round(c["tx_per_epoch"] / plateau, 3),
                    "bounded": c["mempool_peak_depth"] <= c["mempool_capacity"],
                    "named_saturated": c["state"] == "saturated",
                }
            )

    n100_cell = None
    if os.environ.get("BENCH_QHB_N100", "1") == "1":
        n100_cell = cell(
            _env_int("BENCH_QHB_N100_N", 100),
            _env_int("BENCH_QHB_N100_BATCH", 128),
            1.0,
            _env_int("BENCH_QHB_N100_EPOCHS", 2),
            "one",
        )

    best = max(curve, key=lambda c: c["tx_per_s"])
    baseline_tx_per_s = 0.25 * best["tx_per_epoch"]  # single-core est.
    row = {
        "metric": "qhb_traffic",
        "value": best["tx_per_s"],
        "unit": "tx/s",
        "vs_baseline": (
            round(best["tx_per_s"] / baseline_tx_per_s, 3) if baseline_tx_per_s else 0.0
        ),
        "baseline": "estimated",
        "backend": backend_label,
        "n": n,
        "epochs": epochs,
        "clients": clients,
        "best_cell": {
            "batch_size": best["batch_size"],
            "rate_frac": best["rate_frac"],
            "latency_p99": best["latency_p99"],
        },
        "curve": curve,
        "overload": overload,
        # null, not False, when no >1.0x cell had a plateau reference —
        # "no data" must not read as "bound violated"
        "overload_bounded": all(o["bounded"] for o in overload) if overload else None,
        "overload_plateau_held": (
            all(o["plateau_ratio"] >= 0.9 for o in overload) if overload else None
        ),
    }
    if n100_cell is not None:
        row["n100"] = n100_cell
    return row


def bench_slo_traffic() -> dict:
    """The control-plane row: SLO-driven adaptive batch sizing vs every
    fixed-B cell under the 10×-swing load trace.  One declared SLO (p99
    commit latency ≤ BENCH_SLO_P99 epochs), one replayable trace
    (BENCH_SLO_TRACE, default swing10x), a 10⁶-client Zipf population over
    sharded mempools, and per cell either a fixed batch size from
    BENCH_SLO_BATCHES or the AdaptiveBatchController walking the ladder.
    A final kill-switch arm re-runs the controller cell under
    ``HBBFT_TPU_NO_ADAPTIVE_B=1`` and checks bit-identical batch digests
    and tracker fingerprint against the fixed cell at the controller's
    initial B (``killswitch_identical``).  ``vs_baseline`` is controller
    tx/s over the best SLO-compliant fixed cell's tx/s."""
    from hbbft_tpu_torch.control import SLO, AdaptiveBatchController, make_trace
    from hbbft_tpu_torch.engine import ArrayHoneyBadgerNet
    from hbbft_tpu_torch.obs import Tracer
    from hbbft_tpu_torch.traffic import (
        ArrayTrafficDriver,
        OpenLoopSource,
        PayloadSizes,
        ZipfPopulation,
    )

    n = _env_int("BENCH_SLO_N", 16)
    epochs = _env_int("BENCH_SLO_EPOCHS", 24)
    clients = _env_int("BENCH_SLO_CLIENTS", 1_000_000)
    shards = _env_int("BENCH_SLO_SHARDS", 16)
    b0 = _env_int("BENCH_SLO_B0", 32)
    p99_target = float(os.environ.get("BENCH_SLO_P99", "4.0"))
    trace_name = os.environ.get("BENCH_SLO_TRACE", "swing10x")
    rate = float(os.environ.get("BENCH_SLO_RATE", str(6.25 * n)))
    batches = [int(x) for x in os.environ.get("BENCH_SLO_BATCHES", "8,32,128,512").split(",")]
    backend_name = os.environ.get("BENCH_SLO_BACKEND", "mock")
    backend_label = backend_name
    slo = SLO(p99_epochs=p99_target)
    # one capacity for every cell (fairness): ~4 epochs of peak load
    trace = make_trace(trace_name)
    cap = max(256, int(4 * rate * trace.peak()))

    def cell(batch_size, adaptive):
        nonlocal backend_label
        backend = make_backend(backend_name)
        backend_label = backend.name
        tracer = Tracer(spans=False)
        backend.tracer = tracer
        net = ArrayHoneyBadgerNet(range(n), backend=backend, seed=0, dynamic=True,
                                  tracer=tracer)
        src = OpenLoopSource(rate, ZipfPopulation(clients, 1.1), PayloadSizes("fixed", 32),
                             trace=make_trace(trace_name))
        controller = AdaptiveBatchController(slo, initial_b=batch_size) if adaptive else None
        drv = ArrayTrafficDriver(
            net, src, random.Random(1234), batch_size=batch_size,
            mempool_capacity=cap, fanout="all", tracer=tracer,
            controller=controller, mempool_shards=shards,
        )
        digest = hashlib.sha256()

        def on_batches(batches_map):
            b = batches_map[net.ids[0]]
            for p in net.ids:
                digest.update(bytes(b.contributions[p]))

        net.batch_listeners.append(on_batches)
        t0 = time.perf_counter()
        rep = drv.run(epochs)
        dt = time.perf_counter() - t0
        lat = rep["tracker"]["commit_latency"]
        p99 = lat.get("p99", 0.0)
        out = {
            "n": n,
            "batch_size": "adaptive" if adaptive else batch_size,
            "epochs": epochs,
            "committed": rep["committed"],
            "tx_per_epoch": rep["tx_per_epoch"],
            "tx_per_s": round(rep["committed"] / dt, 2) if dt > 0 else 0.0,
            "epochs_per_s": round(epochs / dt, 4) if dt > 0 else 0.0,
            "latency_p50": lat.get("p50", 0.0),
            "latency_p99": p99,
            "slo_compliant": bool(slo.compliant(p99 or None)),
            "mempool_peak_depth": rep["mempool_peak_depth"],
            "dropped": rep["mempool_dropped"],
            "state": rep["status"]["state"],
            "batch_digest": digest.hexdigest(),
            "tracker_fingerprint": hashlib.sha256(
                repr(sorted(drv.tracker.fingerprint().items())).encode()
            ).hexdigest(),
        }
        if adaptive:
            out["b_trace"] = rep["controller"]["b_trace"]
            out["steps_up"] = rep["controller"]["steps_up"]
            out["steps_down"] = rep["controller"]["steps_down"]
        return out

    fixed_cells = [cell(b, adaptive=False) for b in batches]
    adaptive_cell = cell(b0, adaptive=True)

    # kill-switch arm: the controller cell pinned to its initial rung must
    # be bit-identical to the fixed-B0 cell (digest + fingerprint)
    saved = os.environ.get("HBBFT_TPU_NO_ADAPTIVE_B")
    os.environ["HBBFT_TPU_NO_ADAPTIVE_B"] = "1"
    try:
        killswitch_cell = cell(b0, adaptive=True)
    finally:
        if saved is None:
            os.environ.pop("HBBFT_TPU_NO_ADAPTIVE_B", None)
        else:
            os.environ["HBBFT_TPU_NO_ADAPTIVE_B"] = saved
    fixed_b0 = next((c for c in fixed_cells if c["batch_size"] == b0), None)
    if fixed_b0 is None:
        fixed_b0 = cell(b0, adaptive=False)
    killswitch_identical = (
        killswitch_cell["batch_digest"] == fixed_b0["batch_digest"]
        and killswitch_cell["tracker_fingerprint"] == fixed_b0["tracker_fingerprint"]
    )

    compliant_fixed = [c for c in fixed_cells if c["slo_compliant"]]
    best_fixed_compliant = max((c["tx_per_s"] for c in compliant_fixed), default=0.0)
    beats = all(
        (not c["slo_compliant"]) or c["tx_per_s"] < adaptive_cell["tx_per_s"]
        for c in fixed_cells
    )
    return {
        "metric": "slo_traffic",
        "value": adaptive_cell["tx_per_s"],
        "unit": "tx/s",
        "vs_baseline": (
            round(adaptive_cell["tx_per_s"] / best_fixed_compliant, 3)
            if best_fixed_compliant
            else 0.0
        ),
        "baseline": "best SLO-compliant fixed-B cell",
        "backend": backend_label,
        "n": n,
        "epochs": epochs,
        "clients": clients,
        "mempool_shards": shards,
        "mempool_capacity": cap,
        "rate_per_epoch": rate,
        "trace": trace.describe(),
        "slo": slo.describe(),
        "initial_b": b0,
        "curve": fixed_cells + [adaptive_cell],
        "controller_compliant": adaptive_cell["slo_compliant"],
        "controller_beats_fixed": beats,
        "killswitch_identical": killswitch_identical,
    }


def bench_mesh_scaling() -> dict:
    """The per-entry pipelined dispatcher (parallel/shardpipe.py) over
    meshes of 1/2/4/8 entries, one ``hbbft_tpu_torch.tools.mesh_probe``
    child process a size, reporting structural facts: deterministic
    round-robin placements, balanced per-entry tallies, imbalance 1.0
    for divisible chunk counts, correct results.  On one card the entries
    are entries of that card (one CUDA stream each), so chunks/s is not a
    scale-out measurement (``virtual_mesh``).  Knobs: BENCH_MESH_SIZES /
    BENCH_MESH_CHUNKS / BENCH_MESH_LANES."""
    sizes = [int(x) for x in os.environ.get("BENCH_MESH_SIZES", "1,2,4,8").split(",")]
    chunks = int(os.environ.get("BENCH_MESH_CHUNKS", "64"))
    lanes = os.environ.get("BENCH_MESH_LANES", "4096")
    t0 = time.perf_counter()
    meshes = []
    failed = []
    for k in sizes:
        proc = subprocess.run(
            [sys.executable, "-m", "hbbft_tpu_torch.tools.mesh_probe", "--devices", str(k),
             "--chunks", str(chunks), "--lanes", lanes, "--device", device()],
            capture_output=True,
            text=True,
            timeout=300,
            cwd=ROOT,
        )
        if proc.returncode != 0 or not proc.stdout.strip():
            failed.append({"devices": k, "error": proc.stderr[-500:]})
            continue
        meshes.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    dt = time.perf_counter() - t0
    structural_ok = bool(meshes) and not failed and all(
        m["placements_ok"] and m["balanced"] and m["results_ok"] for m in meshes
    )
    widest = meshes[-1] if meshes else {}
    return {
        "metric": "mesh_scaling",
        "value": widest.get("chunks_per_s", 0.0),
        "unit": f"chunks/s@{widest.get('devices', 0)}dev",
        "vs_baseline": 1.0,
        "baseline": "estimated",
        "virtual_mesh": True,  # structural only — never a scale-out claim
        "chunks": chunks,
        "meshes": meshes,
        "all_ok": structural_ok,
        "imbalance_max": max((m["imbalance"] for m in meshes), default=0.0),
        "failed": failed,
        "wall_s": round(dt, 2),
    }
