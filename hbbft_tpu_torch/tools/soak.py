"""Composed-gauntlet soak CLI (net/scenarios.py Cell runner) — the port's
``tools/soak.py``.

Runs multi-epoch deterministic soaks over the full cell product —
attack × net-schedule × churn-schedule × crash-schedule × traffic-source
— and gates each cell on the gauntlet verdicts: honest Batches
bit-identical, every fault attributed to a faulty node, restarted nodes
recommitted within the gate, why_stalled naming the dominant cause in
every stalled cell, and p99 commit latency bounded vs the clean cell.

Usage::

    python -m hbbft_tpu_torch.tools.soak                  # default suite, the card
    python -m hbbft_tpu_torch.tools.soak --backend mock --smoke
                                                 # one deterministic cell, twice
    python -m hbbft_tpu_torch.tools.soak --cells \
        equivocate:partition_heal:era_flip:one_restart:one_x \
        --n 16 --epochs 200 --seeds 1,2
    python -m hbbft_tpu_torch.tools.soak --json soak.json --fail-dir failed
    python -m hbbft_tpu_torch.tools.soak --replay failed/<cell>.json
                                                 # reproduce a failed cell
                                                 # from its record (cell +
                                                 # seed + fingerprint) alone
    python -m hbbft_tpu_torch.tools.soak --race-cex cx.json
                                                 # fold a race-explorer
                                                 # minimized counterexample
                                                 # in as a first-class cell

Cell syntax: ``attack:schedule[:churn[:crash[:traffic]]]`` with names
from the net/scenarios.py registries (missing axes default to "none").

Exit status: 0 when every cell passed its verdict; 1 when any failed
(failed cells are written to --fail-dir as replayable records); 2 when a
--replay did not reproduce the recorded fingerprint.

Backends (``--backend``, one fresh backend per cell): ``torch`` (the
default) is ``TorchBackend()`` on the card, and raises without one;
``cpu`` is ``TorchBackend(device="cpu")``; ``mesh`` is ``MeshBackend()``
over the host's cards and ``mesh-cpu`` the same over CPU entries (the
simulation CLI's ``make_backend``); ``mock`` is ``MockBackend()``, the
protocol logic with no real crypto.  A ``--race-cex`` cell replays
the explorer's counterexample on the targets' own ``MockBackend``
(``analysis/schedules.py``), whatever ``--backend`` says.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

from hbbft_tpu_torch.net.scenarios import (
    ATTACKS,
    CHURNS,
    CRASHES,
    SCHEDULES,
    TRAFFICS,
    Cell,
    run_cell,
)
from hbbft_tpu_torch.tools.simulation import BACKENDS, make_backend

#: p99 bound vs the clean cell: composed conditions (a 30·N²-crank
#: partition, an outage, overload) legitimately stretch the tail; beyond
#: this multiple the degradation is no longer "bounded" and the cell
#: fails.  Calibration: the N=16 flagship cell sits ~8x its clean
#: baseline (partition dominates); 12x leaves headroom without letting
#: an unbounded tail pass.
P99_MULT = 12.0

#: the default composed suite (fast shapes; the flagship arm is opt-in)
DEFAULT_SUITE = (
    "equivocate:partition_heal:era_flip:one_restart:one_x",
    "crafted_shares:wan:era_flip:two_restarts:two_x",
    "replay_flood:lan:none:one_restart:half_x",
    "withhold_shares:uniform:era_flip:one_restart:one_x",
    "withhold_echo:lossy:none:one_restart:none",
    # control plane in the loop: the SLO-driven adaptive batch
    # controller under the 10x-swing trace composed with churn + a
    # crash/restart — B updates are input-borne, so the restarted
    # node's WAL replay reproduces the exact B history (the b_trace is
    # folded into the cell fingerprint)
    "equivocate:uniform:era_flip:one_restart:swing_adaptive",
)

#: the --smoke cell: equivocator x partition-heal x churn x one
#: crash+restart x 1x traffic (n=5, 12 epochs, seed 3)
SMOKE = "equivocate:partition_heal:era_flip:one_restart:one_x"


def parse_cell_spec(spec: str, n: int, epochs: int, seed: int,
                    batch_size: int) -> Cell:
    parts = spec.split(":")
    if not 2 <= len(parts) <= 5:
        raise SystemExit(f"bad cell spec {spec!r} (attack:schedule[:churn[:crash[:traffic]]])")
    parts = parts + ["none"] * (5 - len(parts))
    attack, schedule, churn, crash, traffic = parts
    for name, registry, label in (
        (attack, ATTACKS, "attack"),
        (schedule, SCHEDULES, "schedule"),
        (churn, CHURNS, "churn"),
        (crash, CRASHES, "crash"),
        (traffic, TRAFFICS, "traffic"),
    ):
        if name not in registry:
            raise SystemExit(
                f"unknown {label} {name!r}; known: {sorted(registry)}"
            )
    return Cell(
        attack=attack, schedule=schedule, churn=churn, crash=crash,
        traffic=traffic, n=n, epochs=epochs, seed=seed,
        batch_size=batch_size,
    )


def clean_cell_for(cell: Cell) -> Cell:
    """The p99 baseline: same shape and traffic, every hostile axis off."""
    return Cell(
        attack="passive", schedule="uniform", churn="none", crash="none",
        traffic=cell.traffic, n=cell.n, epochs=cell.epochs, seed=cell.seed,
        batch_size=cell.batch_size,
    )


def run_one(cell: Cell, clean_p99: dict, crank_limit: int, backend: str) -> dict:
    """Run a cell (and lazily its clean baseline for the p99 gate)."""
    t0 = time.perf_counter()
    r = run_cell(cell, backend=make_backend(backend), crank_limit=crank_limit)
    row = r.row()
    if r.forensics is not None:
        # hidden key: write_failed writes it next to the replay record;
        # stripped before any JSON row dump
        row["_forensics"] = r.forensics
    row["wall_s"] = round(time.perf_counter() - t0, 3)
    row["p99_ok"] = True
    if r.commit_p99 and cell.traffic != "none":
        key = (cell.traffic, cell.n, cell.epochs, cell.seed)
        if key not in clean_p99:
            base = run_cell(
                clean_cell_for(cell), backend=make_backend(backend),
                crank_limit=crank_limit,
            )
            clean_p99[key] = base.commit_p99 or 0.0
        base_p99 = clean_p99[key]
        row["clean_p99"] = base_p99
        row["p99_ok"] = (not base_p99) or r.commit_p99 <= base_p99 * P99_MULT
    row["ok"] = bool(row["ok"] and row["p99_ok"])
    return row


def run_race_cex(path: str) -> dict:
    """A race-explorer minimized counterexample as a first-class cell:
    the cell passes when the seams no longer diverge on the recorded
    schedule (a reproduced divergence is a deterministic, still-open
    failure — reported with the recorded vs observed fingerprints)."""
    from hbbft_tpu_torch.analysis import schedules

    t0 = time.perf_counter()
    rep = schedules.replay_counterexample(path)
    return {
        "cell": f"race-cex:{Path(path).name}",
        "kind": "race_counterexample",
        "ok": not rep["diverged"],
        "diverged": rep["diverged"],
        "reproduced": rep["reproduced"],
        "first_divergence": rep["first_divergence"],
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def write_failed(fail_dir: str, cell: Cell, row: dict):
    """A replayable failed-cell record: the cell (with its seed) + the
    observed fingerprint — everything --replay needs.  When the run
    auto-dumped a forensics bundle (row["_forensics"], from the flight
    recorder) it lands next to the record as <cell>.forensics.json.
    Returns (record_path, bundle_path_or_None)."""
    from hbbft_tpu_torch.obs.flight import write_bundle

    p = Path(fail_dir)
    p.mkdir(parents=True, exist_ok=True)
    bundle = row.pop("_forensics", None)
    out = p / f"{cell.cell_id()}.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(
            {"version": 1, "cell": cell.to_dict(), "fingerprint": row["fingerprint"], "row": row},
            f, indent=2, sort_keys=True, default=repr,
        )
        f.write("\n")
    bpath = None
    if bundle is not None:
        bpath = str(p / f"{cell.cell_id()}.forensics.json")
        write_bundle(bundle, bpath)
    return str(out), bpath


def replay_record(path: str, crank_limit: int, backend: str) -> int:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    cell = Cell.from_dict(doc["cell"])
    r = run_cell(cell, backend=make_backend(backend), crank_limit=crank_limit)
    fp = r.fingerprint()
    match = fp == doc["fingerprint"]
    print(
        f"replay: {cell.cell_id()} ok={r.ok} "
        f"fingerprint={'REPRODUCED' if match else 'DIVERGED'}"
    )
    if not match:
        print(f"  recorded {doc['fingerprint']}")
        print(f"  observed {fp}")
    return 0 if match else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=None,
                    help="cell specs attack:schedule[:churn[:crash[:traffic]]]")
    ap.add_argument("--smoke", action="store_true",
                    help="one fast composed cell, run twice, fingerprint-stable (CI)")
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=3)
    ap.add_argument("--seeds", default="1",
                    help="comma-separated seeds (each cell runs per seed)")
    ap.add_argument("--crank-limit", type=int, default=50_000_000)
    ap.add_argument("--json", help="write all cell rows here")
    ap.add_argument("--fail-dir",
                    default=os.path.join(tempfile.gettempdir(), "hbbft_soak_failed"),
                    help="replayable records of failed cells land here")
    ap.add_argument("--replay", help="re-run a failed-cell record; exit 2 on fingerprint mismatch")
    ap.add_argument("--race-cex", nargs="*", default=(),
                    help="race-explorer counterexample files to fold in as cells")
    ap.add_argument(
        "--backend", choices=BACKENDS, default="torch",
        help="torch = TorchBackend() on the card (raises without one); cpu = "
        "TorchBackend(device='cpu'); mesh = MeshBackend() over the host's cards; "
        "mesh-cpu = MeshBackend over CPU entries; mock = MockBackend() (no real crypto)",
    )
    args = ap.parse_args(argv)

    if args.replay:
        return replay_record(args.replay, args.crank_limit, args.backend)

    rows = []
    rc = 0
    clean_p99: dict = {}

    if args.smoke:
        cell = parse_cell_spec(SMOKE, n=5, epochs=12, seed=3, batch_size=3)
        row = run_one(cell, clean_p99, args.crank_limit, args.backend)
        again = run_cell(
            cell, backend=make_backend(args.backend), crank_limit=args.crank_limit
        )
        row["fingerprint_stable"] = again.fingerprint() == row["fingerprint"]
        row["ok"] = bool(row["ok"] and row["fingerprint_stable"])
        rows.append(row)
    else:
        specs = args.cells if args.cells else list(DEFAULT_SUITE)
        for spec in specs:
            for seed in (int(s) for s in args.seeds.split(",")):
                cell = parse_cell_spec(
                    spec, n=args.n, epochs=args.epochs, seed=seed,
                    batch_size=args.batch_size,
                )
                rows.append(run_one(cell, clean_p99, args.crank_limit, args.backend))

    for path in args.race_cex:
        rows.append(run_race_cex(path))

    for row in rows:
        ok = row["ok"]
        name = row["cell"]
        if row.get("kind") == "race_counterexample":
            extra = f" diverged={row['diverged']} reproduced={row['reproduced']}"
        else:
            extra = (
                f" epochs={row.get('epochs_committed')}"
                f" eras={row.get('eras')}"
                f" crashes={row.get('crashes')}/{row.get('restarts')}"
                f" tx={row.get('tx_committed')} p99={row.get('commit_p99')}"
            )
            if not row.get("p99_ok", True):
                extra += f" P99-UNBOUNDED(clean={row.get('clean_p99')})"
            if "fingerprint_stable" in row:
                extra += f" stable={row['fingerprint_stable']}"
            if row.get("error"):
                extra += f" error={row['error']!r}"
        # the --smoke transcript is identical across runs: wall time
        # stays in the JSON rows only
        wall = "" if args.smoke else f" ({row['wall_s']}s)"
        print(f"soak: {'ok  ' if ok else 'FAIL'} {name}{extra}{wall}")
        if not ok:
            rc = 1
            if "fingerprint" in row:
                cell = Cell.from_dict({k: row[k] for k in Cell.__dataclass_fields__ if k in row})
                rec, bpath = write_failed(args.fail_dir, cell, row)
                print(f"soak:      replay record -> {rec}")
                if bpath:
                    print(f"soak:      forensics bundle -> {bpath}")

    if args.json:
        # hidden evidence keys (full forensics bundles) stay out of the
        # row dump — they live as standalone .forensics.json files
        slim = [{k: v for k, v in row.items() if not k.startswith("_")} for row in rows]
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"rows": slim}, f, indent=2, sort_keys=True, default=repr)
            f.write("\n")
    print(f"soak: {sum(1 for r in rows if r['ok'])}/{len(rows)} cells ok")
    return rc


if __name__ == "__main__":
    sys.exit(main())
