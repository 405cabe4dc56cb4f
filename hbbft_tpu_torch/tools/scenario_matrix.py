"""scenario_matrix — sweep the adversary × network-schedule matrix (the
port's counterpart of the JAX package's ``tools/scenario_matrix.py``).

Runs every cell of the attack × schedule × N matrix (net/scenarios.py)
on a fresh backend per cell, printing a PASS/FAIL table with per-cell
fault-kind counts, and optionally writing the full row set as JSON.  A
failed cell prints its why-stalled one-liner (the attack + partition the
stall reporter named).

    python -m hbbft_tpu_torch.tools.scenario_matrix --backend mock   # N in {4, 7, 16}
    python -m hbbft_tpu_torch.tools.scenario_matrix --backend mock --ns 4,7 --epochs 2
    python -m hbbft_tpu_torch.tools.scenario_matrix --backend mock \\
        --attacks equivocate,crafted_shares --schedules uniform,partition_heal \\
        --json matrix.json
    python -m hbbft_tpu_torch.tools.scenario_matrix --n100   # the slow N=100/f=33 arm

Backends (``--backend``, as in the simulation and soak CLIs): ``torch``
(the default: ``TorchBackend()``, the card; it raises without one),
``cpu`` (``TorchBackend(device="cpu")``), ``mesh``, ``mesh-cpu`` and
``mock`` (``MockBackend()``, the JAX package's matrix).

Exit code 1 when any cell fails — usable as a CI gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from hbbft_tpu_torch.net.scenarios import (
    MATRIX_ATTACKS,
    MATRIX_SCHEDULES,
    run_matrix,
    run_scenario,
)
from hbbft_tpu_torch.tools.simulation import BACKENDS, make_backend


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ns", default="4,7,16", help="comma-separated N values")
    p.add_argument(
        "--attacks", default=",".join(MATRIX_ATTACKS),
        help="comma-separated attack names",
    )
    p.add_argument(
        "--schedules", default=",".join(MATRIX_SCHEDULES),
        help="comma-separated schedule names",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument(
        "--scheduler", default="random", choices=("random", "first"),
        help="VirtualNet delivery scheduler",
    )
    p.add_argument(
        "--n100", action="store_true",
        help="run the slow N=100/f=33 arm (crafted_shares + equivocate "
        "under partition_heal) instead of the matrix",
    )
    p.add_argument("--json", default=None, help="write rows to this path")
    p.add_argument(
        "--fail-dir", default=None,
        help="write each failed cell's forensics bundle (flight-recorder "
        "dump) here as <attack>x<schedule>@n<N>.forensics.json",
    )
    p.add_argument(
        "--backend", choices=BACKENDS, default="torch",
        help="each cell's backend: torch (the card, the default), cpu, mesh, "
        "mesh-cpu or mock",
    )
    args = p.parse_args(argv)

    if args.n100:
        # uniform delivery: the schedule layer is cheap per message
        # (heap ops + rng draws) but the N=100 epoch moves ~4M messages
        # through an already ~16-minute cell; network-condition coverage
        # at width lives in the N=16 matrix
        results = [
            run_scenario(
                attack, "uniform", 100, f=33,
                seed=args.seed, epochs=1, backend=make_backend(args.backend),
                scheduler=args.scheduler, crank_limit=50_000_000,
            )
            for attack in ("crafted_shares", "equivocate")
        ]
    else:
        results = run_matrix(
            ns=tuple(int(x) for x in args.ns.split(",")),
            attacks=tuple(args.attacks.split(",")),
            schedules=tuple(args.schedules.split(",")),
            seed=args.seed,
            epochs=args.epochs,
            backend_factory=lambda: make_backend(args.backend),
            scheduler=args.scheduler,
        )

    wide = max(len(r.attack) for r in results)
    print(
        f"{'attack':>{wide}} {'schedule':>15} {'n':>4} {'ok':>4} "
        f"{'epochs':>6} {'faults':>7} {'cranks':>9} {'dropped':>8}"
    )
    failed = 0
    for r in results:
        ok = "PASS" if r.ok else "FAIL"
        print(
            f"{r.attack:>{wide}} {r.schedule:>15} {r.n:>4} {ok:>4} "
            f"{r.epochs_committed:>6} {sum(r.fault_kinds.values()):>7} "
            f"{r.cranks:>9} {r.schedule_dropped:>8}"
        )
        if not r.ok:
            failed += 1
            if r.error:
                print(f"    stall: {r.error}")
            if r.why and r.why.get("summary"):
                print(f"    why:   {r.why['summary'][0]}")
            if r.missing_expected:
                print(f"    missing expected faults: {r.missing_expected}")
            if r.misattributed:
                print(f"    misattributed: {r.misattributed[:5]}")
            if args.fail_dir and r.forensics is not None:
                from hbbft_tpu_torch.obs.flight import write_bundle

                os.makedirs(args.fail_dir, exist_ok=True)
                bpath = os.path.join(
                    args.fail_dir,
                    f"{r.attack}x{r.schedule}@n{r.n}.forensics.json",
                )
                write_bundle(r.forensics, bpath)
                print(f"    forensics bundle -> {bpath}")
    kinds: dict = {}
    for r in results:
        for k, c in r.fault_kinds.items():
            kinds[k] = kinds.get(k, 0) + c
    print(f"\n{len(results) - failed}/{len(results)} cells passed")
    for k in sorted(kinds):
        print(f"  {k}: {kinds[k]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": [r.row() for r in results]}, f, indent=2)
        print(f"rows written to {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
