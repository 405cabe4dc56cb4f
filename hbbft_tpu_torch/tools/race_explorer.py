"""Schedule-space race explorer CLI (analysis/schedules.py).

Systematically explores non-equivalent resolution/crank schedules of the
async seams (pipeline chunk resolution, deferred verify, traffic hooks,
VirtualNet delivery order) and asserts the run fingerprint — Batch
sha256, fault log, integer counters, device_dispatches — is identical
across all of them.

Usage::

    python -m hbbft_tpu_torch.tools.race_explorer             # smoke sweep
    python -m hbbft_tpu_torch.tools.race_explorer --smoke     # same, explicit
    python -m hbbft_tpu_torch.tools.race_explorer --full      # slow sweep (N=4,7)
    python -m hbbft_tpu_torch.tools.race_explorer --target pipeline --n 4 --max-runs 200
    python -m hbbft_tpu_torch.tools.race_explorer --target mutant:accum --counterexample cx.json
    python -m hbbft_tpu_torch.tools.race_explorer --replay cx.json  # reproduce a divergence

Exit status: 0 when every explored schedule agreed (or a --replay
reproduced its recorded divergence exactly); 1 when a divergence was
found (the counterexample file is written if --counterexample was
given); 2 when a --replay failed to reproduce.

Pure CPU: every target runs MockBackend protocol math, so a sweep costs
milliseconds per schedule (``schedules.run_pipeline_target`` also takes
a ``backend_factory``, which is how a run on the card is made).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from hbbft_tpu_torch.analysis import schedules
from hbbft_tpu_torch.analysis.schedules import FULL_PLAN, SMOKE_PLAN


def run_plan(plan, seed: int, counterexample) -> int:
    total_classes = 0
    total_runs = 0
    total_pruned = 0
    rc = 0
    for target, n, max_runs in plan:
        ex = schedules.explore(target, n, seed=seed, max_runs=max_runs)
        total_classes += ex.classes
        total_runs += ex.runs
        total_pruned += ex.pruned
        s = ex.summary()
        print(
            f"explorer: {target} n={n} runs={s['runs']} "
            f"classes={s['non_equivalent_schedules']} "
            f"pruned={s['dpor_pruned']} ok={s['ok']}"
        )
        if not ex.ok:
            rc = 1
            print(
                "explorer: DIVERGENCE "
                + json.dumps(
                    ex.divergence["first_divergence"], sort_keys=True
                )
            )
            if counterexample:
                schedules.write_counterexample(counterexample, ex)
                print(f"explorer: counterexample -> {counterexample}")
                return rc
    print(
        f"explorer: total runs={total_runs} "
        f"non-equivalent schedules={total_classes} pruned={total_pruned}"
    )
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", help="one target (pipeline/traffic/virtualnet/mutant:*)")
    ap.add_argument("--n", type=int, default=4, help="network size (default 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-runs", type=int, default=120)
    ap.add_argument("--smoke", action="store_true", help="the smoke plan (SMOKE_PLAN)")
    ap.add_argument("--full", action="store_true", help="slow full sweep plan")
    ap.add_argument(
        "--counterexample",
        type=Path,
        help="write a minimized replayable counterexample here on divergence",
    )
    ap.add_argument(
        "--replay",
        type=Path,
        help="re-run a counterexample file; exit 0 iff it reproduces exactly",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable summary")
    args = ap.parse_args(argv)

    if args.replay:
        rep = schedules.replay_counterexample(args.replay)
        if args.json:
            print(json.dumps(rep, indent=2, sort_keys=True, default=repr))
        else:
            print(
                f"replay: diverged={rep['diverged']} "
                f"reproduced={rep['reproduced']} "
                f"first_divergence={json.dumps(rep['first_divergence'])}"
            )
        return 0 if rep["reproduced"] else 2

    if args.target:
        ex = schedules.explore(
            args.target, args.n, seed=args.seed, max_runs=args.max_runs
        )
        if args.json:
            print(json.dumps(ex.summary(), indent=2, sort_keys=True, default=repr))
        else:
            s = ex.summary()
            print(
                f"explorer: {args.target} n={args.n} runs={s['runs']} "
                f"classes={s['non_equivalent_schedules']} "
                f"pruned={s['dpor_pruned']} ok={s['ok']}"
            )
        if not ex.ok:
            if args.counterexample:
                schedules.write_counterexample(args.counterexample, ex)
                print(f"explorer: counterexample -> {args.counterexample}")
            else:
                print(
                    "explorer: DIVERGENCE "
                    + json.dumps(ex.divergence["first_divergence"], sort_keys=True)
                )
            return 1
        return 0

    plan = FULL_PLAN if args.full else SMOKE_PLAN
    return run_plan(plan, args.seed, args.counterexample)


if __name__ == "__main__":
    sys.exit(main())
