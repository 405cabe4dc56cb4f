"""The port's bench: one JSON line per metric, the counterpart of the JAX
package's ``bench.py``, with every row on the card (``TorchBackend``) or
on the backend the JAX bench's row names (the mock for the protocol-layer
rows, ``CpuBackend`` for the single-core real-crypto anchor).

    python -m hbbft_tpu_torch.tools.bench                   # every row, the card
    BENCH_ONLY=rlc_dec,fq_kernel python -m hbbft_tpu_torch.tools.bench
    python -m hbbft_tpu_torch.tools.bench --device cpu      # plain versions, CPU

Rows print in support-first order (flagship crypto rows and macro rows
last, the mock north star ``array_epochs_per_sec_n100`` as the final
line); the full row set is also written to ``BENCH_torch_rows.json`` at
the repo root after every row (``BENCH_ROWS_PATH`` overrides it).  Under
a time budget (``BENCH_BUDGET`` seconds; 3000 by default for a run of
every row on the card) the order flips to flagship-first and rows whose
estimate no longer fits are skipped with labelled rows.

The bench runs on the card and refuses to start without one unless the
caller asks for the CPU (``--device cpu`` or ``BENCH_DEVICE=cpu``).  A row
that raises emits ``{"metric", "error"}`` and the other rows run; the
process then exits 1, as it does when a row reports a failure in its own
fields (a failed scenario cell, a failed mesh probe, a kill-switch arm
that differs).  Nothing is retried on another path or device.

Row names and metric names are the JAX bench's, but for
``array_n100_cuda`` (its ``array_n100_tpu``, knobs ``BENCH_N100_CUDA_*``).
Backend knobs (``BENCH_*_BACKEND``) take ``mock``, ``cpu`` (the
pure-Python ``CpuBackend``), ``torch`` (the JAX bench's ``tpu``) and
``mesh``.  Set BENCH_BATCH / BENCH_ITERS to override batch size and timing
loops.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from hbbft_tpu_torch.tools.bench.common import (
    ARRAY_N16_METRIC,
    _env_int,
    _RowSink,
    _time_fn,
    device,
    make_backend,
)
from hbbft_tpu_torch.tools.bench.crypto_rows import (
    _adv_contaminated_items,
    bench_adv_matrix,
    bench_coin_e2e,
    bench_fused_chain_ab,
    bench_g2_sign,
    bench_glv_ladder,
    bench_rlc_dec,
    bench_rlc_dec_adversarial,
    bench_rlc_sig,
    bench_share_verify,
)
from hbbft_tpu_torch.tools.bench.gauntlet_rows import (
    bench_crash_matrix,
    bench_mesh_scaling,
    bench_qhb_traffic,
    bench_scenario_matrix,
    bench_slo_traffic,
)
from hbbft_tpu_torch.tools.bench.macro_rows import (
    bench_array_engine_n16_tpu,
    bench_array_engine_n64_coin,
    bench_array_engine_n100,
    bench_array_engine_n100_cuda,
    bench_array_engine_n100_dedup,
    bench_array_engine_n256_soak,
    bench_epochs_n4,
    bench_epochs_n4_realcrypto,
    bench_epochs_n100,
)
from hbbft_tpu_torch.tools.bench.plane_rows import (
    bench_fq_kernel,
    bench_rs_encode,
    bench_rs_host,
    bench_rs_plane_ab,
)

__all__ = [
    "_adv_contaminated_items", "_env_int", "_plan_benches", "_time_fn", "device",
    "main", "make_backend",
]

#: bench names that execute the Fq facade (device field arithmetic)
_FQ_ROWS = frozenset(
    {
        "rlc_dec",
        "share_verify",
        "rlc_sig",
        "g2_sign",
        "coin_e2e",
        "rlc_dec_adversarial",
        "array_n16_tpu",
        "glv_ladder",
    }
)

# Per-row wall-cost estimates on the card, seconds (NVIDIA H100 80GB HBM3,
# 700.00 W): each row's seconds in a budgeted run of every row (PERF.md
# §5, 1,653 s in all; the first rows' kernel builds included) about
# doubled, at least 30.  Used only by budget mode to decide what still
# fits; deliberately pessimistic.
_BENCH_EST_S = {
    "rlc_dec": 60, "share_verify": 30, "rlc_sig": 30, "g2_sign": 30,
    "coin_e2e": 30, "rlc_dec_adversarial": 30, "array_n16_tpu": 90,
    "array_n100_cuda": 1200, "rs_encode": 30, "rs_host": 30,
    "rs_plane_ab": 30,
    "fused_chain_ab": 30,
    "fq_kernel": 60, "n4": 30, "n4_realcrypto": 180, "n100": 540,
    "array_n256_soak": 1200, "array_n100_dedup": 60, "array_n64_coin": 30,
    "array_n100": 800, "glv_ladder": 30, "adv_matrix": 60,
    "scenario_matrix": 30, "qhb_traffic": 60, "crash_matrix": 30,
    "slo_traffic": 90, "mesh_scaling": 90,
}
#: one N=100 real-crypto epoch on the card, s (23.3-29.5 s, PERF.md §5;
#: 24.2 s in the budgeted run)
N100_CUDA_EPOCH_EST = 30.0
#: one N=100 era change on the card, s (3,306.4 s, PERF.md §5)
N100_CUDA_ERA_EST = 3306.4


def _plan_benches(only, platform: str, budget: float) -> list:
    """Ordered (name, fn) bench list.

    No budget → support-first order: a reader of the tail of stdout sees
    the flagship rows last.  Budget set → flagship-first order: the
    valuable rows run first (the rows file keeps them whatever happens to
    stdout), and the runner skips any later row whose cost estimate no
    longer fits."""
    arrays = os.environ.get("BENCH_ARRAY", "1") != "0"
    n4 = os.environ.get("BENCH_N4", "1") != "0"
    n100 = os.environ.get("BENCH_N100", "1") != "0"
    soak = os.environ.get("BENCH_SOAK", "1") != "0"
    fqk = os.environ.get("BENCH_FQ", "1") != "0"

    if budget:
        plan = [
            ("rlc_dec", bench_rlc_dec),
            ("share_verify", bench_share_verify),
            ("rlc_sig", bench_rlc_sig),
            ("g2_sign", bench_g2_sign),
            ("coin_e2e", bench_coin_e2e),
            ("rlc_dec_adversarial", bench_rlc_dec_adversarial),
            ("adv_matrix", bench_adv_matrix),
        ]
        if arrays:
            plan.append(("array_n16_tpu", bench_array_engine_n16_tpu))
            if platform == "cuda":
                plan.append(("array_n100_cuda", bench_array_engine_n100_cuda))
        # diagnostic A/B rows — after the flagship prefix, before support
        plan.append(("fused_chain_ab", bench_fused_chain_ab))
        plan.append(("glv_ladder", bench_glv_ladder))
        plan.append(("scenario_matrix", bench_scenario_matrix))
        plan.append(("crash_matrix", bench_crash_matrix))
        # the per-entry dispatcher's structure row — cheap, ahead of the
        # traffic curves
        plan.append(("mesh_scaling", bench_mesh_scaling))
        plan.append(("qhb_traffic", bench_qhb_traffic))
        plan.append(("slo_traffic", bench_slo_traffic))
        plan += [
            ("rs_encode", bench_rs_encode),
            ("rs_host", bench_rs_host),
            ("rs_plane_ab", bench_rs_plane_ab),
        ]
        if fqk:
            plan.append(("fq_kernel", bench_fq_kernel))
        if n4:
            plan.append(("n4", bench_epochs_n4))
            plan.append(("n4_realcrypto", bench_epochs_n4_realcrypto))
        if n100:
            plan.append(("n100", bench_epochs_n100))
        if soak:
            plan.append(("array_n256_soak", bench_array_engine_n256_soak))
        if arrays:
            plan.append(("array_n100_dedup", bench_array_engine_n100_dedup))
            plan.append(("array_n64_coin", bench_array_engine_n64_coin))
            plan.append(("array_n100", bench_array_engine_n100))
    else:
        # support-first print order (flagships last, mock north star at
        # the very end)
        plan = [
            ("rs_encode", bench_rs_encode),
            ("rs_host", bench_rs_host),
            ("rs_plane_ab", bench_rs_plane_ab),
            ("fused_chain_ab", bench_fused_chain_ab),
            ("share_verify", bench_share_verify),
        ]
        if n4:
            plan.append(("n4", bench_epochs_n4))
            plan.append(("n4_realcrypto", bench_epochs_n4_realcrypto))
        if n100:
            plan.append(("n100", bench_epochs_n100))
        if soak:
            plan.append(("array_n256_soak", bench_array_engine_n256_soak))
        if arrays:
            plan.append(("array_n100_dedup", bench_array_engine_n100_dedup))
        plan += [
            ("rlc_sig", bench_rlc_sig),
            ("g2_sign", bench_g2_sign),
            ("coin_e2e", bench_coin_e2e),
            ("rlc_dec_adversarial", bench_rlc_dec_adversarial),
            ("adv_matrix", bench_adv_matrix),
            ("scenario_matrix", bench_scenario_matrix),
            ("crash_matrix", bench_crash_matrix),
            ("mesh_scaling", bench_mesh_scaling),
            ("qhb_traffic", bench_qhb_traffic),
            ("slo_traffic", bench_slo_traffic),
            ("glv_ladder", bench_glv_ladder),
        ]
        if fqk:
            plan.append(("fq_kernel", bench_fq_kernel))
        plan.append(("rlc_dec", bench_rlc_dec))
        if arrays:
            plan.append(("array_n16_tpu", bench_array_engine_n16_tpu))
            plan.append(("array_n64_coin", bench_array_engine_n64_coin))
            plan.append(("array_n100", bench_array_engine_n100))
        # array_n100_cuda is reachable without a budget only by request
        plan.append(("array_n100_cuda", bench_array_engine_n100_cuda))
    if only is not None:
        # an explicit request overrides the platform gate (the budget
        # branch adds the row only on the card)
        if "array_n100_cuda" in only and "array_n100_cuda" not in {n for n, _ in plan}:
            plan.append(("array_n100_cuda", bench_array_engine_n100_cuda))
        plan = [(n, f) for (n, f) in plan if n in only]
    else:
        plan = [(n, f) for (n, f) in plan if n != "array_n100_cuda" or budget]
    return plan


def _n100_cuda_fit(budget: float, elapsed: float):
    """Epochs of ``array_n100_cuda`` that fit what is left of the budget
    (~70% of it after the era change, when churn is on), or the skip
    label when not even one does."""
    per_epoch = float(os.environ.get("BENCH_N100_CUDA_EPOCH_EST", str(N100_CUDA_EPOCH_EST)))
    churn = _env_int("BENCH_N100_CUDA_CHURN", 1) > 0
    era = float(os.environ.get("BENCH_N100_CUDA_ERA_EST", str(N100_CUDA_ERA_EST))) if churn else 0.0
    fit = int((budget - elapsed - era) * 0.7 / per_epoch)
    if fit >= 1:
        return fit, None
    need = f"~{per_epoch * 1.5:.0f}s for one epoch"
    if churn:
        need = (f"~{era:.0f}s for the era change plus {need}; BENCH_N100_CUDA_CHURN=0 "
                f"runs the epochs alone")
    return 0, f"budget exhausted ({elapsed:.0f}s elapsed of {budget:.0f}s; needs {need})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (the card, the default) or cpu; BENCH_DEVICE sets it too")
    args = ap.parse_args(argv)
    platform = args.device or device()
    if platform not in ("cuda", "cpu"):
        print(f"bench: unknown device {platform!r} (cuda or cpu)", file=sys.stderr)
        return 2

    import torch

    if platform == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA card (torch.cuda.is_available() is False); the bench runs "
              "on the card unless asked for the CPU with --device cpu or BENCH_DEVICE=cpu",
              file=sys.stderr)
        return 2
    os.environ["BENCH_DEVICE"] = platform
    only = set(os.environ["BENCH_ONLY"].split(",")) if os.environ.get("BENCH_ONLY") else None

    # BENCH_BUDGET=<seconds> switches to flagship-first ordering and skips
    # rows that no longer fit.  A run of every row on the card gets a
    # default budget; BENCH_BUDGET=0 disables it.
    budget_env = os.environ.get("BENCH_BUDGET")
    if budget_env is not None:
        budget = float(budget_env)
    elif only is None and platform == "cuda":
        budget = 3000.0
    else:
        budget = 0.0
    t_start = time.monotonic()
    card = ""
    if platform == "cuda":
        from hbbft_tpu_torch.tools.kernel_bench import card_line

        card = card_line(torch.device("cuda", 0))
    sink = _RowSink(platform, card)
    if budget:
        sink.meta["budget_seconds"] = budget
    if os.environ.get("BENCH_ARRAY_DEDUP"):
        sink.emit(
            {
                "metric": "bench_note",
                "note": "BENCH_ARRAY_DEDUP does not affect array_epochs_per_sec_n100; the "
                "memoizing variant is its own row (array_epochs_per_sec_n100_dedup)",
            }
        )
    errors = _run_rows(_plan_benches(only, platform, budget), sink, platform, budget, t_start)
    return 1 if errors else 0


def _row_failed(row: dict) -> bool:
    """Whether a row that ran reports a failure in its own fields: a
    matrix or mesh row's ``all_ok`` false or its ``failed``/``failed_cells``
    not empty, the SLO row's kill-switch arm not identical."""
    return (row.get("all_ok") is False or bool(row.get("failed"))
            or bool(row.get("failed_cells")) or row.get("killswitch_identical") is False)


def _run_rows(plan, sink, platform: str, budget: float, t_start: float) -> int:
    """Run the planned rows into ``sink``; the number of rows that raised
    or report a failure (``_row_failed``; such a row is emitted as it
    is)."""
    errors = 0
    for name, fn in plan:
        elapsed = time.monotonic() - t_start
        if budget and name == "array_n100_cuda":
            # adaptive epoch count instead of the generic estimate skip
            fit, skipped = _n100_cuda_fit(budget, elapsed)
            if skipped:
                sink.emit({"metric": name, "skipped": skipped, "platform": platform})
                continue
            want = _env_int("BENCH_N100_CUDA_EPOCHS", 3)
            os.environ["BENCH_N100_CUDA_EPOCHS"] = str(max(1, min(want, fit)))
        elif budget and elapsed + _BENCH_EST_S.get(name, 120) > budget:
            sink.emit(
                {
                    "metric": name,
                    "skipped": "budget exhausted "
                    f"({elapsed:.0f}s elapsed of {budget:.0f}s; "
                    f"estimate {_BENCH_EST_S.get(name, 120)}s)",
                    "platform": platform,
                }
            )
            continue
        if (
            name == "array_n16_tpu"
            and platform == "cpu"
            and not os.environ.get("BENCH_ARRAY16_BACKEND")
        ):
            # real crypto at N=16 on the plain versions takes minutes an
            # epoch; BENCH_ARRAY16_BACKEND=torch forces the attempt
            sink.emit(
                {
                    "metric": ARRAY_N16_METRIC,
                    "skipped": "no card (the CPU was asked for); "
                    "BENCH_ARRAY16_BACKEND=torch runs it on the CPU",
                    "platform": platform,
                }
            )
            continue
        try:
            t_row = time.monotonic()
            row = fn()
            row["row_seconds"] = round(time.monotonic() - t_row, 1)
            row["platform"] = platform
            # label every row whose bench executes the Fq facade (mock
            # macros and the GF(2^8) RS row never touch field code)
            backend_name = str(row.get("backend", ""))
            if (
                name in _FQ_ROWS
                or backend_name == "TorchBackend"
                or backend_name.startswith("MeshBackend")
            ):
                row["fq_impl"] = os.environ.get("HBBFT_TPU_FQ_IMPL", "rns")
            if backend_name == "MockBackend" and "vs_baseline" in row:
                # the estimated baselines are real-crypto cost models; a
                # mock-backend macro beating them measures no crypto
                row["vs_baseline_mock_runtime"] = row.pop("vs_baseline")
                row["baseline_comparable"] = False
            sink.emit(row)
            errors += _row_failed(row)
        except Exception as e:  # one dead row must not kill the others
            sink.emit({"metric": name, "error": repr(e)[:200]})
            errors += 1
    return errors
