"""The macro rows: whole epochs through the object runtime
(``tools/simulation.py``'s ``Simulation``) and through the array engine
(``ArrayHoneyBadgerNet``), on the backend each row's knob names.
"""

from __future__ import annotations

import os
import random
import time

from hbbft_tpu_torch.tools.bench.common import ARRAY_N16_METRIC, _env_int, make_backend


def _bench_object_runtime(
    metric: str,
    n: int,
    f: int,
    env_prefix: str,
    default_epochs: int,
    default_txns: int,
    baseline_eps: float,
    extra_fields: dict,
    default_backend: str = "mock",
) -> dict:
    """Shared body of the object-runtime rows (configs 0 and 3): build a
    Simulation at the given shape and time its epochs."""
    from hbbft_tpu_torch.tools.simulation import Simulation

    class A:  # argparse stand-in
        num_nodes = n
        num_faulty = f
        batch_size = _env_int(f"{env_prefix}_BATCH", 100)
        tx_size = 10
        txns = _env_int(f"{env_prefix}_TXNS", default_txns)
        epochs = _env_int(f"{env_prefix}_EPOCHS", default_epochs)
        lam = 100.0
        bandwidth = 2000.0
        cpu_factor = 1.0
        crypto_window = _env_int(f"{env_prefix}_WINDOW", 256)
        seed = 0

    backend = make_backend(os.environ.get(f"{env_prefix}_BACKEND", default_backend))
    sim = Simulation(A, backend, random.Random(0))
    t0 = time.perf_counter()
    rows = sim.run()
    dt = time.perf_counter() - t0
    eps = len(rows) / dt if dt > 0 else 0.0
    return {
        "metric": metric,
        "value": round(eps, 4),
        "unit": "epochs/s",
        "vs_baseline": round(eps / baseline_eps, 3),
        "baseline": "estimated",
        "epochs_measured": len(rows),
        "backend": backend.name,
        "runtime": "object",
        **extra_fields,
    }


def bench_epochs_n100() -> dict:
    """North-star shape N=100 f=33 through the per-message object runtime
    (a correctness harness; the throughput row is the array engine's).
    BENCH_N100_BACKEND=torch routes the crypto through the card."""
    return _bench_object_runtime(
        "hbbft_epochs_per_sec_n100",
        n=100,
        f=33,
        env_prefix="BENCH_N100",
        default_epochs=1,
        default_txns=200,
        baseline_eps=0.001,
        extra_fields={"role": "correctness-harness"},
    )


def bench_epochs_n4() -> dict:
    """BASELINE config 0 shape: HoneyBadger N=4 f=1, 10 epochs, 100
    txns/batch through the object runtime.  The mock (default) measures
    the protocol layer; the real-crypto anchor is its own row.
    BENCH_N4_TXNS must scale with BENCH_N4_EPOCHS (~25 consumed per node
    per epoch) or the queue drains early — epochs_measured reports what
    actually ran."""
    # single-core Rust at N=4: ~128 pairings/epoch at ~1k/s ≈ 7 epochs/s
    epochs = _env_int("BENCH_N4_EPOCHS", 10)
    return _bench_object_runtime(
        "hbbft_epochs_per_sec_n4",
        n=4,
        f=1,
        env_prefix="BENCH_N4",
        default_epochs=epochs,
        default_txns=40 * epochs,
        baseline_eps=7.0,
        extra_fields={},
    )


def bench_epochs_n4_realcrypto() -> dict:
    """BASELINE config 0's single-core anchor: N=4 f=1 through the object
    runtime with the real host crypto (``CpuBackend`` — golden BLS12-381,
    every pairing computed on one core).  BENCH_N4RC_EPOCHS sets the
    horizon (~60-70 s an epoch)."""
    epochs = _env_int("BENCH_N4RC_EPOCHS", 2)
    return _bench_object_runtime(
        "hbbft_epochs_per_sec_n4_realcrypto",
        n=4,
        f=1,
        env_prefix="BENCH_N4RC",
        default_epochs=epochs,
        default_txns=40 * epochs,
        baseline_eps=7.0,
        extra_fields={"role": "single-core real-crypto anchor"},
        default_backend="cpu",
    )


def _bench_array_engine(
    metric: str,
    n: int,
    epochs: int,
    baseline_eps: float,
    dedup: bool,
    dynamic: bool,
    backend_env: str = "BENCH_ARRAY_BACKEND",
    backend_default: str = "mock",
    coin_rounds: int = 0,
    churn_epochs: int = 0,
) -> dict:
    """Shared array-engine macro bench: warm one epoch (the kernels' first
    launches, the caches), then time ``epochs`` full-workload lockstep
    epochs at network size n.

    ``churn_epochs`` > 0 inserts that many mid-run era changes (vote →
    DKG → new keys) at evenly spaced epochs; the era change is timed
    separately (``era_change_seconds``) and excluded from epochs/s.
    Post-turnover epochs run under the new keys — the engine's
    decrypt-equality asserts are the correctness check."""
    from hbbft_tpu_torch.engine import ArrayHoneyBadgerNet
    from hbbft_tpu_torch.obs import Tracer
    from hbbft_tpu_torch.obs.hostbuckets import HOST_BUCKETS

    backend = make_backend(os.environ.get(backend_env, backend_default))
    # histogram-only tracer (spans off): dispatch batch sizes + RLC group
    # sizes ride the row as p50/p90/p99 summaries
    tracer = Tracer(spans=False)
    backend.tracer = tracer
    net = ArrayHoneyBadgerNet(
        range(n), backend=backend, seed=0, dedup_verifies=dedup,
        dynamic=dynamic, coin_rounds=coin_rounds, tracer=tracer,
    )
    net.run_epochs(1, payload_size=64)  # warm
    # per-epoch telemetry series: BENCH_SERIES=<path.jsonl> attaches a
    # MetricsLog after the warm epoch, timing fields included
    series_path = os.environ.get("BENCH_SERIES")
    if series_path:
        from hbbft_tpu_torch.obs.timeseries import MetricsLog

        net.metrics_log = MetricsLog(include_timing=True)
    counters = getattr(backend, "counters", None)
    ctr0 = counters.snapshot() if counters is not None else {}
    # post-warm baselines: the row's counters and histograms cover exactly
    # the timed epochs
    merged0 = net.counters.merged_with(backend.counters)
    tracer.histograms.clear()

    churn_ctr = {
        "device_seconds": 0.0,
        "hash_g2_seconds": 0.0,
        "host_assembly_seconds": 0.0,
        "overlap_seconds": 0.0,
        "host_seconds": 0.0,
        "fetch_blocked_seconds": 0.0,
        **{f"host_bucket_{b}": 0.0 for b in HOST_BUCKETS},
        "device_seconds_pairing": 0.0,
        "device_seconds_rlc_sig": 0.0,
        "device_seconds_rlc_dec": 0.0,
        "device_seconds_combine": 0.0,
        "device_seconds_sign": 0.0,
        "device_seconds_decrypt": 0.0,
        "device_seconds_dkg": 0.0,
        "device_seconds_encrypt": 0.0,
        "device_seconds_rs_enc": 0.0,
        "device_seconds_rs_dec": 0.0,
        "device_seconds_merkle": 0.0,
    }
    # mid-run only: an era change needs a preceding and a following epoch,
    # so indices clamp to [1, epochs-1] and dedupe (epochs < 2 → no churn)
    churn_at = (
        sorted(
            {
                min(epochs - 1, max(1, (i + 1) * epochs // (churn_epochs + 1)))
                for i in range(churn_epochs)
            }
        )
        if churn_epochs and epochs >= 2
        else []
    )
    churn_time = 0.0
    churn_merged = {}
    t0 = time.perf_counter()
    done = 0
    for e in range(epochs):
        if e in churn_at:
            t_ch = time.perf_counter()
            pre = counters.snapshot() if counters is not None else {}
            pre_merged = net.counters.merged_with(backend.counters)
            net.era_change()
            if counters is not None:
                d = counters.diff(pre)
                for k in churn_ctr:  # excluded like churn_time is
                    churn_ctr[k] += d.get(k, 0.0)
            for k, v in net.counters.merged_with(backend.counters).items():
                dv = v - pre_merged.get(k, 0)
                if dv:
                    churn_merged[k] = churn_merged.get(k, 0) + dv
            churn_time += time.perf_counter() - t_ch
        net.run_epochs(1, payload_size=64)
        done += 1
    dt = (time.perf_counter() - t0) - churn_time
    eps = done / dt if dt > 0 else 0.0
    rep = net.reports[-1]  # the warm epoch guarantees one report
    row = {
        "metric": metric,
        "value": round(eps, 5),
        "unit": "epochs/s",
        "vs_baseline": round(eps / baseline_eps, 3),
        "baseline": "estimated",
        "runtime": "array",
        "n": n,
        "backend": backend.name,
        "dedup": dedup,
        "dynamic": dynamic,
        "epochs": epochs,
        "churn_epochs": len(net.churn_reports),
        "messages_per_epoch": rep.messages_delivered,
        "dec_share_verifies_per_epoch": rep.dec_shares_verified,
    }
    if counters is not None and done:
        # host/device attribution for the timed epochs, era changes excluded
        delta = counters.diff(ctr0)
        skip_keys = {
            "host_assembly_seconds", "overlap_seconds", "host_seconds",
            "fetch_blocked_seconds",
        }
        for key in churn_ctr:
            if key in skip_keys or key.startswith("host_bucket_"):
                continue  # emitted below under their canonical names
            val = delta.get(key, 0.0) - churn_ctr[key]
            if val > 0:
                row[f"{key}_per_epoch"] = round(val / done, 4)
        host = delta.get("host_seconds", 0.0) - churn_ctr["host_seconds"]
        row["host_seconds_per_epoch"] = round(max(host, 0.0) / done, 4)
        blocked = delta.get("fetch_blocked_seconds", 0.0) - churn_ctr[
            "fetch_blocked_seconds"
        ]
        if blocked > 0:
            row["fetch_blocked_seconds_per_epoch"] = round(blocked / done, 4)
        buckets = {}
        for b in HOST_BUCKETS:
            key = f"host_bucket_{b}"
            val = delta.get(key, 0.0) - churn_ctr[key]
            if val > 0:
                buckets[b] = round(val / done, 4)
        if buckets:
            row["host_buckets"] = buckets
        if host > 0:
            row["host_unattributed_fraction"] = round(
                max(delta.get("host_bucket_other", 0.0) - churn_ctr["host_bucket_other"], 0.0)
                / host,
                4,
            )
        dev = delta.get("device_seconds", 0.0) - churn_ctr["device_seconds"]
        ovl = delta.get("overlap_seconds", 0.0) - churn_ctr["overlap_seconds"]
        row["overlap_fraction"] = round(ovl / dev, 4) if dev > 0 else 0.0
    if coin_rounds:
        row["coin_rounds_per_ba"] = coin_rounds
        row["coin_signs_per_epoch"] = rep.coin_signs
        row["sig_share_verifies_per_epoch"] = rep.sig_shares_verified
        row["sig_combines_per_epoch"] = rep.sig_combines
    if net.churn_reports:
        crep = net.churn_reports[0]
        row["era_change_seconds"] = round(churn_time / len(net.churn_reports), 3)
        row["era_change_kg_acks"] = crep.kg_acks_handled
        row["era"] = net.era
    hists = tracer.hist_summary()
    if hists:
        row["histograms"] = hists
    # merged counters delta (engine + crypto, nonzero keys) over the timed
    # epochs only, era-change work subtracted
    merged1 = net.counters.merged_with(backend.counters)
    row["counters"] = {
        k: v
        for k in merged1
        if (v := round(merged1[k] - merged0.get(k, 0) - churn_merged.get(k, 0), 4))
    }
    if series_path and net.metrics_log is not None:
        from hbbft_tpu_torch.obs.critpath import gating_from_series

        net.metrics_log.to_jsonl(series_path)
        gating = gating_from_series(net.metrics_log.rows_list())
        if gating:
            row["gating"] = gating
        row["series"] = series_path
    return row


def bench_array_engine_n100() -> dict:
    """North-star macro config through the array engine: N=100 f=33
    epochs/sec, the full per-receiver workload (6.94M messages, ~10.7M
    hashes, ~10⁶ share verifies per epoch).  BENCH_ARRAY_BACKEND=torch
    routes the crypto through the card; the memoizing variant has its own
    row.  BASELINE config 3 names DynamicHoneyBadger, so the DHB flavor
    is the default; 100 epochs (BENCH_ARRAY_EPOCHS) with one mid-run era
    change (BENCH_ARRAY_CHURN), timed separately.  Baseline: the
    whole-network ~990k pairing verifies per epoch at ~10³ pairings/s,
    scaled with N (BENCH_ARRAY_N) as N²·(N−f)."""
    n_cfg = _env_int("BENCH_ARRAY_N", 100)
    f_cfg = (n_cfg - 1) // 3
    pairings_per_epoch = n_cfg * n_cfg * (n_cfg - f_cfg)
    return _bench_array_engine(
        "array_epochs_per_sec_n100",
        n=n_cfg,
        epochs=_env_int("BENCH_ARRAY_EPOCHS", 100),
        baseline_eps=1000.0 / pairings_per_epoch,
        dedup=False,
        dynamic=os.environ.get("BENCH_ARRAY_DYNAMIC", "1") == "1",
        churn_epochs=_env_int("BENCH_ARRAY_CHURN", 1),
    )


def bench_array_engine_n100_dedup() -> dict:
    """The N=100 macro in memoizing-simulation mode: identical
    per-receiver verifications collapse to one representative each.
    Message/threshold accounting is unchanged."""
    return _bench_array_engine(
        "array_epochs_per_sec_n100_dedup",
        n=_env_int("BENCH_ARRAY_N", 100),
        epochs=_env_int("BENCH_ARRAY_EPOCHS", 100),
        baseline_eps=0.001,
        dedup=True,
        dynamic=os.environ.get("BENCH_ARRAY_DYNAMIC", "1") == "1",
    )


def bench_array_engine_n16_tpu() -> dict:
    """Real-crypto end-to-end macro: N=16 f=5 lockstep epochs on the card
    (``TorchBackend``): every Merkle proof, RS code, threshold
    encryption, grouped-RLC share verification, share generation and
    Lagrange combine on the device path.  ~3.8k dec-share verifies, 256
    combines and 28k messages an epoch; single-core estimate ≈ 0.25
    epochs/s.  BENCH_ARRAY16_BACKEND overrides the backend (torch)."""
    return _bench_array_engine(
        ARRAY_N16_METRIC,
        n=16,
        epochs=_env_int("BENCH_ARRAY16_EPOCHS", 2),
        baseline_eps=0.25,
        dedup=False,
        dynamic=True,
        backend_env="BENCH_ARRAY16_BACKEND",
        backend_default="torch",
    )


def bench_array_engine_n256_soak() -> dict:
    """BASELINE config 5 (QHB N=256 f=85 sustained) through the array
    engine: full-workload lockstep epochs as a sustained-throughput soak
    point (BENCH_SOAK_EPOCHS, 10).  Baseline ≈ 6e-05 epochs/s
    single-core."""
    return _bench_array_engine(
        "array_epochs_per_sec_n256_soak",
        n=256,
        epochs=_env_int("BENCH_SOAK_EPOCHS", 10),
        baseline_eps=6e-05,
        dedup=False,
        dynamic=True,
    )


def bench_array_engine_n64_coin() -> dict:
    """BASELINE config 2 as a macro config: N=64 f=21 lockstep epochs with
    one real common-coin round per BA instance.  The mock by default, so
    the row measures the engine and its accounting
    (BENCH_COIN_MACRO_BACKEND=torch for the card).  Baseline ≈ 0.004
    epochs/s single-core."""
    return _bench_array_engine(
        "array_epochs_per_sec_n64_coin",
        n=64,
        epochs=_env_int("BENCH_COIN_MACRO_EPOCHS", 2),
        baseline_eps=0.004,
        dedup=False,
        dynamic=True,
        backend_env="BENCH_COIN_MACRO_BACKEND",
        backend_default="mock",
        coin_rounds=_env_int("BENCH_COIN_ROUNDS", 1),
    )


def bench_array_engine_n100_cuda() -> dict:
    """The north star at its defined shape: N=100 f=33 real-crypto
    epochs on the card (``TorchBackend``) plus one era change
    (BENCH_N100_CUDA_EPOCHS, 3; BENCH_N100_CUDA_CHURN, 1).  Under a
    budget the planner fits the epoch count to what is left, or skips
    the row with a label when the era change alone does not fit."""
    overrides = {
        "BENCH_ARRAY_BACKEND": "torch",
        "BENCH_ARRAY_EPOCHS": os.environ.get("BENCH_N100_CUDA_EPOCHS", "3"),
        "BENCH_ARRAY_CHURN": os.environ.get("BENCH_N100_CUDA_CHURN", "1"),
    }
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        return bench_array_engine_n100()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
