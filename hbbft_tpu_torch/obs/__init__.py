"""Observability subsystem — the port's copy of the JAX package's
``obs/``: span tracing, histograms, run health and stall reporting,
critical paths, per-epoch series and the flight recorder.

All opt-in and zero-cost when absent:

* :class:`~hbbft_tpu_torch.obs.tracer.Tracer` — hierarchical begin/end
  spans on named tracks (epoch → subset → BA instance → coin round →
  device dispatch), exported as Chrome-trace-event/Perfetto JSON or
  JSONL, plus a registry of log-bucketed :class:`Histogram`\\ s.
* :class:`~hbbft_tpu_torch.obs.histogram.Histogram` — log-bucketed
  latency / batch-size distributions with p50/p90/p99 summaries.
* :class:`~hbbft_tpu_torch.obs.health.HealthReporter` — periodic
  heartbeat and a stall detector whose :func:`why_stalled` report names
  which BA instances are blocked on which coin rounds, which RBC
  instances lack Echo/Ready quorum, and a starved or saturated traffic
  source.
* :class:`~hbbft_tpu_torch.obs.critpath.CritPathRecorder` — per-epoch
  gating-chain reconstruction from protocol completion events and engine
  phase stamps, with a run-level gating histogram.
* :class:`~hbbft_tpu_torch.obs.timeseries.MetricsLog` — bounded
  per-epoch counter-delta/histogram/crash-state series.
* :class:`~hbbft_tpu_torch.obs.flight.FlightRecorder` — ring of the last
  K epochs of events + series, dumped as a forensics bundle on failure.

``net/scenarios.run_cell`` wires the last three by default (``obs=False``
opts out).
"""

from hbbft_tpu_torch.obs.critpath import (
    PHASES,
    CritPathRecorder,
    EpochCritPath,
    diff_gating,
    gating_histogram,
    paths_from_events,
)
from hbbft_tpu_torch.obs.flight import (
    FlightRecorder,
    summarize_bundle,
    validate_bundle,
    write_bundle,
)
from hbbft_tpu_torch.obs.health import HealthReporter, render_why_stalled, why_stalled
from hbbft_tpu_torch.obs.histogram import Histogram
from hbbft_tpu_torch.obs.hostbuckets import HOST_BUCKETS, HostBuckets
from hbbft_tpu_torch.obs.timeseries import MetricsLog, snap_net
from hbbft_tpu_torch.obs.tracer import Tracer

__all__ = [
    "Tracer",
    "Histogram",
    "HealthReporter",
    "HostBuckets",
    "HOST_BUCKETS",
    "why_stalled",
    "render_why_stalled",
    "PHASES",
    "CritPathRecorder",
    "EpochCritPath",
    "paths_from_events",
    "gating_histogram",
    "diff_gating",
    "MetricsLog",
    "snap_net",
    "FlightRecorder",
    "validate_bundle",
    "summarize_bundle",
    "write_bundle",
]
