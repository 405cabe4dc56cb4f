"""Traffic subsystem: sustained client load, per-tx latency, and the
batch-size throughput/latency curve for QueueingHoneyBadger — the port's
copy of the JAX package's ``traffic/``.

Layers (each its own module, composable):

* :mod:`~hbbft_tpu_torch.traffic.workload` — client populations (Zipf),
  arrival processes (open-loop Poisson / closed-loop fixed concurrency),
  payload-size distributions; rng-injected, replay-deterministic.
* :mod:`~hbbft_tpu_torch.traffic.mempool` — bounded admission over
  ``TransactionQueue``: validation-first submit, capacity with
  reject/evict-oldest policies, hysteresis backpressure.
* :mod:`~hbbft_tpu_torch.traffic.tracker` — per-transaction lifecycle
  (submit → queue → sampled → committed) feeding p50/p90/p99
  commit-latency histograms and sustained-tx/s accounting.
* :mod:`~hbbft_tpu_torch.traffic.driver` — drives QHB-style sampling through
  ``ArrayHoneyBadgerNet`` (contribution-source + batch-listener hooks)
  and through the object protocols for small-N parity.

:class:`~hbbft_tpu_torch.traffic.driver.ArrayTrafficDriver` sweeps batch
size × arrival rate over the lockstep engine and records the
throughput/latency curve as data.
"""

from hbbft_tpu_torch.traffic.driver import ArrayTrafficDriver, ObjectTrafficDriver
from hbbft_tpu_torch.traffic.mempool import BoundedMempool
from hbbft_tpu_torch.traffic.tracker import TxTracker
from hbbft_tpu_torch.traffic.workload import (
    ClosedLoopSource,
    OpenLoopSource,
    PayloadSizes,
    ZipfPopulation,
    make_tx,
)

__all__ = [
    "ArrayTrafficDriver",
    "ObjectTrafficDriver",
    "BoundedMempool",
    "TxTracker",
    "ClosedLoopSource",
    "OpenLoopSource",
    "PayloadSizes",
    "ZipfPopulation",
    "make_tx",
]
