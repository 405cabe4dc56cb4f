"""Control plane: SLO-driven adaptive batch sizing — the port's copy of
the JAX package's ``control/``.

The traffic subsystem (hbbft_tpu_torch/traffic/) made "millions of users"
measurable; this package makes the system *react*: declare a service
objective (:mod:`~hbbft_tpu_torch.control.slo`), drive it with a replayable
arrival-rate trace (:mod:`~hbbft_tpu_torch.control.trace`), and let the
:class:`~hbbft_tpu_torch.control.controller.AdaptiveBatchController` walk
HoneyBadgerBFT's batch-size/latency trade at runtime through the
engine/QHB ``batch_size_provider`` hook (or the QHB ``("batch_size",
B)`` input under the crash axis).  ``HBBFT_TPU_NO_ADAPTIVE_B=1`` pins B
for bit-identical fixed-B replay.
"""

from hbbft_tpu_torch.control.controller import (
    LADDER,
    AdaptiveBatchController,
    Observation,
    adaptive_b_enabled,
)
from hbbft_tpu_torch.control.slo import MIN_FEASIBLE_P99, SLO
from hbbft_tpu_torch.control.trace import TRACES, LoadTrace, make_trace, swing10x

__all__ = [
    "AdaptiveBatchController",
    "Observation",
    "LADDER",
    "adaptive_b_enabled",
    "SLO",
    "MIN_FEASIBLE_P99",
    "LoadTrace",
    "TRACES",
    "make_trace",
    "swing10x",
]
