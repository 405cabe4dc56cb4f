"""SLO spec: the declared service objective the control plane holds — the
port's copy of the JAX package's ``control/slo.py``.

HoneyBadgerBFT's central knob is the batch size B — throughput grows
with B while commit latency is paid in epochs (CCS 2016 §5) — so "how
big should B be?" is only answerable against a *declared objective*.
:class:`SLO` is that declaration: a p99 commit-latency target in
**epoch units** (the traffic subsystem's virtual clock — multiply by a
row's measured seconds/epoch for wall latency), plus an optional
sustained-throughput floor in tx/epoch.  Everything the controller
decides or reports is phrased against this one object, so "compliant"
means the same thing in tests, heartbeats and reports.

Latency floor: a submitted transaction is sampled at the next epoch
boundary and commits one epoch later, so ~2 epochs is the physical
minimum — a target below ``MIN_FEASIBLE_P99`` is rejected at
construction rather than silently unachievable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

#: submit → sample (next boundary) → commit (one epoch later): no batch
#: size can beat ~2 epochs of pipeline latency.
MIN_FEASIBLE_P99 = 2.0


@dataclass(frozen=True)
class SLO:
    """Declared objective: ``p99_epochs`` commit-latency ceiling and an
    optional ``min_tx_per_epoch`` throughput floor (0 = no floor).

    ``margin`` is the compliance headroom the controller demands before
    it trades latency slack for efficiency (stepping B down): observed
    p99 must sit at or under ``margin * p99_epochs``.  It is part of the
    spec — two operators with the same ceiling but different margins
    have declared different risk appetites.
    """

    p99_epochs: float
    min_tx_per_epoch: float = 0.0
    margin: float = 0.8

    def __post_init__(self) -> None:
        if self.p99_epochs < MIN_FEASIBLE_P99:
            raise ValueError(
                f"p99 target {self.p99_epochs} below the {MIN_FEASIBLE_P99}"
                "-epoch pipeline floor (submit -> sample -> commit)"
            )
        if not 0.0 < self.margin <= 1.0:
            raise ValueError(f"margin must be in (0, 1], got {self.margin}")
        if self.min_tx_per_epoch < 0:
            raise ValueError("min_tx_per_epoch must be >= 0")

    # -- compliance ----------------------------------------------------------

    def compliant(
        self, p99: Optional[float], tx_per_epoch: Optional[float] = None
    ) -> bool:
        """Does an observed operating point meet the objective?

        ``p99=None`` (no committed samples yet) reads as compliant —
        an idle system violates nothing.  The throughput floor is only
        checked when a measurement is supplied.
        """
        if p99 is not None and p99 > self.p99_epochs:
            return False
        if (
            self.min_tx_per_epoch
            and tx_per_epoch is not None
            and tx_per_epoch < self.min_tx_per_epoch
        ):
            return False
        return True

    def headroom(self, p99: Optional[float]) -> bool:
        """Is p99 comfortably inside the target (under ``margin``×)?"""
        return p99 is None or p99 <= self.margin * self.p99_epochs

    def describe(self) -> Dict[str, Any]:
        return {
            "p99_epochs": self.p99_epochs,
            "min_tx_per_epoch": self.min_tx_per_epoch,
            "margin": self.margin,
        }
