"""AdaptiveBatchController: walk the B-vs-latency trade at runtime — the
port's copy of the JAX package's ``control/controller.py``.

HoneyBadgerBFT's central trade (tx/s grows with batch size B while p99
commit latency is paid in epochs) as a closed loop: observe the live operating point through
the traffic subsystem's :class:`~hbbft_tpu_torch.traffic.tracker.TxTracker`
(recent-window p99, sustained tx/epoch, mempool depth, backpressure)
and step B along the power-of-two ladder to hold a declared
:class:`~hbbft_tpu_torch.control.slo.SLO` under arrival-rate swings — the
same observe→adapt shape as the contamination-adaptive RLC grouping
(ops/backend.py, blst's playbook).

**Policy (AIMD-style on the ladder, hysteresis both ways).**  Per
decision epoch the controller computes a *demand* estimate — the larger
of the recent arrival rate and the backlog amortized over the SLO's
dwell budget — and compares it to the current sampling capacity
``validators × B``:

* **up** (×2, one rung) when demand exceeds ``up_frac`` of capacity,
  backpressure is active, the throughput floor is being missed with a
  live backlog, or observed p99 breaks the target after a full
  observation window at the current rung (raw p99 lags a rung change,
  so it only triggers once the window has turned over);
* **down** (÷2, one rung) only after ``hold_epochs`` *consecutive*
  eligible epochs: demand must fit comfortably (``down_frac``) inside
  the NEXT rung down's capacity and p99 must sit inside the SLO's
  declared margin.  The up threshold at rung B and the down threshold
  at rung 2B bracket a dead band, so steady load parks B on one rung
  (no oscillation).

**Determinism.**  Decisions are a pure function of observed state; the
optional ``probe_jitter`` dithers the down-hysteresis length using ONLY
the injected rng (default 0: the rng is never consumed), so seeded
replay stays bit-identical and the ``HBBFT_TPU_NO_ADAPTIVE_B=1`` kill
switch (read per decision, like the adaptive-RLC and GLV switches)
reproduces the fixed-B run bit for bit.  No wall clocks, no ambient
entropy.

The controller is plain state — snapshotable via utils/snapshot (the
B trace, hysteresis counters, and rng ride a checkpoint; the *hooks*
holding it — ``batch_size_provider`` on the engine/QHB — are
environment and detach, like ``contribution_source``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.control.slo import MIN_FEASIBLE_P99, SLO

#: the batch-size ladder (B ∈ {8..512}); power-of-two
#: rungs make one step down a true multiplicative decrease.
LADDER: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)


def adaptive_b_enabled() -> bool:
    """Kill switch, read per decision: ``HBBFT_TPU_NO_ADAPTIVE_B=1``
    pins B to the initial rung for the rest of the run."""
    return os.environ.get("HBBFT_TPU_NO_ADAPTIVE_B", "0") != "1"


def _effective_drain(depth: int, b: int, n: int) -> float:
    """Distinct commits per epoch from N decorrelated B-samples of a
    depth-D pool: D·(1-(1-min(B,D)/D)^N) — the fanout="all" overlap
    model (HoneyBadger proposals are independent random samples, CCS
    2016 §4.4; redundant copies commit once)."""
    if depth <= 0:
        return 0.0
    frac = min(b, depth) / depth
    return depth * (1.0 - (1.0 - frac) ** n)


@dataclass(frozen=True)
class Observation:
    """One decision epoch's view of the operating point, assembled by
    the traffic driver from tracker recent-window stats + mempool state.
    All quantities are virtual (epoch units) — no wall clocks."""

    epoch: int
    p99: Optional[float]  # recent-window commit p99 (None: no samples)
    tx_per_epoch: float  # recent committed rate
    arrivals_per_epoch: float  # recent submitted rate (window average)
    mempool_depth: int  # current max depth across mempools
    backpressure: bool
    validators: int
    #: newest complete epoch's arrivals — the spike signal (a window
    #: average dilutes a swing's first epoch by the window length)
    arrivals_last: float = 0.0

    def describe(self) -> Dict[str, Any]:
        return {
            "epoch": self.epoch,
            "p99": self.p99,
            "tx_per_epoch": round(self.tx_per_epoch, 2),
            "arrivals_per_epoch": round(self.arrivals_per_epoch, 2),
            "mempool_depth": self.mempool_depth,
            "backpressure": self.backpressure,
        }


class AdaptiveBatchController:
    """SLO-driven batch sizing over the power-of-two ladder."""

    def __init__(
        self,
        slo: SLO,
        initial_b: int = 32,
        ladder: Tuple[int, ...] = LADDER,
        rng=None,
        window: int = 4,
        hold_epochs: int = 3,
        up_frac: float = 0.9,
        down_frac: float = 0.7,
        probe_jitter: int = 0,
    ) -> None:
        if initial_b not in ladder:
            raise ValueError(f"initial_b {initial_b} not on ladder {ladder}")
        if list(ladder) != sorted(set(ladder)):
            raise ValueError("ladder must be strictly increasing")
        self.slo = slo
        self.ladder = tuple(ladder)
        self.initial_b = initial_b
        self.rng = rng
        self.window = window
        self.hold_epochs = hold_epochs
        self.up_frac = up_frac
        self.down_frac = down_frac
        self.probe_jitter = probe_jitter
        self._idx = self.ladder.index(initial_b)
        self._hold = 0  # consecutive down-eligible epochs
        self._since_change = window  # epochs at the current rung
        self._hold_needed = hold_epochs  # re-dithered after each step
        #: (epoch, B-after-decision, reason) per decide() call — the
        #: replayable B trace the bit-identity tests fingerprint
        self.decisions: List[Tuple[int, int, str]] = []
        self.steps_up = 0
        self.steps_down = 0
        self.last_obs: Optional[Observation] = None
        self.last_compliant = True

    # -- the hook surface ----------------------------------------------------

    @property
    def current_b(self) -> int:
        """Current batch size (kill switch pins the initial rung)."""
        if not adaptive_b_enabled():
            return self.initial_b
        return self.ladder[self._idx]

    def batch_size(self) -> int:
        """Zero-arg provider callable — install as an engine's or QHB's
        ``batch_size_provider`` (environment attr; snapshots drop it)."""
        return self.current_b

    # -- the control law -----------------------------------------------------

    def _dwell_budget(self) -> float:
        """Epochs of mempool dwell the SLO leaves after pipeline floor."""
        return max(1.0, self.slo.p99_epochs - MIN_FEASIBLE_P99)

    def _redither(self) -> None:
        self._hold_needed = self.hold_epochs
        if self.probe_jitter and self.rng is not None:
            self._hold_needed += self.rng.randrange(self.probe_jitter + 1)

    def decide(self, obs: Observation) -> int:
        """One decision epoch: observe, maybe step, record, return B."""
        self.last_obs = obs
        self.last_compliant = self.slo.compliant(obs.p99, obs.tx_per_epoch)
        if not adaptive_b_enabled():
            self.decisions.append((obs.epoch, self.initial_b, "killswitch"))
            return self.initial_b

        b = self.ladder[self._idx]
        cap = obs.validators * b
        budget = self._dwell_budget()
        demand = max(
            obs.arrivals_per_epoch,
            obs.arrivals_last,
            obs.mempool_depth / budget,
        )
        # Projected mempool dwell.  The drain estimate is the larger of
        # the measured recent rate (a lagging window average — right
        # after a rung change it still quotes the old B) and the
        # decorrelated-sampling model at the CURRENT rung: N independent
        # B-samples from a depth-D pool commit D·(1-(1-B/D)^N) distinct
        # txs per epoch.  Raw N·B would overestimate (samples overlap);
        # the stale average alone underestimates (measured: it read a
        # one-epoch backlog as 5 epochs of dwell and over-ramped B).
        drain = max(
            obs.tx_per_epoch,
            _effective_drain(obs.mempool_depth, b, obs.validators),
            1.0,
        )
        dwell_est = obs.mempool_depth / drain
        reason = "hold"

        pressure_up = (
            demand > self.up_frac * cap
            or dwell_est > budget
            or obs.backpressure
        )
        floor_miss = (
            self.slo.min_tx_per_epoch > 0
            and obs.tx_per_epoch < self.slo.min_tx_per_epoch
            and obs.mempool_depth > 0
        )
        # p99 is a LAGGING signal: committed txs carry dwell accrued at
        # the previous rung, so a breach only argues for a bigger B when
        # (a) the observation window has turned over since the last step
        # and (b) there is a LIVE queue to compress (mean dwell ≥ ~0.3
        # of the budget — random sampling's geometric tail turns that
        # into a p99 several times larger).  Without (b) the breach is a
        # stale ramp tail over a drained pool, where escalating B buys
        # nothing (measured: B over-ramped 128→512 and halved tx/s).
        p99_breach = (
            obs.p99 is not None
            and obs.p99 > self.slo.p99_epochs
            and self._since_change >= self.window
            and dwell_est > 0.3 * budget
        )
        down_ok = (
            self._idx > 0
            and demand
            < self.down_frac * obs.validators * self.ladder[self._idx - 1]
            # a stale elevated p99 must not pin B high once the pool has
            # drained: near-empty mempool means latency is at the
            # pipeline floor regardless of B
            and (self.slo.headroom(obs.p99) or dwell_est < 0.25)
            and not obs.backpressure
            and not floor_miss
        )

        if pressure_up or p99_breach or floor_miss:
            if self._idx + 1 < len(self.ladder):
                # pressure ramps MULTIPLE rungs at once: a 10x swing's
                # first epoch must not cost log2(10) reaction epochs of
                # backlog (each lagging epoch adds a full epoch of
                # excess dwell to the tail).  p99/floor triggers step a
                # single rung — they are lagging, already-amortized
                # signals.
                rungs = 1
                if pressure_up:
                    while (
                        self._idx + rungs + 1 < len(self.ladder)
                        and demand
                        > self.up_frac
                        * obs.validators
                        * self.ladder[self._idx + rungs]
                    ):
                        rungs += 1
                self._idx += rungs
                self.steps_up += rungs
                self._since_change = 0
                reason = (
                    "up:pressure"
                    if pressure_up
                    else ("up:floor" if floor_miss else "up:p99")
                )
                self._redither()
            else:
                reason = "hold:ceiling"
            self._hold = 0
        elif down_ok:
            self._hold += 1
            if self._hold >= self._hold_needed:
                self._idx -= 1
                self.steps_down += 1
                self._since_change = 0
                self._hold = 0
                reason = "down:slack"
                self._redither()
            else:
                reason = "hold:settling"
        else:
            self._hold = 0
        self._since_change += 1
        b = self.ladder[self._idx]
        self.decisions.append((obs.epoch, b, reason))
        return b

    # -- reporting -----------------------------------------------------------

    def b_trace(self) -> List[int]:
        """Per-decision B values — the seeded-replay fingerprint axis."""
        return [b for _, b, _ in self.decisions]

    def describe(self) -> Dict[str, Any]:
        """Status block for ``why_stalled`` / heartbeats / reports."""
        out: Dict[str, Any] = {
            "batch_size": self.current_b,
            "adaptive": adaptive_b_enabled(),
            "slo": self.slo.describe(),
            "compliant": self.last_compliant,
            "steps_up": self.steps_up,
            "steps_down": self.steps_down,
        }
        if self.decisions:
            out["last_reason"] = self.decisions[-1][2]
        if self.last_obs is not None:
            out["observed"] = self.last_obs.describe()
        return out
