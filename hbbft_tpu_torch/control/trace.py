"""Load traces: piecewise arrival-rate schedules as first-class inputs —
the port's copy of the JAX package's ``control/trace.py``.

"Arrival-rate swings" stop being prose and become data: a
:class:`LoadTrace` maps a virtual epoch to a rate *multiplier* applied
to an open-loop source's base rate, so a cell's offered load is a
pure function of (trace, epoch) — replayable, diffable, and identical
across the controller arm and every fixed-B arm.  Traces are arithmetic
over the epoch index only (no entropy, no wall clocks), so the
same seed still yields the same arrival schedule wave for wave.

Shapes (factories below; ``TRACES`` registers them by name for soak
cell specs):

* ``constant`` — factor 1.0 forever (the degenerate trace; a traced
  source with this trace is bit-identical to an untraced one).
* ``step`` — low until ``at``, then high forever (capacity re-planning).
* ``spike`` — low everywhere except ``[at, at+width)`` (flash crowd).
* ``swing`` — square wave: each period is ``duty`` low then ``1-duty``
  high; ``swing10x`` is the flagship 10×-swing the SLO row runs.
* ``diurnal`` — raised-cosine day/night curve between low and high.
"""

from __future__ import annotations

import math
from typing import Dict


class LoadTrace:
    """Arrival-rate multiplier over virtual epochs.

    ``kind`` selects the arithmetic shape; ``params`` are its constants.
    Instances are plain data (snapshotable via utils/snapshot) and are
    consumed duck-typed by :class:`~hbbft_tpu_torch.traffic.workload.
    OpenLoopSource` through ``factor(epoch)`` / ``describe()``.
    """

    def __init__(self, kind: str, **params: float) -> None:
        if kind not in ("constant", "step", "spike", "swing", "diurnal"):
            raise ValueError(f"unknown trace kind {kind!r}")
        self.kind = kind
        self.params: Dict[str, float] = dict(sorted(params.items()))

    # -- the schedule --------------------------------------------------------

    def factor(self, epoch: int) -> float:
        p = self.params
        if self.kind == "constant":
            return p.get("level", 1.0)
        if self.kind == "step":
            return p["high"] if epoch >= p["at"] else p["low"]
        if self.kind == "spike":
            lo, at, width = p["low"], p["at"], p["width"]
            return p["high"] if at <= epoch < at + width else lo
        if self.kind == "swing":
            period = p["period"]
            phase = (epoch % period) / period
            return p["low"] if phase < p["duty"] else p["high"]
        # diurnal: raised cosine, trough at epoch 0, crest at period/2
        period = p["period"]
        x = 0.5 * (1.0 - math.cos(2.0 * math.pi * (epoch % period) / period))
        return p["low"] + (p["high"] - p["low"]) * x

    def peak(self) -> float:
        """Largest factor the trace ever emits (capacity planning)."""
        if self.kind == "constant":
            return self.params.get("level", 1.0)
        return self.params["high"]

    def describe(self) -> dict:
        return {"trace": self.kind, **self.params}

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"LoadTrace({self.kind!r}, {self.params})"


# -- factories (the canonical shapes; keyword-overridable) -------------------


def constant(level: float = 1.0) -> LoadTrace:
    return LoadTrace("constant", level=level)


def step(low: float = 1.0, high: float = 4.0, at: int = 8) -> LoadTrace:
    return LoadTrace("step", low=low, high=high, at=at)


def spike(
    low: float = 1.0, high: float = 10.0, at: int = 8, width: int = 2
) -> LoadTrace:
    return LoadTrace("spike", low=low, high=high, at=at, width=width)


def swing(
    low: float = 1.0,
    high: float = 10.0,
    period: int = 12,
    duty: float = 0.5,
) -> LoadTrace:
    return LoadTrace("swing", low=low, high=high, period=period, duty=duty)


def swing10x(period: int = 12) -> LoadTrace:
    """The flagship 10×-swing: half the period at 1×, half at 10×."""
    return swing(low=1.0, high=10.0, period=period, duty=0.5)


def diurnal(low: float = 1.0, high: float = 4.0, period: int = 24) -> LoadTrace:
    return LoadTrace("diurnal", low=low, high=high, period=period)


#: name -> zero-arg factory, for soak cell specs
TRACES = {
    "constant": constant,
    "step": step,
    "spike": spike,
    "swing10x": swing10x,
    "diurnal": diurnal,
}


def make_trace(name: str) -> LoadTrace:
    """Build a registered trace by name (soak spec surface)."""
    if name not in TRACES:
        raise ValueError(
            f"unknown trace {name!r} (have {sorted(TRACES)})"
        )
    return TRACES[name]()
