"""Log-bucketed histograms with percentile summaries.

HDR-style base-2 buckets with ``SUBBUCKETS`` linear sub-buckets per
octave: relative quantile error is bounded by ``1/SUBBUCKETS`` (~6% at
16), while ``record`` stays O(1) with a small dict — soak runs record
millions of per-crank latencies without keeping raw samples.  Exact
count/sum/min/max ride alongside, so means and extremes are not subject
to bucketing error.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

#: linear sub-buckets per power-of-two octave (quantile error ≤ 1/16).
SUBBUCKETS = 16


class Histogram:
    """Distribution of nonnegative values (latencies, batch sizes, depths)."""

    __slots__ = ("name", "counts", "count", "total", "min", "max")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- recording -----------------------------------------------------------

    @staticmethod
    def _bucket(value: float) -> int:
        if value < 1.0:
            # sub-unit values share one linear octave [0, 1)
            return int(value * SUBBUCKETS) - SUBBUCKETS
        e = int(math.log2(value))
        # float log2 can land one octave off at exact powers; clamp.
        if value < (1 << e):
            e -= 1
        elif value >= (1 << (e + 1)):
            e += 1
        sub = int((value / (1 << e) - 1.0) * SUBBUCKETS)
        return e * SUBBUCKETS + min(sub, SUBBUCKETS - 1)

    @staticmethod
    def _bucket_value(bucket: int) -> float:
        """Representative (geometric-midpoint) value of a bucket."""
        if bucket < 0:
            return (bucket + SUBBUCKETS + 0.5) / SUBBUCKETS
        e, sub = divmod(bucket, SUBBUCKETS)
        lo = (1 << e) * (1.0 + sub / SUBBUCKETS)
        return lo * (1.0 + 0.5 / SUBBUCKETS)

    def record(self, value: float) -> None:
        if value < 0:
            value = 0.0
        b = self._bucket(value)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.count += 1
        self.total += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    # -- summaries -----------------------------------------------------------

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile (p in [0, 100])."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(self.count * p / 100.0))
        seen = 0
        for b in sorted(self.counts):
            seen += self.counts[b]
            if seen >= rank:
                # clamp to the exact extremes so p0/p100 are honest
                v = self._bucket_value(b)
                return min(max(v, self.min), self.max)
        return self.max  # pragma: no cover — rank <= count always hits

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self, round_to: int = 3) -> Dict[str, float]:
        """Compact summary for bench rows / heartbeats (empty → count 0)."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": round(self.mean, round_to),
            "min": round(self.min, round_to),
            "max": round(self.max, round_to),
            "p50": round(self.percentile(50), round_to),
            "p90": round(self.percentile(90), round_to),
            "p99": round(self.percentile(99), round_to),
        }

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"Histogram({self.name!r}, {self.summary()})"
