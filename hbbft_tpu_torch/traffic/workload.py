"""Client-load workload generators for the traffic subsystem — the port's
copy of the JAX package's ``traffic/workload.py``.

"Heavy traffic from millions of users" as *data*: a client population
(Zipf-ranked — a few hot clients dominate, a long tail trickles), an
arrival process (open-loop Poisson rate sweeps, or closed-loop fixed
concurrency), and a payload-size distribution.  Every generator draws
entropy ONLY from the rng injected per call (same seed ⇒ bit-identical
arrival schedule), so a
traffic run is replayable end to end — arrivals, sampled proposals,
Batches, and latency histograms all reproduce.

Transactions are plain canonical-codec trees (``("tx", client, seq,
payload)`` tuples): hashable for the mempool's dedup dict, and they
round-trip exactly through ``utils/canonical`` when a proposal sample is
framed into a contribution.

Time is virtual: one epoch = one unit.  Open-loop arrivals carry
fractional submit times inside their epoch (uniform order statistics,
which conditioned on the Poisson count IS the Poisson process), so
commit latency = commit_epoch − submit_time is exact in epoch units.

**Million-client scale.**  Per-wave draws are batched: one
64-bit seed from the injected rng keys a counter-based numpy stream
(:func:`_uniforms`), client ranks come from ONE vectorized
``searchsorted`` over the precomputed Zipf CDF
(:meth:`ZipfPopulation.sample_wave`), and payload sizes draw as one
array — so a wave costs O(1) python-level rng calls and O(k log C)
total at C = 10⁶–10⁷ clients, with no per-transaction CDF bisect.  An
optional
:class:`~hbbft_tpu_torch.control.trace.LoadTrace` (duck-typed: ``factor`` /
``describe``) modulates the open-loop rate per epoch, making
arrival-rate swings a first-class replayable input.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

#: canonical transaction shape: ("tx", client_id, per-client seq, payload)
Tx = Tuple[str, int, int, bytes]


def make_tx(client: int, seq: int, payload: bytes) -> Tx:
    return ("tx", client, seq, payload)


def _uniforms(rng, k: int) -> np.ndarray:
    """``k`` uniforms in [0, 1) as ONE batched draw.

    Entropy is a single 64-bit seed from the injected rng keying a
    PCG64 stream, so the wave consumes O(1) python-level rng calls
    (pinned in tests) and stays bit-identical given the seed — the
    numpy bit-generator algorithms are version-stable, unlike python's
    randomized ``hash()``."""
    if k <= 0:
        return np.empty(0, dtype=np.float64)
    seed = rng.getrandbits(64)
    return np.random.Generator(np.random.PCG64(seed)).random(k)


class PayloadSizes:
    """Payload-size distribution: ``fixed`` | ``uniform`` | ``bimodal``.

    ``bimodal`` models the realistic mix (many small transfers, a thin
    stream of large blobs): ``small`` bytes with probability
    ``1 - heavy_frac``, else ``large`` bytes.
    """

    def __init__(
        self,
        kind: str = "fixed",
        size: int = 64,
        lo: int = 16,
        hi: int = 256,
        small: int = 32,
        large: int = 1024,
        heavy_frac: float = 0.05,
    ) -> None:
        if kind not in ("fixed", "uniform", "bimodal"):
            raise ValueError(f"unknown payload kind {kind!r}")
        self.kind = kind
        self.size = size
        self.lo, self.hi = lo, hi
        self.small, self.large = small, large
        self.heavy_frac = heavy_frac

    def draw(self, rng) -> int:
        if self.kind == "fixed":
            return self.size
        if self.kind == "uniform":
            return rng.randrange(self.lo, self.hi + 1)
        return self.large if rng.random() < self.heavy_frac else self.small

    def draw_wave(self, rng, k: int) -> List[int]:
        """``k`` sizes as one batched draw (entropy: one seed via
        :func:`_uniforms`; the ``fixed`` kind draws nothing at all)."""
        if self.kind == "fixed":
            return [self.size] * k
        u = _uniforms(rng, k)
        if self.kind == "uniform":
            span = self.hi - self.lo + 1
            return [self.lo + int(x) for x in (u * span)]
        return [
            self.large if x < self.heavy_frac else self.small for x in u
        ]

    def describe(self) -> dict:
        if self.kind == "fixed":
            return {"kind": "fixed", "size": self.size}
        if self.kind == "uniform":
            return {"kind": "uniform", "lo": self.lo, "hi": self.hi}
        return {
            "kind": "bimodal",
            "small": self.small,
            "large": self.large,
            "heavy_frac": self.heavy_frac,
        }


class ZipfPopulation:
    """Zipf(α)-ranked client population: client ``r`` (0-based rank) is
    drawn with weight ``1/(r+1)^alpha``.

    The CDF is precomputed ONCE as a float64 array (vectorized power +
    cumsum — ~30 ms at C = 10⁶, ~0.4 s at 10⁷), so sampling never walks
    the population: :meth:`sample` is one ``searchsorted`` (O(log C)),
    and :meth:`sample_wave` locates a whole wave's uniforms in one
    vectorized call — O(k log C) with no python-per-transaction loop,
    which is what keeps per-wave host cost flat from 10⁴ to 10⁷
    clients."""

    def __init__(self, num_clients: int, alpha: float = 1.1) -> None:
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        self.num_clients = num_clients
        self.alpha = alpha
        weights = np.arange(1, num_clients + 1, dtype=np.float64) ** -alpha
        self._cdf = np.cumsum(weights)
        self._total = float(self._cdf[-1])

    def _locate(self, u: np.ndarray) -> np.ndarray:
        """Ranks for uniforms scaled into [0, total) — the shared math of
        the scalar and wave paths (equivalence pinned in tests)."""
        idx = np.searchsorted(self._cdf, u, side="left")
        return np.minimum(idx, self.num_clients - 1)

    def sample(self, rng) -> int:
        return int(
            self._locate(np.float64(rng.random() * self._total))
        )

    def sample_wave(self, rng, k: int) -> List[int]:
        """``k`` client ranks as one batched draw: one seed from the
        injected rng (:func:`_uniforms`), one vectorized searchsorted
        over the CDF.  Returns plain python ints (they land in
        canonical-codec transaction tuples)."""
        u = _uniforms(rng, k) * self._total
        return self._locate(u).tolist()

    def describe(self) -> dict:
        return {"clients": self.num_clients, "alpha": self.alpha}


def _poisson(rng, lam: float) -> int:
    """Deterministic-given-rng Poisson draw.  Knuth's product method is
    exact but its ``exp(-lam)`` underflows past ~700, so large rates are
    drawn as a sum of independent chunks (Poisson is closed under
    addition) — still exact, still replayable."""
    count = 0
    while lam > 0:
        chunk = min(lam, 500.0)
        lam -= chunk
        limit = math.exp(-chunk)
        prod = rng.random()
        while prod > limit:
            count += 1
            prod *= rng.random()
    return count


class OpenLoopSource:
    """Open-loop Poisson arrivals: ``rate`` transactions per epoch
    network-wide, regardless of what the system commits (the load a
    population of independent clients actually presents).  Payload bytes
    are derived from (client, seq) — cheap and reproducible without
    burning rng draws per byte.

    ``trace`` (optional, duck-typed ``factor(epoch)`` — see
    hbbft_tpu_torch/control/trace.py) multiplies the base rate per epoch, so
    step/spike/diurnal/10×-swing load shapes are part of the replayable
    input, not harness-side rate poking."""

    name = "open_loop"

    def __init__(
        self,
        rate: float,
        population: ZipfPopulation,
        payloads: Optional[PayloadSizes] = None,
        trace=None,
    ) -> None:
        self.rate = rate
        self.population = population
        self.payloads = payloads or PayloadSizes()
        self.trace = trace
        self._seqs: dict = {}  # client -> next seq
        self.generated = 0

    def rate_at(self, epoch: int) -> float:
        if self.trace is None:
            return self.rate
        return self.rate * self.trace.factor(epoch)

    def arrivals(self, rng, epoch: int, backpressure: bool = False) -> List[Tuple[float, Tx]]:
        """(submit_time, tx) pairs for one epoch, times ascending in
        [epoch, epoch+1).  Open-loop clients do not slow down under
        backpressure — overload shedding is the mempool's job.

        Batched: Poisson count first (exact chunked-Knuth), then ONE
        vectorized draw each for times, client ranks, and payload
        sizes; the only per-transaction python work left is the seq
        bookkeeping and tuple construction (O(k), no log C factor)."""
        count = _poisson(rng, self.rate_at(epoch))
        times = np.sort(_uniforms(rng, count)).tolist()
        clients = self.population.sample_wave(rng, count)
        sizes = self.payloads.draw_wave(rng, count)
        out: List[Tuple[float, Tx]] = []
        for t, client, size in zip(times, clients, sizes):
            seq = self._seqs.get(client, 0)
            self._seqs[client] = seq + 1
            payload = _payload_bytes(client, seq, size)
            out.append((epoch + t, make_tx(client, seq, payload)))
        self.generated += count
        return out

    def on_committed(self, n: int) -> None:  # open loop ignores completions
        pass

    def on_rejected(self, n: int) -> None:  # ...and admission rejections
        pass

    def describe(self) -> dict:
        out = {
            "source": self.name,
            "rate_per_epoch": self.rate,
            "population": self.population.describe(),
            "payloads": self.payloads.describe(),
        }
        if self.trace is not None:
            out["trace"] = self.trace.describe()
        return out


class ClosedLoopSource:
    """Closed-loop fixed concurrency: each of ``concurrency`` virtual
    clients keeps exactly one transaction in flight, submitting a
    replacement only when one commits — the classic saturation-free load
    shape.  Honors backpressure: a mempool signaling overload defers the
    top-up to the next epoch."""

    name = "closed_loop"

    def __init__(
        self,
        concurrency: int,
        population: ZipfPopulation,
        payloads: Optional[PayloadSizes] = None,
    ) -> None:
        self.concurrency = concurrency
        self.population = population
        self.payloads = payloads or PayloadSizes()
        self._seqs: dict = {}
        self.in_flight = 0
        self.generated = 0

    def arrivals(self, rng, epoch: int, backpressure: bool = False) -> List[Tuple[float, Tx]]:
        if backpressure:
            return []
        want = max(self.concurrency - self.in_flight, 0)
        times = np.sort(_uniforms(rng, want)).tolist()
        clients = self.population.sample_wave(rng, want)
        sizes = self.payloads.draw_wave(rng, want)
        out: List[Tuple[float, Tx]] = []
        for t, client, size in zip(times, clients, sizes):
            seq = self._seqs.get(client, 0)
            self._seqs[client] = seq + 1
            out.append((epoch + t, make_tx(client, seq, _payload_bytes(client, seq, size))))
        self.in_flight += len(out)
        self.generated += len(out)
        return out

    def on_committed(self, n: int) -> None:
        self.in_flight = max(0, self.in_flight - n)

    def on_rejected(self, n: int) -> None:
        """A submission rejected at admission (mempool full/invalid) will
        never commit: release its concurrency slot, or the effective
        window silently shrinks by every rejection for the rest of the
        run (with concurrency > capacity the source would stop
        generating entirely)."""
        self.in_flight = max(0, self.in_flight - n)

    def describe(self) -> dict:
        return {
            "source": self.name,
            "concurrency": self.concurrency,
            "population": self.population.describe(),
            "payloads": self.payloads.describe(),
        }


def _payload_bytes(client: int, seq: int, size: int) -> bytes:
    """Deterministic payload content of exactly ``size`` bytes."""
    stamp = client.to_bytes(8, "big") + seq.to_bytes(8, "big")
    reps = -(-size // len(stamp))
    return (stamp * reps)[:size]
