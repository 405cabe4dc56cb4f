"""Traffic drivers: sustained client load against both runtimes.

:class:`ArrayTrafficDriver` reproduces QueueingHoneyBadger's sampling
loop at array-engine scale: per-node bounded mempools are fed by a
workload source, each lockstep epoch's contributions are random
``batch_size`` samples (the same ``TransactionQueue.choose`` math QHB
uses), and committed Batches flow back through the engine's
``batch_listeners`` fan-out hook into the lifecycle tracker and the
mempools' removal path.  The batch-size knob becomes a
throughput/latency *curve*, with sustained tx/s and p50/p99 commit
latency as first-class outputs next to epochs/s.

:class:`ObjectTrafficDriver` drives the same source/mempool/tracker
machinery through the per-message object runtime (VirtualNet +
QueueingHoneyBadger) for small-N parity: admission happens in the same
BoundedMempool, accepted transactions are pushed into each node's real
QHB, and commits are read off ``node.outputs``.  The driver registers
itself as the net's ``traffic`` context so ``why_stalled`` names a
starved or saturated source instead of an anonymous missing quorum.

Virtual time: one epoch (array) / one submission wave (object) = one
unit; arrivals carry fractional times inside their unit, proposals are
sampled at the unit boundary, and a Batch commits one unit after it was
proposed.  All entropy comes from the injected ``rng``, so wall-clock rates are
measured by
the CALLER around :meth:`run` — the driver itself never reads a clock.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

from hbbft_tpu_torch.net.virtual_net import CrankError
from hbbft_tpu_torch.traffic.mempool import BoundedMempool
from hbbft_tpu_torch.traffic.tracker import TxTracker
from hbbft_tpu_torch.utils import canonical


class _TrafficBase:
    """Shared admission / status plumbing of the two drivers."""

    def __init__(
        self,
        ids: List[Any],
        source,
        rng,
        batch_size: int,
        mempool_capacity: int,
        mempool_policy: str,
        fanout: str,
        tracer=None,
        health=None,
        controller=None,
        mempool_shards: int = 1,
    ) -> None:
        if fanout not in ("all", "one"):
            raise ValueError(f"unknown fanout {fanout!r}")
        self.ids = ids  # sorted by the caller (engine/net order)
        self.source = source
        self.rng = rng
        self.batch_size = batch_size
        self.fanout = fanout
        self.tracer = tracer
        self.health = health
        #: optional hbbft_tpu_torch.control AdaptiveBatchController: observes
        #: the tracker's recent window once per epoch/wave and steers the
        #: live batch size through the ``batch_size_provider`` hook
        #: (array engine) / input-borne updates (object runtime)
        self.controller = controller
        self.mempools: List[BoundedMempool] = [
            BoundedMempool(
                mempool_capacity,
                policy=mempool_policy,
                shards=mempool_shards,
            )
            for _ in ids
        ]
        self.tracker = TxTracker(tracer.hist if tracer is not None else None)
        # sharded pools route by sha256-of-canonical: hash each arrival
        # ONCE here and share the digest across all N mempools and the
        # tracker (fanout="all" would otherwise recompute it N+1 times
        # per tx — pure waste on the million-client hot path)
        self._shard_routing = mempool_shards > 1
        self._last_wave_shed = False  # most recent wave dropped/evicted
        self.backpressure_epochs = 0
        self.committed_per_epoch: List[int] = []
        self.epochs_run = 0

    # -- admission -----------------------------------------------------------

    def _admit_wave(self, epoch: int) -> int:
        """Draw one unit's arrivals and push them through admission.
        Returns the number of transactions accepted somewhere."""
        bp = self.backpressure
        if bp:
            self.backpressure_epochs += 1
            if getattr(self.source, "name", "") == "closed_loop":
                self.tracker.on_shed(1)  # one deferred top-up wave
        arrivals = self.source.arrivals(self.rng, epoch, backpressure=bp)
        accepted = 0
        shed_before = sum(mp.dropped + mp.evicted for mp in self.mempools)
        n = len(self.ids)
        for t, tx in arrivals:
            digest = None
            if self._shard_routing:
                try:
                    digest = hashlib.sha256(canonical.encode(tx)).digest()
                except Exception:
                    digest = None  # unencodable: mempools route shard 0
            self.tracker.on_submit(tx, t, digest=digest)
            if self.fanout == "all":
                targets = range(n)
            else:
                # deterministic client->node load balancing
                targets = (tx[1] % n,)
            best = "dropped"
            victims: List[Any] = []
            for i in targets:
                outcome = self.mempools[i].submit(tx, digest=digest)
                if outcome in ("accepted", "evicted_oldest"):
                    best = "accepted"
                    self._accepted_at(i, tx)
                    if outcome == "evicted_oldest":
                        victims.append(self.mempools[i].last_evicted)
                elif outcome != "dropped" and best == "dropped":
                    best = outcome
            self.tracker.on_admission(best, tx)
            # on_rejected is an optional source hook (duck-typed, like
            # the whole workload contract — see README)
            rejected = getattr(self.source, "on_rejected", None)
            if best in ("dropped", "invalid") and rejected is not None:
                # a submission rejected everywhere will never commit:
                # release the source's concurrency slot too, or a
                # closed-loop window shrinks by every rejection forever
                rejected(1)
            # fanout="all" keeps the N mempools in lockstep, so they all
            # evict the SAME oldest entry — dedup before releasing, or a
            # closed-loop window is over-released N-fold per eviction
            # (degenerating fixed concurrency into an open loop)
            for v in dict.fromkeys(victims):
                # a victim still held by another mempool (fanout="all")
                # can still commit; one gone everywhere never will
                if v is not None and not any(v in mp for mp in self.mempools):
                    self.tracker.on_evicted(v)
                    if rejected is not None:
                        rejected(1)
            if best == "accepted":
                accepted += 1
        self._last_wave_shed = (
            sum(mp.dropped + mp.evicted for mp in self.mempools) > shed_before
        )
        if self.tracer is not None:
            self.tracer.hist("tx_arrivals_per_epoch").record(len(arrivals))
        return accepted

    def _accepted_at(self, node_idx: int, tx) -> None:
        """Hook: object driver mirrors admission into the live protocol."""

    # -- adaptive batch control ---------------------------------------------

    def _controller_obs(self, epoch: int):
        """Assemble the controller's Observation from the tracker's
        recent window + current mempool state (all virtual quantities —
        the controller never sees a wall clock)."""
        from hbbft_tpu_torch.control.controller import Observation

        # now=epoch bounds the window to completed epochs: commits are
        # recorded at commit time (epoch+2) and would otherwise open
        # future slots that dilute the arrival-rate estimate
        rs = self.tracker.recent_summary(self.controller.window, now=epoch)
        return Observation(
            epoch=epoch,
            p99=rs["p99"],
            tx_per_epoch=rs["committed_per_epoch"],
            arrivals_per_epoch=rs["submitted_per_epoch"],
            mempool_depth=self.max_depth,
            backpressure=self.backpressure,
            validators=len(self.ids),
            arrivals_last=rs["submitted_last"],
        )

    def _record_depths(self) -> None:
        depth_hist = self.tracer.hist("mempool_depth") if self.tracer else None
        for mp in self.mempools:
            if depth_hist is not None:
                depth_hist.record(mp.depth)

    def _tick_health(self, epoch: int, msgs: Optional[float] = None) -> None:
        if self.health is None:
            return
        extra = {}
        if self.controller is not None:
            # the controller's current B and SLO compliance ride every
            # heartbeat (the control loop must be observable)
            extra["batch_size"] = self.controller.current_b
            extra["slo_compliant"] = self.controller.last_compliant
        self.health.tick(
            epoch=epoch,
            msgs=msgs,
            mempool_depth=self.max_depth,
            tx_commit_p99=round(self.tracker.commit_p99(), 3),
            tx_committed=self.tracker.committed,
            tx_dropped=self.tracker.dropped,
            **extra,
        )

    # -- introspection (why_stalled / heartbeat surface) ---------------------

    @property
    def backpressure(self) -> bool:
        return any(mp.backpressure for mp in self.mempools)

    @property
    def max_depth(self) -> int:
        return max((mp.depth for mp in self.mempools), default=0)

    def status(self) -> Dict[str, Any]:
        """Traffic-source state for the stall reporter: a quiesced run
        under this driver reads "source starved" or "source saturated",
        not an anonymous missing quorum (obs/health.py traffic context)."""
        dropped = sum(mp.dropped for mp in self.mempools)
        evicted = sum(mp.evicted for mp in self.mempools)
        depth = self.max_depth
        # state reflects RECENT conditions, not lifetime counters:
        # active backpressure or shedding in the latest admission wave
        # is saturation (the post-commit drain dipping below the
        # hysteresis watermark doesn't clear it), while a long-drained
        # run reads starved even if an early burst shed load
        if self.backpressure or self._last_wave_shed:
            state = "saturated"
        elif depth == 0 and self.tracker.pending == 0:
            state = "starved"
        else:
            state = "flowing"
        out = {
            "source": self.source.describe(),
            "state": state,
            "mempool_depth": depth,
            "capacity": self.mempools[0].capacity if self.mempools else 0,
            "dropped": dropped,
            "evicted": evicted,
            "backpressure": self.backpressure,
            "committed": self.tracker.committed,
            "pending": self.tracker.pending,
        }
        if self.controller is not None:
            out["controller"] = self.controller.describe()
        return out

    def report(self) -> Dict[str, Any]:
        out = self._report_base()
        if self.controller is not None:
            out["controller"] = {
                **self.controller.describe(),
                "b_trace": self.controller.b_trace(),
            }
        return out

    def _report_base(self) -> Dict[str, Any]:
        per_epoch = self.committed_per_epoch
        return {
            "epochs": self.epochs_run,
            "committed": self.tracker.committed,
            "committed_per_epoch": per_epoch,
            "tx_per_epoch": (
                round(self.tracker.committed / self.epochs_run, 2)
                if self.epochs_run
                else 0.0
            ),
            "backpressure_epochs": self.backpressure_epochs,
            "mempool_peak_depth": max(
                (mp.peak_depth for mp in self.mempools), default=0
            ),
            "mempool_dropped": sum(mp.dropped for mp in self.mempools),
            "mempool_evicted": sum(mp.evicted for mp in self.mempools),
            "source": self.source.describe(),
            "tracker": self.tracker.summary(),
            "status": self.status(),
        }


class ArrayTrafficDriver(_TrafficBase):
    """Client load through :class:`ArrayHoneyBadgerNet` lockstep epochs.

    Registers a ``batch_listeners`` fan-out callback and installs itself
    as the engine's ``contribution_source``, so either ``driver.run(k)``
    or the engine's own ``net.run_epochs(k)`` executes the full
    submit → sample → commit loop.
    """

    def __init__(
        self,
        net,
        source,
        rng,
        batch_size: int = 64,
        mempool_capacity: int = 1 << 16,
        mempool_policy: str = "reject",
        fanout: str = "all",
        tracer=None,
        health=None,
        controller=None,
        mempool_shards: int = 1,
    ) -> None:
        super().__init__(
            list(net.ids), source, rng, batch_size, mempool_capacity,
            mempool_policy, fanout, tracer=tracer, health=health,
            controller=controller, mempool_shards=mempool_shards,
        )
        self.net = net
        net.batch_listeners = list(net.batch_listeners) + [self._on_batches]
        net.contribution_source = self._contributions_for
        if controller is not None:
            # the engine-side hook (checkpoint-detached env attr, like
            # contribution_source): anything reading the engine sees the
            # controller's live B
            net.batch_size_provider = controller.batch_size

    # -- engine hooks --------------------------------------------------------

    def _contributions_for(self, epoch: int) -> Dict[Any, bytes]:
        """Contribution-sourcing hook: admit the epoch's arrivals, then
        sample every node's proposal (QHB's ``_try_propose`` math).

        The controller (when attached) decides B FIRST, from state
        observed through the previous epoch's commits only — so the
        decision sequence is a pure function of the seeded history and
        replay stays bit-identical."""
        if self.controller is not None:
            self.controller.decide(self._controller_obs(epoch))
        provider = getattr(self.net, "batch_size_provider", None)
        b = provider() if provider is not None else self.batch_size
        self._admit_wave(epoch)
        t_sample = float(epoch + 1)
        contribs: Dict[Any, bytes] = {}
        for i, nid in enumerate(self.ids):
            sample = self.mempools[i].choose(self.rng, b)
            self.tracker.on_sampled(sample, t_sample)
            if self.tracer is not None:
                self.tracer.hist("proposal_size").record(len(sample))
            contribs[nid] = canonical.encode(sample)
        if self.tracer is not None:
            self.tracer.hist("batch_size").record(b)
        self._record_depths()
        return contribs

    def _on_batches(self, batches: Dict[Any, Any]) -> None:
        """Batch-delivery fan-out hook: decode the committed samples,
        close tx lifecycles, and drain every mempool."""
        batch = batches[self.ids[0]]
        t_commit = float(batch.epoch + 2)
        committed: List[Any] = []
        seen: set = set()
        for nid in self.ids:
            blob = batch.contributions.get(nid)
            if not isinstance(blob, (bytes, bytearray)):
                continue
            for tx in canonical.decode(bytes(blob)):
                if tx not in seen:
                    seen.add(tx)
                    committed.append(tx)
        new = self.tracker.on_committed(committed, t_commit)
        self.source.on_committed(new)
        for mp in self.mempools:
            mp.remove_committed(committed)
        self.committed_per_epoch.append(new)
        self.epochs_run += 1
        self._tick_health(
            epoch=batch.epoch, msgs=self.net.counters.messages_delivered
        )

    def run(self, epochs: int) -> Dict[str, Any]:
        for _ in range(epochs):
            self.net.run_epoch(self._contributions_for(self.net.epoch))
        return self.report()


class ObjectTrafficDriver(_TrafficBase):
    """The same load against the per-message object runtime: VirtualNet
    nodes running real QueueingHoneyBadger.  One submission wave per
    virtual unit; cranking between waves delivers whatever the protocols
    produce.  Used for small-N parity with the array driver."""

    def __init__(
        self,
        net,
        source,
        rng,
        batch_size: int = 3,
        mempool_capacity: int = 1 << 12,
        mempool_policy: str = "reject",
        fanout: str = "all",
        tracer=None,
        health=None,
        cranks_per_wave: int = 200_000,
        controller=None,
        mempool_shards: int = 1,
    ) -> None:
        if mempool_policy == "evict_oldest":
            # admission mirrors accepted txs into each node's REAL QHB
            # queue (send_input), but an eviction from the shadow mempool
            # has no path back into the protocol — the two would diverge
            # and an "evicted" tx could still commit.  Bounded admission
            # in object mode means reject.
            raise ValueError(
                "ObjectTrafficDriver only supports mempool_policy='reject': "
                "evictions cannot be propagated into the live protocol queue"
            )
        ids = sorted(net.nodes)
        super().__init__(
            ids, source, rng, batch_size, mempool_capacity, mempool_policy,
            fanout, tracer=tracer, health=health,
            controller=controller, mempool_shards=mempool_shards,
        )
        self.net = net
        self.cranks_per_wave = cranks_per_wave
        #: last B delivered to the live protocols (input-borne — see
        #: _apply_batch_size for why object mode does NOT use the
        #: batch_size_provider hook)
        self._applied_b: Optional[int] = None
        self._seen_batches = 0  # cursor into node0's committed outputs
        net.traffic = self  # why_stalled traffic context
        # queue-dwell probe: QHB calls back with each fresh proposal
        # sample, closing the submit→sampled interval at the current
        # wave boundary (same tx_queue_latency the array driver records
        # in _contributions_for).  Byzantine nodes may run a different
        # algorithm — only instrument the ones that expose the hook.
        self._t_sample = 1.0  # wave 0's unit boundary
        for nid in ids:
            self._install_sample_hook(net.nodes[nid].algorithm)
        # crash axis (net/crash.py): a restored node comes back from a
        # snapshot, which drops the env-attr sample hook — re-install it
        crash = getattr(net, "crash", None)
        if crash is not None:
            crash.add_restart_listener(self._on_restart)

    def _install_sample_hook(self, alg) -> None:
        # the hook lives on the wrapped QHB, not a SenderQueue wrapper:
        # setting it on the wrapper would shadow nothing (QHB reads
        # self.sample_listener) AND make the wrapper unsnapshotable
        inner = getattr(alg, "algo", alg)
        if hasattr(inner, "sample_listener"):
            inner.sample_listener = self._on_sampled

    def _on_restart(self, net, node_id, algo) -> None:
        self._install_sample_hook(algo)

    def _on_sampled(self, sample: List[Any]) -> None:
        self.tracker.on_sampled(sample, self._t_sample)

    def _accepted_at(self, node_idx: int, tx) -> None:
        nid = self.ids[node_idx]
        self.net.send_input(nid, ("user", tx))

    def _apply_batch_size(self, b: int) -> None:
        """Deliver a B change as a ``("batch_size", B)`` INPUT to every
        node's live QHB rather than through the ``batch_size_provider``
        hook: inputs are WAL-logged events under the crash axis
        (net/crash.py), so a restarted node replays the exact B history
        its pre-crash self observed and the replay stays bit-identical —
        a provider would answer with TODAY'S B for yesterday's replayed
        proposals and read as ``crash:replay_divergence``.  A down
        node's update parks and applies at recovery, like votes."""
        if b == self._applied_b:
            return
        self._applied_b = b
        for nid in self.ids:
            self.net.send_input(nid, ("batch_size", b))

    def _wave(self, k: int) -> None:
        if self.controller is not None:
            self._apply_batch_size(
                self.controller.decide(self._controller_obs(k))
            )
        self._t_sample = float(k + 1)
        self._admit_wave(k)
        self._record_depths()
        target = k + 1

        def delivered(net) -> bool:
            down = (
                net.down_node_ids()
                if hasattr(net, "down_node_ids")
                else frozenset()
            )
            return all(
                len(net.nodes[nid].outputs) >= target
                for nid in self.ids
                if not net.nodes[nid].faulty and nid not in down
            )

        try:
            self.net.crank_until(delivered, max_cranks=self.cranks_per_wave)
        except CrankError:
            # a starved wave (no arrivals admitted anywhere) legitimately
            # quiesces without a batch; status() reports the starvation.
            # Anything other than a crank/quiescence trip still raises.
            if self.tracker.pending:
                raise
        self._collect(t_commit=float(k + 2))
        self.epochs_run += 1
        self._tick_health(epoch=k, msgs=self.net.messages_delivered)

    def _collect(self, t_commit: float) -> None:
        node0 = self.net.nodes[self.ids[0]]
        new_total = 0
        for b in node0.outputs[self._seen_batches:]:
            committed: List[Any] = []
            seen: set = set()
            for p in sorted(b.contributions, key=repr):
                txs = b.contributions[p]
                if not isinstance(txs, list):
                    continue
                for tx in txs:
                    if tx not in seen:
                        seen.add(tx)
                        committed.append(tx)
            new = self.tracker.on_committed(committed, t_commit)
            for mp in self.mempools:
                mp.remove_committed(committed)
            new_total += new
        self._seen_batches = len(node0.outputs)
        self.source.on_committed(new_total)
        self.committed_per_epoch.append(new_total)

    def run(self, waves: int) -> Dict[str, Any]:
        for k in range(waves):
            self._wave(k)
        return self.report()
