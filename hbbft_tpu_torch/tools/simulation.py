"""Simulation benchmark CLI — the port's ``examples/simulation.py``, the
``examples/simulation.rs`` equivalent.

Runs N QueueingHoneyBadger nodes (wrapped in SenderQueue) over a simulated
network with per-message latency λ + size/bandwidth delay and a CPU factor
on message handling, then prints a per-epoch table and tx/s.

Virtual-time model:

* each node has a virtual clock; handling a message advances it by
  cpu_factor · handling_cost;
* a message sent at sender-time t arrives no earlier than
  t + λ + size/bandwidth; the recipient processes it at
  max(recipient_clock, arrival).

Deferred crypto (CryptoWork) is accumulated and flushed in batches of
``--crypto-window`` messages so a device backend resolves whole windows in
one dispatch per kind.

Backends: ``torch`` (the default) is ``TorchBackend()`` on the card, and
raises without one; ``cpu`` is ``TorchBackend(device="cpu")``, the same
code on the CPU through the kernels' plain versions (slow: real BLS);
``mesh`` is ``MeshBackend()`` over every card of the host (raises without
one) and ``mesh-cpu`` the same over MESH_CPU_ENTRIES entries of the CPU;
``mock`` is ``MockBackend()``, the protocol logic with no real crypto.

Observability (hbbft_tpu_torch/obs): ``--trace PATH`` (or
``HBBFT_TPU_TRACE=PATH``) records protocol/device spans + latency
histograms and writes a Chrome-trace-event/Perfetto ``trace.json``
(``.jsonl`` → raw event lines); ``--heartbeat S`` emits a JSON health line
every S seconds; ``--stall-timeout T`` arms the stall detector, which after
T seconds without progress dumps a why-stalled report naming the blocked
BA/RBC instances.

``--checkpoint FILE`` writes a canonical whole-simulation snapshot after
the run and ``--resume FILE`` continues from one (utils/snapshot.py; the
array engine through ``ArrayHoneyBadgerNet.checkpoint``/``restore``).

Usage:
    python -m hbbft_tpu_torch.tools.simulation -n 10 -f 3 -b 100 --epochs 5
    python -m hbbft_tpu_torch.tools.simulation -n 4 -f 1 --backend mock
    python -m hbbft_tpu_torch.tools.simulation -n 10 -f 3 --engine array --trace trace.json
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import pickle
import random
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.types import CryptoWork, Step
from hbbft_tpu_torch.crypto.backend import MockBackend
from hbbft_tpu_torch.obs.health import HealthReporter, why_stalled
from hbbft_tpu_torch.obs.tracer import Tracer
from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger
from hbbft_tpu_torch.protocols.sender_queue import SenderQueue


#: ``--backend`` choices (``make_backend``)
BACKENDS = ("torch", "cpu", "mesh", "mesh-cpu", "mock")
#: entries of the ``mesh-cpu`` backend's mesh (structural: one CPU)
MESH_CPU_ENTRIES = 4


def make_backend(name: str):
    if name == "mock":
        return MockBackend()
    if name in ("torch", "cpu"):
        from hbbft_tpu_torch.ops.backend import TorchBackend

        return TorchBackend() if name == "torch" else TorchBackend(device="cpu")
    if name in ("mesh", "mesh-cpu"):
        from hbbft_tpu_torch.parallel import MeshBackend, device_mesh

        if name == "mesh":
            return MeshBackend()
        return MeshBackend(device_mesh(MESH_CPU_ENTRIES, device="cpu"))
    raise ValueError(f"unknown backend {name!r}")


class SimNode:
    def __init__(self, nid: int, algo: SenderQueue) -> None:
        self.id = nid
        self.algo = algo
        self.clock = 0.0  # virtual seconds
        self.outputs: List[Any] = []
        self.sent_msgs = 0


class Simulation:
    """Virtual-time event loop over N sans-I/O nodes."""

    def __init__(self, args, backend, rng: random.Random) -> None:
        self.args = args
        self.backend = backend
        self.rng = rng
        ids = list(range(args.num_nodes))
        netinfos = NetworkInfo.generate_map(ids, rng, backend)
        self.nodes: Dict[int, SimNode] = {}
        for nid in ids:
            qhb = (
                QueueingHoneyBadger.builder(netinfos[nid], backend, rng)
                .batch_size(args.batch_size)
                .session_id(b"simulation")
                .build()
            )
            self.nodes[nid] = SimNode(nid, SenderQueue(qhb))
        self._all_ids = sorted(self.nodes)
        self._size_cache: Dict[Any, int] = {}
        self.events: List[Tuple[float, int, int, int, Any]] = []  # (t, seq, to, frm, payload)
        self._seq = 0
        self.delivered = 0
        self._pending_work: List[Tuple[int, CryptoWork]] = []
        self._resumed = False
        self.faults = 0
        #: opt-in observability (attached by main() after construction)
        self.tracer: Optional[Tracer] = None
        self.health: Optional[HealthReporter] = None

    # -- plumbing ------------------------------------------------------------

    def _payload_size(self, payload: Any) -> int:
        """Serialized size for the virtual bandwidth model.

        pickle.dumps per delivery was 14% of an N=20 run; messages are
        frozen dataclasses (hashable), so identical broadcast payloads hit
        a per-run cache instead of re-serializing per recipient.  The cache
        is instance-scoped (dies with the Simulation) and bounded.
        """
        cache = self._size_cache
        try:
            s = cache.get(payload)
        except TypeError:  # unhashable payload — serialize directly
            return len(pickle.dumps(payload, protocol=4))
        if s is None:
            s = len(pickle.dumps(payload, protocol=4))
            if len(cache) >= 8192:
                cache.clear()
            cache[payload] = s
        return s

    def _msg_delay(self, payload: Any) -> float:
        size = self._payload_size(payload)
        return self.args.lam / 1000.0 + size / (self.args.bandwidth * 1024.0)

    def _emit(self, node: SimNode, step: Step) -> None:
        node.outputs.extend(step.output)
        if step.fault_log.entries:
            self.faults += len(step.fault_log.entries)
        for work in step.work:
            self._pending_work.append((node.id, work))
        all_ids = self._all_ids
        for tm in step.messages:
            t = node.clock + self._msg_delay(tm.message)  # size once per msg
            for to in tm.target.recipients(all_ids, our_id=node.id):
                self._seq += 1
                node.sent_msgs += 1
                heapq.heappush(self.events, (t, self._seq, to, node.id, tm.message))

    def _flush_work(self) -> None:
        while self._pending_work:
            batch, self._pending_work = self._pending_work, []
            by_kind: Dict[str, List[Tuple[int, CryptoWork]]] = defaultdict(list)
            for owner, w in batch:
                by_kind[w.kind].append((owner, w))
            for kind, items in by_kind.items():
                payloads = [w.payload for _, w in items]
                if kind == "verify_sig_share":
                    results = self.backend.verify_sig_shares(payloads)
                elif kind == "verify_dec_share":
                    results = self.backend.verify_dec_shares(payloads)
                elif kind == "verify_signature":
                    results = self.backend.verify_signatures(payloads)
                elif kind == "verify_ciphertext":
                    results = self.backend.verify_ciphertexts(payloads)
                else:
                    raise RuntimeError(f"unknown work kind {kind!r}")
                for (owner, w), res in zip(items, results):
                    follow = w.on_result(res)
                    if follow:
                        self._emit(self.nodes[owner], follow)

    # -- checkpoint/resume ---------------------------------------------------

    def checkpoint(self) -> bytes:
        """Serialize the whole simulation — every node's protocol stack,
        clocks, outputs, the in-flight event heap, and the shared RNG — to
        canonical snapshot bytes (utils/snapshot.py)."""
        from hbbft_tpu_torch.utils.snapshot import save_node

        if self._pending_work:
            raise RuntimeError(
                "checkpoint only at a flushed barrier (pending CryptoWork)"
            )
        return save_node(
            {
                "algos": {nid: n.algo for nid, n in self.nodes.items()},
                "clocks": {nid: n.clock for nid, n in self.nodes.items()},
                "outputs": {nid: n.outputs for nid, n in self.nodes.items()},
                "sent": {nid: n.sent_msgs for nid, n in self.nodes.items()},
                "events": self.events,
                "seq": self._seq,
                "delivered": self.delivered,
                "rng": self.rng,
            }
        )

    @classmethod
    def from_checkpoint(cls, args, backend, blob: bytes) -> "Simulation":
        """Resume without rebuilding nodes: skips the N-node key generation
        ``__init__`` performs (seconds of BLS keygen on the cpu backend)
        and fills the whole simulation from the snapshot."""
        sim = cls.__new__(cls)
        sim.args = args
        sim.backend = backend
        sim.rng = random.Random()  # replaced by the snapshot's rng below
        sim.nodes = {}
        sim._all_ids = []
        sim._size_cache = {}
        sim.events = []
        sim._seq = 0
        sim.delivered = 0
        sim._pending_work = []
        sim._resumed = False
        sim.faults = 0
        sim.tracer = None
        sim.health = None
        sim.restore(blob)
        return sim

    def restore(self, blob: bytes) -> None:
        """Replace this simulation's state with a :meth:`checkpoint`'s.

        The backend stays this instance's (environment, not state); key
        material rides inside the serialized NetworkInfos."""
        from hbbft_tpu_torch.utils.snapshot import SnapshotError, load_node

        state = load_node(blob, self.backend)
        if not isinstance(state, dict) or "algos" not in state:
            raise SnapshotError(
                f"snapshot holds {type(state).__name__}, not an object-engine "
                "simulation (array snapshots resume via --engine array)"
            )
        snap_ids = sorted(state["algos"])
        if len(snap_ids) != self.args.num_nodes:
            raise SnapshotError(
                f"snapshot has {len(snap_ids)} nodes, -n/--num-nodes is "
                f"{self.args.num_nodes}"
            )
        if self.nodes and sorted(self.nodes) != snap_ids:
            raise SnapshotError(
                f"snapshot has nodes {snap_ids}, this simulation has "
                f"{sorted(self.nodes)}"
            )
        if not self.nodes:  # from_checkpoint shell
            self.nodes = {nid: SimNode(nid, None) for nid in snap_ids}
            self._all_ids = snap_ids
        self._resumed = True
        for nid, node in self.nodes.items():
            node.algo = state["algos"][nid]
            node.clock = state["clocks"][nid]
            node.outputs = state["outputs"][nid]
            node.sent_msgs = state["sent"][nid]
        self.events = state["events"]
        self._seq = state["seq"]
        self.delivered = state["delivered"]
        self.rng = state["rng"]
        self._pending_work = []
        self._size_cache.clear()

    # -- run -----------------------------------------------------------------

    def run(self) -> List[dict]:
        a = self.args
        # Seed every node's queue with its share of transactions — unless
        # this simulation was restored from a checkpoint (whose queue state
        # rode in with the snapshot, even if no epoch completed before it).
        if not self._resumed:
            for nid, node in sorted(self.nodes.items()):
                for k in range(a.txns):
                    tx = f"tx-{nid}-{k}-".encode() + bytes(a.tx_size)
                    self._emit(node, node.algo.handle_input(("user", tx), rng=self.rng))
            self._flush_work()

        target = a.epochs
        rows = []
        done_epochs = min(len(n.outputs) for n in self.nodes.values())
        wall0 = time.perf_counter()
        tracer = self.tracer
        t_epoch = wall0
        while done_epochs < target:
            if not self.events:
                self._flush_work()
                if not self.events:
                    # quiesced short of the target: no later tick will
                    # ever see the stall timeout, so report it NOW —
                    # this is the state why_stalled names culprits for.
                    # Only when the stall detector is armed: --heartbeat
                    # alone must not emit stall records.
                    if (
                        self.health is not None
                        and self.health.stall_timeout_s
                        and done_epochs < target
                    ):
                        self.health.report_quiesced(
                            epoch=done_epochs, msgs=self.delivered
                        )
                    break
            burst = 0
            while self.events and burst < a.crypto_window:
                t, _, to, frm, payload = heapq.heappop(self.events)
                node = self.nodes[to]
                node.clock = max(node.clock, t) + a.cpu_factor / 1000.0
                self.delivered += 1
                if tracer is None:
                    step = node.algo.handle_message(frm, payload, rng=self.rng)
                else:
                    t0 = time.perf_counter()
                    step = node.algo.handle_message(frm, payload, rng=self.rng)
                    t1 = time.perf_counter()
                    tracer.hist("crank_latency_us").record((t1 - t0) * 1e6)
                    if tracer.crank_spans:
                        tracer.complete(
                            f"crank:{type(payload).__name__}", t0, t1,
                            cat="crank", track="crank", to=to,
                        )
                self._emit(node, step)
                burst += 1
            self._flush_work()
            if tracer is not None:
                tracer.hist("event_queue_depth").record(len(self.events))
                h = tracer.hist("sender_queue_depth")
                for n_ in self.nodes.values():
                    out = getattr(n_.algo, "_outgoing", None)
                    if out is not None:
                        h.record(sum(len(v) for v in out.values()))
            if self.health is not None:
                self.health.tick(
                    epoch=done_epochs, msgs=self.delivered, faults=self.faults
                )

            min_epochs = min(len(n.outputs) for n in self.nodes.values())
            while done_epochs < min_epochs:
                if tracer is not None:
                    now = time.perf_counter()
                    tracer.complete(
                        f"epoch:{done_epochs}", t_epoch, now, cat="epoch",
                        epoch=done_epochs,
                    )
                    t_epoch = now
                batch = self.nodes[0].outputs[done_epochs]
                vtime = max(n.clock for n in self.nodes.values())
                txns = sum(len(c) for c in getattr(batch, "contributions", {}).values())
                c = self.backend.counters
                rows.append(
                    {
                        "epoch": done_epochs,
                        "virtual_ms": round(vtime * 1000.0, 2),
                        "wall_s": round(time.perf_counter() - wall0, 3),
                        "txns": txns,
                        "msgs": self.delivered,
                        # operative crypto counters (SURVEY.md §5): cumulative
                        "shares_verified": c.sig_shares_verified
                        + c.dec_shares_verified,
                        "pairing_checks": c.pairing_checks,
                        "shares_combined": c.sig_shares_combined
                        + c.dec_shares_combined,
                        "dispatches": c.device_dispatches,
                    }
                )
                done_epochs += 1
        return rows


def run_array(
    args,
    backend,
    rng: random.Random,
    tracer: Optional[Tracer] = None,
    health: Optional[HealthReporter] = None,
) -> List[dict]:
    """Drive the lockstep array engine (hbbft_tpu_torch/engine) with the same
    transaction/virtual-time model and produce the same table rows.

    Virtual time per lockstep round: λ + max-message-size/bandwidth +
    cpu_factor (every node handles its inbound burst concurrently in the
    lockstep model, so handling cost is per-round, not per-message)."""
    from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet

    churn_at = set(getattr(args, "churn_at", None) or [])
    bad = [e for e in churn_at if not 0 <= e < args.epochs]
    if bad:  # validate BEFORE paying N-node key generation
        raise SystemExit(f"--churn-at indices out of range: {bad}")
    if args.resume:
        with open(args.resume, "rb") as fh:
            net = ArrayHoneyBadgerNet.restore(fh.read(), backend)
        if len(net.ids) != args.num_nodes:
            raise SystemExit(
                f"snapshot holds N={len(net.ids)} nodes, CLI says "
                f"-n {args.num_nodes}"
            )
        if net.epoch >= args.epochs:
            raise SystemExit(
                f"snapshot already at epoch {net.epoch} >= --epochs {args.epochs}"
            )
        stale = [e for e in churn_at if e < net.epoch]
        if stale:
            raise SystemExit(
                f"--churn-at {sorted(stale)} precede the snapshot's epoch "
                f"{net.epoch}; churn indices are absolute"
            )
        # explicit flags override; otherwise the snapshot's workload wins
        # (a resumed soak must not silently change shape)
        if args.coin_rounds is not None:
            net.coin_rounds = args.coin_rounds
        net.dynamic = net.dynamic or bool(churn_at)
        print(
            f"resumed array engine at epoch {net.epoch}, era {net.era}, "
            f"coin_rounds={net.coin_rounds}, dynamic={net.dynamic}"
        )
    else:
        net = ArrayHoneyBadgerNet(
            range(args.num_nodes),
            backend=backend,
            seed=args.seed,
            coin_rounds=args.coin_rounds or 0,
            dynamic=bool(churn_at),
        )
    net.tracer = tracer
    # Tables are PER-RUN (virtual clock, msgs, and the cumulative crypto
    # counters all start at this run's zero — backend counters are
    # environment, not snapshot state); only the epoch INDEX is absolute,
    # so concatenated soak tables line up by epoch without mixing bases.
    rows: List[dict] = []
    vtime = 0.0
    wall0 = time.perf_counter()
    delivered = 0
    # absolute epoch indices: a resumed run continues to the same total
    # horizon the object engine uses (--epochs 2 --checkpoint, then
    # --epochs 4 --resume runs epochs 2..3)
    for epoch in range(net.epoch, args.epochs):
        if epoch in churn_at:
            crep = net.era_change()
            # fold the churn's network/rounds cost into the SAME virtual
            # clock the epochs use (its crypto already lands in the
            # cumulative counter columns)
            vtime += crep.rounds * (
                args.lam / 1000.0 + args.cpu_factor / 1000.0
            )
            delivered += crep.messages_delivered
            print(
                f"  era change before epoch {epoch}: era={net.era} "
                f"votes={crep.votes_verified} kg_acks={crep.kg_acks_handled} "
                f"msgs={crep.messages_delivered}"
            )
        contribs = {}
        for nid in net.ids:
            txs = [
                f"tx-{nid}-{epoch}-{k}-".encode() + bytes(args.tx_size)
                for k in range(args.batch_size)
            ]
            contribs[nid] = b"\x00".join(txs)
        batches = net.run_epoch(contribs)
        rep = net.reports[-1]
        # Largest message is a Value/Echo proof ≈ shard + path; bound it by
        # the framed contribution size / data shards + 32·depth overhead.
        framed = max(len(c) for c in contribs.values()) + 4
        shard = -(-framed // net.codec.k)
        max_msg = shard + 32 * 8 + 64
        vtime += rep.rounds * (
            args.lam / 1000.0
            + max_msg / (args.bandwidth * 1024.0)
            + args.cpu_factor / 1000.0
        )
        delivered += rep.messages_delivered
        batch = batches[net.ids[0]]
        # synthetic queue model: every contribution carries batch_size txns
        txns = len(batch.contributions) * args.batch_size
        c = backend.counters
        rows.append(
            {
                "epoch": epoch,
                "virtual_ms": round(vtime * 1000.0, 2),
                "wall_s": round(time.perf_counter() - wall0, 3),
                "txns": txns,
                "msgs": delivered,
                "shares_verified": c.sig_shares_verified
                + c.dec_shares_verified,
                "pairing_checks": c.pairing_checks,
                "shares_combined": c.sig_shares_combined
                + c.dec_shares_combined,
                "dispatches": c.device_dispatches,
            }
        )
        if health is not None:
            health.tick(epoch=epoch + 1, msgs=delivered)
    if args.checkpoint:
        with open(args.checkpoint, "wb") as fh:
            fh.write(net.checkpoint())
        print(f"checkpoint written to {args.checkpoint}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-n", "--num-nodes", type=int, default=4)
    p.add_argument("-f", "--num-faulty", type=int, default=1)
    p.add_argument("-b", "--batch-size", type=int, default=100)
    p.add_argument("-t", "--tx-size", type=int, default=10, help="bytes per txn payload")
    p.add_argument("--txns", type=int, default=200, help="txns queued per node")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lam", type=float, default=100.0, help="latency λ in ms")
    p.add_argument("--bandwidth", type=float, default=2000.0, help="KB/s per link")
    p.add_argument("--cpu-factor", type=float, default=1.0, help="handling cost ms")
    p.add_argument("--crypto-window", type=int, default=64,
                   help="messages handled between crypto batch flushes")
    p.add_argument(
        "--backend", choices=BACKENDS, default="torch",
        help="torch = TorchBackend() on the card (raises without one); cpu = "
        "TorchBackend(device='cpu'); mesh = MeshBackend() over the host's cards; "
        "mesh-cpu = MeshBackend over CPU entries; mock = MockBackend() (no real crypto)",
    )
    p.add_argument(
        "--engine",
        choices=("object", "array"),
        default="object",
        help="object = per-message VirtualNet runtime; array = lockstep "
        "whole-network engine (hbbft_tpu_torch/engine)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--coin-rounds", type=int, default=None, dest="coin_rounds",
        help="array engine: real threshold-sign coin rounds per BA "
        "instance (the split-input schedule; 0 = fixed-coin fast path)",
    )
    p.add_argument(
        "--churn-at", type=int, nargs="*", dest="churn_at", default=None,
        help="array engine: epoch indices before which a vote->DKG->era "
        "change runs (BASELINE config 3 churn)",
    )
    p.add_argument(
        "--checkpoint",
        metavar="FILE",
        help="write a canonical whole-simulation snapshot here after the run "
        "(both engines)",
    )
    p.add_argument(
        "--resume",
        metavar="FILE",
        help="resume from a --checkpoint snapshot; --epochs is the TOTAL "
        "epoch count including pre-checkpoint epochs",
    )
    p.add_argument(
        "--trace",
        metavar="PATH",
        default=os.environ.get("HBBFT_TPU_TRACE"),
        help="record spans + histograms; write a Chrome-trace/Perfetto "
        "JSON (or raw JSONL if PATH ends in .jsonl) here "
        "(default: $HBBFT_TPU_TRACE)",
    )
    p.add_argument(
        "--crank-spans",
        action="store_true",
        help="with --trace on the object engine: one span per delivered "
        "message (small runs only — large runs fill the event buffer)",
    )
    p.add_argument(
        "--heartbeat", type=float, default=0.0, metavar="S",
        help="emit a JSON health heartbeat every S wall seconds (0 = off)",
    )
    p.add_argument(
        "--stall-timeout", type=float, default=0.0, metavar="T",
        help="after T seconds without progress, dump a why-stalled report "
        "naming the blocked BA/RBC instances (0 = off)",
    )
    args = p.parse_args(argv)

    if args.num_nodes <= 3 * args.num_faulty:
        p.error(f"N={args.num_nodes} cannot tolerate f={args.num_faulty} (need N>3f)")

    rng = random.Random(args.seed)
    backend = make_backend(args.backend)
    tracer: Optional[Tracer] = None
    if args.trace:
        tracer = Tracer()
        tracer.crank_spans = args.crank_spans
        backend.tracer = tracer
    health: Optional[HealthReporter] = None
    if args.heartbeat or args.stall_timeout:
        health = HealthReporter(
            # --heartbeat 0 means OFF, even with the stall detector armed
            interval_s=args.heartbeat if args.heartbeat else float("inf"),
            stall_timeout_s=args.stall_timeout,
            counters_fn=backend.counters.snapshot,
            # mesh backends report per-device dispatch balance per beat
            shard_stats_fn=getattr(backend, "shard_stats", None),
        )
    print(
        f"hbbft_tpu_torch simulation: N={args.num_nodes} f={args.num_faulty} "
        f"batch={args.batch_size} backend={args.backend} engine={args.engine}"
    )
    if args.engine == "array":
        rows = run_array(args, backend, rng, tracer=tracer, health=health)
    else:
        if args.churn_at is not None or args.coin_rounds:
            p.error("--churn-at/--coin-rounds require --engine array")
        if args.resume:
            with open(args.resume, "rb") as fh:
                sim = Simulation.from_checkpoint(args, backend, fh.read())
        else:
            sim = Simulation(args, backend, rng)
        sim.tracer = tracer
        if health is not None:
            health.stall_report_fn = lambda: why_stalled(sim.nodes)
            sim.health = health
        rows = sim.run()
        if args.checkpoint:
            with open(args.checkpoint, "wb") as fh:
                fh.write(sim.checkpoint())
            print(f"checkpoint written to {args.checkpoint}")
    if tracer is not None:
        tracer.write(args.trace)
        print(
            f"trace written to {args.trace} "
            f"({len(tracer)} events, {tracer.dropped} dropped)"
        )
        summary = tracer.hist_summary()
        if summary:
            print("histograms: " + json.dumps(summary))
    print(
        f"{'epoch':>6} {'virt ms':>10} {'wall s':>8} {'txns':>6} {'msgs':>8} "
        f"{'shr.vrf':>8} {'pairchk':>8} {'shr.cmb':>8} {'disp':>6}"
    )
    total_tx = 0
    for r in rows:
        total_tx += r["txns"]
        print(
            f"{r['epoch']:>6} {r['virtual_ms']:>10} {r['wall_s']:>8} "
            f"{r['txns']:>6} {r['msgs']:>8} {r['shares_verified']:>8} "
            f"{r['pairing_checks']:>8} {r['shares_combined']:>8} "
            f"{r['dispatches']:>6}"
        )
    if rows:
        vt = rows[-1]["virtual_ms"] / 1000.0
        wt = rows[-1]["wall_s"]
        print(
            f"total: {total_tx} txns in {len(rows)} epochs; "
            f"{total_tx / vt if vt else 0:.1f} tx/s virtual; "
            f"{len(rows) / wt if wt else 0:.2f} epochs/s wall"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
