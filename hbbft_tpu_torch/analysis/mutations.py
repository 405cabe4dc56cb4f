"""Seeded order-dependent bugs: the explorer's sensitivity fixtures.

A race detector that silently stops detecting is worse than none, so
this module pins *mutants* — deliberately broken backends/listeners whose
bug only manifests under particular schedules — and tests assert the
explorer catches each with a minimized, replayable counterexample
(the race explorer's tests).  Each mutant is the realistic shape of a
bug the seam discipline exists to prevent:

* ``accum`` — chunk deliveries EXTEND a shared accumulator in completion
  order instead of writing their disjoint slots (the pipeline's contract
  violated).  Shares come back permuted under any non-FIFO resolution,
  the engine combines the wrong share for an index, and the epoch's
  decrypt-equality invariant trips — but ONLY on non-default schedules.
* ``counter`` — the submit path of the next batch reads state the
  previous batch's delivery callbacks wrote (which chunk resolved LAST)
  — the adaptive-RLC shape with the observation window read at the
  wrong time.  Verdicts stay correct; the schedule leaks into a
  fingerprinted probe counter.  This is also the source shape the
  static ``seam-race`` rule catches (the lint tests run the rule
  over this very module).
* ``listener`` — a chunk-resolution listener submits transactions into
  the live mempools MID-EPOCH, so the next epoch's contribution
  sampling depends on the resolution order (the traffic-hook seam
  violated).  Batches themselves diverge.
* ``shard`` — decrypt chunks ride the PER-DEVICE pipeline but
  scatter their results through a cursor advanced in RESOLUTION order
  instead of writing at their submission offsets.  Per-device queues
  are FIFO, so the bug is invisible until chunks on DIFFERENT devices
  resolve out of submission order — exactly the freedom the shard
  explorer target schedules over.  The cursor is also the minimal
  submit-write/resolve-read crossing the static ``seam-race`` rule
  flags (the lint tests map this module into the rule's scope).

These classes are exercised only by the explorer and the lint tests —
nothing in the production paths imports them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

from hbbft_tpu_torch.crypto.backend import MockBackend
from hbbft_tpu_torch.analysis.schedules import ShardedMockBackend


class AccumulatingResolveBackend(MockBackend):
    """Seeded bug 1: delivery extends a shared list in resolution order.

    ``decrypt_shares_batch`` rides the chunk pipeline with an
    ``out.extend`` delivery — correct only when chunks resolve FIFO.
    """

    def decrypt_shares_batch(self, items):
        out: List[Any] = []
        step = self.pipeline_chunk or len(items) or 1
        b = self._batch_seq
        self._batch_seq += 1
        for ci, lo in enumerate(range(0, len(items), step)):
            chunk = items[lo : lo + step]
            self._pipe.submit(
                lambda chunk=chunk: [
                    sk.decrypt_share_unchecked(ct) for sk, ct in chunk
                ],
                fetch=None,
                kind=f"b{b}.c{ci}",
                items=len(chunk),
                on_result=out.extend,  # BUG: completion order, not slots
            )
        self._pipe.flush(order=self._resolution_order())
        return out


class SubmitReadsResolveBackend(MockBackend):
    """Seeded bug 2: a submit-path read of resolve-path state.

    Delivery callbacks record which chunk resolved last; the NEXT
    batch's submit path folds that into a probe counter — so the probe's
    final value encodes the chosen resolution permutations.  The
    verdicts stay correct (slot writes are untouched); the fingerprint's
    ``extra`` channel exposes the leak, exactly like a group-sizing or
    batching decision would leak into dispatch structure.
    """

    def __init__(self) -> None:
        super().__init__()
        self._last_resolved_lo = 0  # resolve-path state
        self._probe_acc = 0

    def _piped_submit(self, items: Sequence, compute: Callable[[Sequence], List]):
        # BUG (seam-race shape): submit path reads _last_resolved_lo,
        # which the previous batch's delivery callbacks wrote
        self._probe_acc = (self._probe_acc * 31 + self._last_resolved_lo) & (
            (1 << 30) - 1
        )
        out, finish = super()._piped_submit(items, compute)
        return out, finish

    # record resolve-order state from the delivery side
    @property
    def chunk_listeners(self):  # type: ignore[override]
        def deliver(lo, res):
            # BUG (seam-race shape): resolve-path write of state the
            # submit path above reads
            self._last_resolved_lo = lo

        return (deliver,) + tuple(self.__dict__.get("_extra_listeners", ()))

    @chunk_listeners.setter
    def chunk_listeners(self, value):
        self.__dict__["_extra_listeners"] = tuple(value)

    def race_extra(self) -> Dict[str, int]:
        return {"probe_acc": self._probe_acc}


class ShardOrderScatterBackend(ShardedMockBackend):
    """Seeded bug 4: result scatter keyed by resolution order.

    ``decrypt_shares_batch`` submits each chunk to its reserved device
    but delivers through a shared cursor that advances as chunks
    RESOLVE — so a chunk's results land at whatever offset the schedule
    put the cursor at, not at the chunk's submission offset.  Correct
    whenever cross-device resolution happens to equal submission order;
    any other interleaving permutes the shares and trips the epoch's
    decrypt-equality invariant.
    """

    def decrypt_shares_batch(self, items):
        out: List[Any] = [None] * len(items)
        step = self.pipeline_chunk or len(items) or 1
        b = self._batch_seq
        self._batch_seq += 1
        # BUG (seam-race shape): submit-path write of the cursor the
        # resolve-path deliveries below read and advance
        self._scatter_cursor = 0
        for ci, lo in enumerate(range(0, len(items), step)):
            chunk = items[lo : lo + step]

            def deliver(res):
                # BUG: scatter keyed by resolution order, not by the
                # chunk's submission offset
                out[self._scatter_cursor : self._scatter_cursor + len(res)] = res
                self._scatter_cursor += len(res)

            self._pipe.reserve_device()
            self._pipe.submit(
                lambda chunk=chunk: [
                    sk.decrypt_share_unchecked(ct) for sk, ct in chunk
                ],
                fetch=None,
                kind=f"b{b}.c{ci}",
                items=len(chunk),
                on_result=deliver,
            )
        self._pipe.flush()
        return out


def mid_epoch_mempool_listener(driver) -> Callable:
    """Seeded bug 3: a listener mutating mempool state mid-epoch.

    On every chunk resolution it pushes a transaction tagged with the
    chunk's offset into the driver's mempools — so mempool insertion
    order (and therefore the next epoch's sampled contributions) depends
    on the resolution schedule."""
    seq = [0]

    def on_chunk(lo, res):
        seq[0] += 1
        # well-formed canonical tx so admission ACCEPTS it — the bug is
        # the timing, not the shape (client id encodes the chunk offset)
        tx = ("tx", 1_000_000 + lo, seq[0], b"inflight")
        for mp in driver.mempools:
            mp.submit(tx)  # BUG: admission outside the epoch boundary

    return on_chunk


def target_runner(name: str):
    """Explorer runners for the seeded mutants (analysis/schedules.py
    ``target_runner("mutant:<name>")``)."""
    from hbbft_tpu_torch.analysis import schedules

    if name == "accum":

        def run_accum(controller, tracker, n, seed):
            return schedules.run_pipeline_target(
                controller, tracker, n, seed,
                backend_factory=AccumulatingResolveBackend,
            )

        return run_accum
    if name == "counter":

        def run_counter(controller, tracker, n, seed):
            return schedules.run_pipeline_target(
                controller, tracker, n, seed,
                backend_factory=SubmitReadsResolveBackend,
            )

        return run_counter
    if name == "listener":

        def run_listener(controller, tracker, n, seed):
            return schedules.run_traffic_target(
                controller, tracker, n, seed,
                chunk_listener_factory=mid_epoch_mempool_listener,
            )

        return run_listener
    if name == "shard":

        def run_shard(controller, tracker, n, seed):
            return schedules.run_shard_target(
                controller, tracker, n, seed,
                backend_factory=ShardOrderScatterBackend,
            )

        return run_shard
    raise KeyError(f"unknown mutant {name!r}")


MUTANT_NAMES = ("accum", "counter", "listener", "shard")


# ---------------------------------------------------------------------------
# Snapshot/WAL-replay mutants
# ---------------------------------------------------------------------------
#
# The same sensitivity doctrine for the snapshot rule family
# (analysis/rules_snapshot.py): three deliberately broken state classes,
# each the minimal shape of a durability bug the rules exist to catch.
# the lint tests lint this module's source *as if it lived at a
# ``_STATE_MODULES`` path* (hbbft_tpu_torch/net/crash.py) and pins one finding
# per mutant.  Nothing imports these classes at runtime.


class UndeclaredCallableStateNode:
    """Snapshot mutant ``coverage``: a runtime write stores a callable in
    an attribute that is not declared in ``_SNAPSHOT_ENV_ATTRS`` — the
    first ``save_node`` after this write dies with ``SnapshotError:
    callable in state``.  (``tracer`` is declared, ``_notify`` is the
    drift.)"""

    tracer = None
    _SNAPSHOT_ENV_ATTRS = ("tracer",)

    def __init__(self) -> None:
        self.seen = 0

    def on_deliver(self, sender: Any, payload: Any) -> None:
        self.seen += 1
        self._notify = lambda: payload  # BUG: callable state, undeclared


class ReplayHookNode:
    """Snapshot mutant ``replay-hook``: the WAL replay loop invokes a
    checkpoint-detached hook.  On a restored node ``batch_listeners`` is
    the class default ``()`` while the pre-crash instance had live
    listeners — replay diverges (or silently skips effects) depending on
    environment attachment."""

    batch_listeners = ()
    _SNAPSHOT_ENV_ATTRS = ("batch_listeners",)

    def __init__(self) -> None:
        self.log: List[Any] = []

    def _replay(self, wal: Sequence[Any]) -> None:
        for entry in wal:
            self._apply(entry)

    def _apply(self, entry: Any) -> None:
        self.log.append(entry)
        for cb in self.batch_listeners:
            cb(entry)  # BUG: detached hook steered by WAL replay


class ReplayEnvReadNode:
    """Snapshot mutant ``replay-read``: the replay path reads a
    checkpoint-detached env attr without a guard.  The live instance
    carries a metrics sink; the restored instance replays with the class
    default ``None`` — ``AttributeError`` at best, divergent state at
    worst."""

    metrics_log = None
    _SNAPSHOT_ENV_ATTRS = ("metrics_log",)

    def __init__(self) -> None:
        self.rows: List[Any] = []

    def _restart(self, wal: Sequence[Any]) -> None:
        for entry in wal:
            # BUG: unguarded env read on the replay path
            self.rows.append((entry, self.metrics_log))


SNAPSHOT_MUTANT_NAMES = ("coverage", "replay-hook", "replay-read")
