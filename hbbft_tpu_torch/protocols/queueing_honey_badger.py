"""QueueingHoneyBadger — transaction buffering in front of DynamicHoneyBadger.

Rebuild of `src/queueing_honey_badger/mod.rs` § (SURVEY.md §2.1): an
unbounded `TransactionQueue` feeds random samples of ``batch_size``
transactions into DHB epochs; committed transactions are removed, and a new
proposal is made automatically as soon as the previous epoch's batch lands
(also immediately after era changes, when the fresh HoneyBadger starts).

Messages pass through unchanged (`DhbMessage`): QHB adds no wire traffic of
its own.
"""

from __future__ import annotations

from typing import Any, List, Optional

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.core.protocol import ConsensusProtocol
from hbbft_tpu_torch.core.types import Step, absorb_child_step
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.protocols.change import Change
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch, DynamicHoneyBadger
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
from hbbft_tpu_torch.protocols.transaction_queue import RemovalAccount, TransactionQueue


class QueueingHoneyBadgerBuilder:
    """Builder mirroring the reference `QueueingHoneyBadgerBuilder` §."""

    def __init__(self, netinfo: NetworkInfo, backend: CryptoBackend, rng) -> None:
        self.netinfo = netinfo
        self.backend = backend
        self.rng = rng
        self._batch_size = 100
        self._session_id = b"qhb"
        self._encryption_schedule = EncryptionSchedule.always()
        self._queue: Optional[TransactionQueue] = None

    def batch_size(self, n: int) -> "QueueingHoneyBadgerBuilder":
        self._batch_size = n
        return self

    def session_id(self, sid: bytes) -> "QueueingHoneyBadgerBuilder":
        self._session_id = sid
        return self

    def encryption_schedule(self, s: EncryptionSchedule) -> "QueueingHoneyBadgerBuilder":
        self._encryption_schedule = s
        return self

    def queue(self, q: TransactionQueue) -> "QueueingHoneyBadgerBuilder":
        self._queue = q
        return self

    def build(self) -> "QueueingHoneyBadger":
        return QueueingHoneyBadger(
            self.netinfo,
            self.backend,
            rng=self.rng,
            batch_size=self._batch_size,
            session_id=self._session_id,
            encryption_schedule=self._encryption_schedule,
            queue=self._queue,
        )


class QueueingHoneyBadger(ConsensusProtocol):
    """The port's copy of the JAX package's QueueingHoneyBadger, with its
    two environment hooks and the control plane's ``("batch_size", B)``
    input."""

    #: optional observer called with each freshly-sampled proposal: the
    #: traffic subsystem's queue-dwell probe (ObjectTrafficDriver closes
    #: the submit→sampled interval here; the array engine has an
    #: equivalent hook in its contribution source).  Environment, not
    #: state: snapshots drop it (a live bound method would otherwise make
    #: every traffic-driven node unsnapshotable) and restore falls back to
    #: the class None.
    sample_listener = None
    #: optional zero-arg -> int supplying the live batch size B (the
    #: control plane's adaptive-batch hook; checkpoint-detached like
    #: sample_listener).  When None, proposals sample ``batch_size``,
    #: which is STATE and can also be steered by ("batch_size", B) inputs;
    #: under the crash axis (net/crash.py) input-borne updates are the
    #: correct channel, because inputs are WAL-logged and replay
    #: bit-identically while a provider would answer replayed proposals
    #: with the current B (see ObjectTrafficDriver).
    batch_size_provider = None
    _SNAPSHOT_ENV_ATTRS = ("sample_listener", "batch_size_provider")

    def __init__(
        self,
        netinfo: NetworkInfo,
        backend: CryptoBackend,
        rng,
        batch_size: int = 100,
        session_id: bytes = b"qhb",
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        queue: Optional[TransactionQueue] = None,
    ) -> None:
        self.backend = backend
        self.rng = rng
        self.batch_size = batch_size
        self.queue = queue if queue is not None else TransactionQueue()
        #: cumulative committed-batch removal accounting: ``removed`` txs
        #: were in our queue, ``absent`` committed from other proposers'
        #: samples without ever being submitted here (the traffic
        #: tracker's committed-elsewhere signal)
        self.removal_account = RemovalAccount()
        self.dhb = DynamicHoneyBadger(
            netinfo,
            backend,
            rng=rng,
            session_id=session_id,
            encryption_schedule=encryption_schedule,
        )

    @staticmethod
    def builder(netinfo, backend, rng) -> QueueingHoneyBadgerBuilder:
        return QueueingHoneyBadgerBuilder(netinfo, backend, rng)

    @property
    def netinfo(self) -> NetworkInfo:
        return self.dhb.netinfo

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self):
        return self.dhb.our_id()

    def terminated(self) -> bool:
        return False

    def handle_input(self, input: Any, rng=None) -> Step:
        """("user", tx) pushes a transaction; ("change", Change) votes;
        ("batch_size", B) re-sizes future proposals (the control plane's
        input-borne channel: a plain state write, so it is snapshotted and
        WAL-replayed like any other input; deliberately does NOT trigger a
        proposal)."""
        kind, payload = input
        if kind == "user":
            return self.push_transaction(payload)
        if kind == "change":
            return self.vote_for(payload)
        if kind == "batch_size":
            self.batch_size = int(payload)
            return Step()
        raise ValueError(f"unknown input kind {kind!r}")

    def push_transaction(self, tx: Any) -> Step:
        self.queue.push(tx)
        return self._try_propose()

    def vote_for(self, change: Change) -> Step:
        step = self._wrap(self.dhb.vote_for(change))
        return step.extend(self._try_propose())

    def vote_to_add(self, node_id, pub_key) -> Step:
        step = self._wrap(self.dhb.vote_to_add(node_id, pub_key))
        return step.extend(self._try_propose())

    def vote_to_remove(self, node_id) -> Step:
        step = self._wrap(self.dhb.vote_to_remove(node_id))
        return step.extend(self._try_propose())

    def handle_message(self, sender_id: Any, message: Any, rng=None) -> Step:
        step = self._wrap(self.dhb.handle_message(sender_id, message, rng))
        return step.extend(self._try_propose())

    # -- internals -----------------------------------------------------------

    def _wrap(self, dhb_step: Step) -> Step:
        return absorb_child_step(
            dhb_step,
            wrap_msg=lambda m: m,  # QHB adds no envelope
            on_output=self._on_batch,
        )

    def _on_batch(self, batch: DhbBatch) -> Step:
        # lint: allow[determinism] queue removals commute; order irrelevant
        for contributions in batch.contributions.values():
            if isinstance(contributions, list):
                acct = self.queue.remove_multiple(contributions)
                self.removal_account = acct.merged(self.removal_account)
        step = Step.from_output(batch)
        return step.extend(self._try_propose())

    def _try_propose(self) -> Step:
        """Propose a fresh random sample if no proposal is in flight."""
        if not self.dhb.netinfo.is_validator() or self.dhb.hb.has_input:
            return Step()
        b = (
            self.batch_size
            if self.batch_size_provider is None
            # lint: allow[replay-purity] detached during replay by
            # construction: restore drops the provider and the restart
            # listener reattaches it only after the WAL loop finishes, so
            # replayed proposals fall back to the logged ("batch_size", B)
            # input channel — the replay-safe path for B
            else int(self.batch_size_provider())
        )
        sample = self.queue.choose(self.rng, b)
        if self.sample_listener is not None:
            # lint: allow[replay-purity] observer-only: the listener sees the
            # sample and its return value is ignored; a restored node replays
            # unsampled (the listener falls back to None) and the driver
            # reattaches it after the replay through the crash manager's
            # restart listeners
            self.sample_listener(sample)
        return self._wrap(self.dhb.propose(sample, self.rng))
