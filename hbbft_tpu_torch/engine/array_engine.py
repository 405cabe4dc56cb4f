"""ArrayHoneyBadgerNet — the whole network as data (lockstep array engine),
the port's copy of the JAX package's ``engine/array_engine.py``.

Run all N nodes in **lockstep rounds** — every message sent in round r is
delivered in round r+1 (a zero-latency full-mesh network) — and execute
each round as a handful of *batched* operations over the whole network
instead of per-message dispatch:

* merkle proof checks:   one batched hash call per round (N³ items, native C)
* pairing verifications: one batched backend call per round (N³ items)
* RS encode/decode:      per-instance GF(2⁸) matmul (native C)
* threshold counting:    plain arithmetic (symmetric under lockstep)

**Workload fidelity.** Per-receiver work is NOT deduplicated: every
(receiver, sender) pair contributes its own hash validation and its own
share-verification item, exactly as N independent nodes would perform.
Message counts are tallied from the same Target expansion rules the
object runtime applies.

**Protocol equivalence.** Under the lockstep schedule with honest nodes
every threshold (N−f Echo, f+1/2f+1 BVal, 2f+1 Ready, N−f Aux/Conf)
crosses for all receivers in the same round, every RBC decodes in the
same round, and every BA instance decides ``true`` in its first round on
the fixed coin.  The engine executes exactly those transitions, checking
the thresholds it relies on with explicit raises, and produces the same
``Batch`` values as the JAX package's engine (tests/test_torch_engine.py
holds the two against each other).

**Host-side execution.** Epoch host time is itemized into the
``host_bucket_*`` counters (obs/hostbuckets.py regions: encode, rs_merkle,
assemble, scatter, staging, dispatch, other).  Verification overlaps the
NEXT round's assembly through the backend's deferred entry points
(``verify_*_deferred``): combines are dispatched speculatively while the
share checks execute, and a failed check still raises before any Batch is
emitted.  ``HBBFT_TPU_NO_HOSTPIPE=1`` restores the per-item loops and
strictly ordered verification — Batches are bit-identical and
``device_dispatches`` unchanged either way.

Carried by this slice of the port: ``run_epoch``/``run_epochs`` with the
engine's defaults (``coin_rounds=0``, ``dynamic=False``).  Real coin rounds
(slice 3: the signature/coin side), the DynamicHoneyBadger envelope, era
change and checkpoint/restore (slice 4: the DKG) raise
``NotImplementedError``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.erasure import rs_codec
from hbbft_tpu_torch.crypto.merkle import MerkleTree, PackedProofs, _depth, validate_proofs
from hbbft_tpu_torch.engine.dkg_batch import batched_encrypt
from hbbft_tpu_torch.ops.pipeline import hostpipe_enabled
from hbbft_tpu_torch.protocols.honey_badger import Batch
from hbbft_tpu_torch.utils import canonical
from hbbft_tpu_torch.utils.metrics import Counters


class EngineInvariantError(RuntimeError):
    """A lockstep invariant the engine relies on failed (honest-path
    precondition violated, or a Byzantine input slipped into a
    simulation run).  Raised explicitly — these checks used to be
    ``assert`` statements, which silently vanish under ``python -O`` and
    would turn the Byzantine-detection paths into no-ops."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise EngineInvariantError(msg)


@dataclass
class EpochReport:
    """Work accounting for one lockstep epoch (all-network totals)."""

    epoch: int
    rounds: int = 0
    messages_delivered: int = 0
    proofs_validated: int = 0
    hashes: int = 0
    ciphertexts_verified: int = 0
    dec_shares_verified: int = 0
    combines: int = 0
    rs_encodes: int = 0
    rs_reconstructs: int = 0
    coin_rounds: int = 0
    coin_signs: int = 0
    sig_shares_verified: int = 0
    sig_combines: int = 0
    votes_verified: int = 0
    kg_parts_handled: int = 0
    kg_acks_handled: int = 0
    # wall seconds per engine phase (rbc / coin / ba / decrypt)
    phase_seconds: Optional[Dict[str, float]] = None


class ArrayHoneyBadgerNet:
    """N-node HoneyBadger network executed in lockstep rounds.

    API shape::

        net = ArrayHoneyBadgerNet(range(100), backend=TorchBackend(), seed=7)
        batches = net.run_epoch({i: contrib_bytes(i) for i in net.ids})
        # batches[node_id] — identical Batch for every node

    ``backend`` defaults to ``TorchBackend()`` on the card; pass
    ``TorchBackend(device="cpu")`` to run on the CPU.
    ``dedup_verifies=True`` collapses the N identical copies of each
    share-verification (each receiver checks the same share against the
    same public key) to one representative — a *memoizing simulation*
    mode; the default keeps the full per-receiver workload so measured
    epochs/sec reflect N independent nodes.
    """

    def __init__(
        self,
        node_ids: Sequence[Any],
        backend: Optional[CryptoBackend] = None,
        seed: int = 0,
        dedup_verifies: bool = False,
        verify_chunk: int = 1 << 17,
        dynamic: bool = False,
        coin_rounds: int = 0,
    ) -> None:
        if coin_rounds:
            raise NotImplementedError(
                "coin_rounds > 0 needs the signature/coin side of the backend "
                "(port slice 3)"
            )
        if dynamic:
            raise NotImplementedError(
                "dynamic=True (the DynamicHoneyBadger envelope and its era "
                "machinery) comes with the DKG (port slice 4)"
            )
        if backend is None:
            from hbbft_tpu_torch.ops.backend import TorchBackend

            backend = TorchBackend()
        self.ids = sorted(node_ids)
        self.n = len(self.ids)
        self.f = (self.n - 1) // 3
        self.backend = backend
        self.rng = random.Random(seed)
        self.netinfos: Dict[Any, NetworkInfo] = NetworkInfo.generate_map(
            self.ids, self.rng, self.backend
        )
        self.dedup_verifies = dedup_verifies
        self.verify_chunk = verify_chunk
        self.epoch = 0
        self.counters = Counters()
        self.reports: List[EpochReport] = []
        any_info = self.netinfos[self.ids[0]]
        self.pk_set = any_info.public_key_set
        self.pk_master = self.pk_set.public_key()
        self.threshold = self.pk_set.threshold()
        # polynomial-commitment evaluations are per-era constants; the
        # round-8 loop would otherwise re-evaluate them N² times per epoch
        self.pk_shares = [
            self.pk_set.public_key_share(i) for i in range(self.n)
        ]
        self.codec = rs_codec(self.n - 2 * self.f, 2 * self.f)

    # -- helpers -------------------------------------------------------------

    def _count_msgs(self, rep: EpochReport, n_messages: int) -> None:
        rep.messages_delivered += n_messages
        self.counters.messages_delivered += n_messages

    def _verify_batch(self, kind: str, items: list) -> List[bool]:
        """Batched backend verification with chunking (device-batch sized)."""
        out: List[bool] = []
        fn = {
            "dec": self.backend.verify_dec_shares,
            "ct": self.backend.verify_ciphertexts,
        }[kind]
        for i in range(0, len(items), self.verify_chunk):
            out.extend(fn(items[i : i + self.verify_chunk]))
        return out

    def _verify_deferred(self, kind: str, items: list):
        """Deferred twin of :meth:`_verify_batch` — submits the chunks now
        (behind the backend's bounded in-flight queue) and returns a
        zero-arg resolver, so the NEXT round's item lists assemble while
        this round's checks execute on device (cross-round pipelining;
        kill switch ``HBBFT_TPU_NO_HOSTPIPE=1`` routes around it)."""
        fn = {
            "dec": self.backend.verify_dec_shares_deferred,
            "ct": self.backend.verify_ciphertexts_deferred,
        }[kind]
        resolvers = [
            fn(items[i : i + self.verify_chunk])
            for i in range(0, len(items), self.verify_chunk)
        ]

        def resolve() -> List[bool]:
            out: List[bool] = []
            for r in resolvers:
                out.extend(r())
            return out

        return resolve

    # -- the epoch -----------------------------------------------------------

    def run_epoch(self, contributions: Dict[Any, bytes]) -> Dict[Any, Batch]:
        """Execute one full HoneyBadger epoch; returns per-node Batches.

        ``contributions[node] -> bytes`` is each node's proposed payload
        (what QueueingHoneyBadger would sample from its transaction queue).
        """
        # host-bucket attribution (obs/hostbuckets.py): the epoch region
        # bills counters.host_seconds (wall minus device-fetch-blocked)
        # and every phase below bills its named exclusive slice
        with self.backend.buckets.epoch():
            return self._run_epoch(contributions)

    def _run_epoch(self, contributions: Dict[Any, bytes]) -> Dict[Any, Batch]:
        n, f = self.n, self.f
        rep = EpochReport(epoch=self.epoch)
        bk = self.backend.buckets
        fast = hostpipe_enabled()
        # phase wall clocks run unconditionally (~4 reads per epoch): the
        # per-phase splits feed EpochReport.phase_seconds, the lockstep
        # critical-path attribution input.
        clock = time.perf_counter
        phase_s: Dict[str, float] = {}
        t_phase = clock()

        # ------ round 0: encrypt + RS-encode + Merkle-commit + Value -------
        # honey_badger.py propose(): canonical-encode the contribution,
        # then threshold-encrypt.
        with bk.region("encode"):
            inners: List[Any] = [bytes(contributions[nid]) for nid in self.ids]
            msgs = (
                canonical.encode_batch(inners)
                if fast
                else [canonical.encode(x) for x in inners]
            )
        # all N threshold-encryptions through the backend's batched
        # ladders (same math as pk_master.encrypt per node)
        master_el = self.pk_master.el
        with bk.region("dispatch"):
            ct_list = batched_encrypt(
                self.backend, [master_el] * n, msgs, self.rng, kind="encrypt"
            )
        for ct in ct_list:
            # receivers must pay their own hash-to-G2 in rounds 7-8
            # (the encryptor-side cache would make them free cache hits)
            if hasattr(ct, "_hash_point"):
                del ct._hash_point
        cts: Dict[Any, Any] = dict(zip(self.ids, ct_list))
        with bk.region("encode"):
            ct_bytes = {nid: cts[nid].to_bytes() for nid in self.ids}

        # broadcast.py broadcast(): frame, shard, commit.
        trees: Dict[Any, MerkleTree] = {}
        shards: Dict[Any, List[bytes]] = {}
        with bk.region("rs_merkle"):
            framed_list = [
                len(ct_bytes[nid]).to_bytes(4, "big") + ct_bytes[nid]
                for nid in self.ids
            ]
            if fast:
                # erasure/hash plane behind the backend seam: the port's
                # backend runs the per-item host loops (native C kernels)
                # behind the batch entry points
                sh_lists = self.backend.rs_encode_batch(self.codec, framed_list)
                tree_list = self.backend.merkle_build_batch(sh_lists)
                for nid, sh, t in zip(self.ids, sh_lists, tree_list):
                    shards[nid] = sh
                    trees[nid] = t
                    rep.rs_encodes += 1
            else:
                for nid, framed in zip(self.ids, framed_list):
                    sh = self.codec.encode(framed)
                    shards[nid] = sh
                    trees[nid] = MerkleTree(sh)
                    rep.rs_encodes += 1
        tree_size = 1 << _depth(n)  # trees pad to a power of two
        rep.hashes += n * (2 * tree_size - 1)
        self._count_msgs(rep, n * (n - 1))  # Value: point-to-point
        rep.rounds += 1

        # The N² distinct (instance, shard-index) proofs; each is validated
        # many times across receivers/phases — the repetition count is
        # passed down so the batched hasher repeats the WORK without
        # materializing millions of identical Python objects.  Fast path:
        # the proofs never exist as objects at all — array slices of the
        # tree levels feed the C kernel directly (PackedProofs).
        proofs: Optional[List] = None
        packed: Optional[PackedProofs] = None
        with bk.region("rs_merkle"):
            if fast:
                packed = PackedProofs.from_trees([trees[p] for p in self.ids], n)
            if packed is None:
                proofs = [trees[p].proof(s) for p in self.ids for s in range(n)]
        n_proofs = n * n

        def _validate_all(reps: int) -> List[bool]:
            if packed is not None:
                return self.backend.merkle_verify_batch(packed, reps=reps)
            return validate_proofs(proofs, n, reps=reps)

        # ------ round 1: validate own Value proof, send Echo ---------------
        # broadcast.py _handle_value → _validate_proof(own index): each
        # receiver checks the one proof addressed to it (N² total).
        with bk.region("rs_merkle"):
            ok = _validate_all(1)
        _require(all(ok), "array engine: proposer produced an invalid proof")
        rep.proofs_validated += n_proofs
        rep.hashes += n_proofs * (_depth(n) + 1)
        self._count_msgs(rep, n * n * (n - 1))  # Echo: Target.all per node
        rep.rounds += 1

        # ------ round 2: validate N echoes each, N−f quorum → Ready --------
        # broadcast.py _handle_echo: every receiver checks every sender's
        # shard proof (the O(N³) hash hot loop, batched here: N² distinct
        # proofs × N receivers each).
        reps = 1 if self.dedup_verifies else n
        with bk.region("rs_merkle"):
            ok = _validate_all(reps)
        _require(all(ok), "array engine: honest echo failed validation")
        rep.proofs_validated += n_proofs * reps
        rep.hashes += n_proofs * reps * (_depth(n) + 1)
        # Echo count n ≥ N−f for every (instance, receiver): send Ready.
        _require(n >= n - f, "array engine: Echo quorum short")
        self._count_msgs(rep, n * n * (n - 1))  # Ready: Target.all
        rep.rounds += 1

        # ------ round 3: Ready quorum (2f+1) → reconstruct + re-commit -----
        # broadcast.py _try_decode: all N shards present at every receiver;
        # reconstruct and re-verify the Merkle commitment.
        values: Dict[Any, bytes] = {}
        reps = 1 if self.dedup_verifies else n
        full_shards: Dict[Any, List[bytes]] = {}
        with bk.region("rs_merkle"):
            if fast:
                # every receiver performs this identical all-present
                # reconstruction — ONE batched pass through the backend
                # plane (the all-present case is zero GF math on every
                # backend), replicated in ACCOUNTING only
                full_list = self.backend.rs_reconstruct_batch(
                    self.codec, [list(shards[p]) for p in self.ids]
                )
            else:
                full_list = []
                for p in self.ids:
                    for _ in range(reps):
                        full = self.codec.reconstruct(list(shards[p]))
                    full_list.append(full)
            for p, full in zip(self.ids, full_list):
                full_shards[p] = full
                framed = b"".join(full[: self.codec.k])
                length = int.from_bytes(framed[:4], "big")
                values[p] = framed[4 : 4 + length]
                rep.rs_reconstructs += reps
                rep.hashes += reps * (2 * tree_size - 1)
            # ... and the Merkle re-commit of the reconstructed shard
            # vector, batched across instances through the C hash kernel.
            roots = _roots_batch(
                [full_shards[p] for p in self.ids], reps
            )
        for p, root in zip(self.ids, roots):
            _require(
                root == trees[p].root_hash,
                "array engine: reconstructed root mismatch",
            )
        for p in self.ids:
            _require(values[p] == ct_bytes[p], "RBC value mismatch")
        t_now = clock()
        phase_s["rbc"] = t_now - t_phase
        t_phase = t_now
        # subset.py _on_broadcast_output: input true to BA_p. BA round 0:
        # sbv_broadcast.py send_bval → BVal(true) to all.
        self._count_msgs(rep, n * n * (n - 1))  # BVal
        rep.rounds += 1

        # ------ round 4: BVal threshold (2f+1) → bin_values, Aux -----------
        _require(n >= 2 * f + 1, "array engine: BVal threshold short")
        self._count_msgs(rep, n * n * (n - 1))  # Aux
        rep.rounds += 1

        # ------ round 5: Aux quorum (N−f) → SBV output {true}, Conf --------
        self._count_msgs(rep, n * n * (n - 1))  # Conf
        rep.rounds += 1

        # ------ round 6: Conf quorum → coin ---------------------------------
        # binary_agreement.py: with unanimous inputs conf_values = {true}
        # is definite and equals the round-0 fixed coin → decide(true)
        # immediately, no threshold-sign traffic (coin_rounds == 0).
        self._count_msgs(rep, n * n * (n - 1))  # Term
        rep.rounds += 1
        t_now = clock()
        phase_s["ba"] = t_now - t_phase
        t_phase = t_now

        # ------ round 7: ciphertext validation + decryption shares ---------
        # honey_badger.py: SubsetOutput::Contribution(p, ct) → spawn
        # ThresholdDecrypt(p); set_ciphertext defers a verify_ciphertext
        # item per (receiver, proposer).
        reps = 1 if self.dedup_verifies else n
        with bk.region("assemble"):
            ct_items = [cts[p] for p in self.ids for _ in range(reps)]
        ct_resolve = None
        if fast:
            # deferred: the ciphertext pairings execute behind the queue
            # while the decrypt-share round assembles below
            with bk.region("dispatch"):
                ct_resolve = self._verify_deferred("ct", ct_items)
        else:
            with bk.region("dispatch"):
                ok = self._verify_batch("ct", ct_items)
            _require(
                all(ok), "array engine: honest ciphertext failed validation"
            )
        rep.ciphertexts_verified += len(ct_items)
        # threshold_decrypt.py start_decryption: every node multicasts its
        # decryption share for every accepted proposer — all N² scalar
        # mults through the backend's batched ladder (one device dispatch
        # on TpuBackend).
        with bk.region("assemble"):
            sk_shares = [self.netinfos[s].secret_key_share for s in self.ids]
            gen_items = [(sk, cts[p]) for p in self.ids for sk in sk_shares]
        with bk.region("dispatch"):
            gen_out = self.backend.decrypt_shares_batch(gen_items)
        if ct_resolve is not None:
            # resolved AFTER the decrypt dispatches that overlapped it; a
            # bad ciphertext still raises before any Batch is emitted
            with bk.region("dispatch"):
                ok = ct_resolve()
            _require(
                all(ok), "array engine: honest ciphertext failed validation"
            )
        dec_shares: Optional[Dict[Any, Dict[int, Any]]] = None
        if not fast:
            # legacy scatter: flat ladder output → per-(proposer, sender)
            # dicts via a pos cursor.  The fast path never materializes
            # them — round 8 indexes gen_out[p_idx*n + s_idx] directly.
            with bk.region("scatter"):
                dec_shares = {}
                pos = 0
                for p in self.ids:
                    per_sender: Dict[int, Any] = {}
                    for s_idx in range(n):
                        per_sender[s_idx] = gen_out[pos]
                        pos += 1
                    dec_shares[p] = per_sender
        self._count_msgs(rep, n * n * (n - 1))  # dec shares: Target.all
        rep.rounds += 1

        # ------ round 8: verify all shares, combine, emit batches ----------
        # threshold_decrypt.py handle_message: every receiver verifies every
        # other sender's share (own share is trusted) — the O(N³) pairing
        # hot loop, one batched backend dispatch.
        reps = 1 if self.dedup_verifies else n - 1
        with bk.region("assemble"):
            if fast:
                distinct = [
                    (self.pk_shares[s_idx], cts[p], gen_out[p_idx * n + s_idx])
                    for p_idx, p in enumerate(self.ids)
                    for s_idx in range(n)
                ]
                items = [it for it in distinct for _ in range(reps)]
            else:
                items = []
                for p in self.ids:
                    for s_idx in range(n):
                        pk_share = self.pk_shares[s_idx]
                        item = (pk_share, cts[p], dec_shares[p][s_idx])
                        items.extend([item] * reps)
        dec_resolve = None
        if fast:
            with bk.region("dispatch"):
                dec_resolve = self._verify_deferred("dec", items)
        else:
            with bk.region("dispatch"):
                ok = self._verify_batch("dec", items)
            _require(
                all(ok), "array engine: honest decryption share rejected"
            )
        rep.dec_shares_verified += len(items)

        # _try_combine: threshold+1 lowest-indexed verified shares.  Every
        # receiver combines independently — all N² combines go through the
        # backend's batched API (one device dispatch on TpuBackend).  Fast
        # path: combines are dispatched while the share verification above
        # is still in flight (speculative under the honest schedule — a
        # rejected share raises below, before batch emission).
        reps = 1 if self.dedup_verifies else n
        k = self.threshold + 1
        with bk.region("assemble"):
            combine_items = []
            for p_idx, p in enumerate(self.ids):
                if fast:
                    chosen = {
                        i: gen_out[p_idx * n + i] for i in range(k)
                    }
                else:
                    chosen = {i: dec_shares[p][i] for i in range(k)}
                combine_items.extend([(chosen, cts[p])] * reps)
        plains: List[bytes] = []
        with bk.region("dispatch"):
            for i in range(0, len(combine_items), self.verify_chunk):
                plains.extend(
                    self.backend.combine_dec_shares_batch(
                        self.pk_set, combine_items[i : i + self.verify_chunk]
                    )
                )
        rep.combines += len(combine_items)
        if dec_resolve is not None:
            with bk.region("dispatch"):
                ok = dec_resolve()
            _require(
                all(ok), "array engine: honest decryption share rejected"
            )
        plain: Dict[Any, bytes] = {}
        with bk.region("scatter"):
            for j, p in enumerate(self.ids):
                pt = plains[j * reps]
                _require(pt is not None, "array engine: combine failed")
                plain[p] = pt
        # honey_badger.py batch emission: canonical-decode each plaintext.
        decoded: Dict[Any, bytes] = {}
        with bk.region("encode"):
            plain_list = [plain[p] for p in self.ids]
            trees_out = (
                canonical.decode_batch(plain_list)
                if fast
                else [canonical.decode(b) for b in plain_list]
            )
            for p, tree in zip(self.ids, trees_out):
                _require(tree == bytes(contributions[p]), "decrypt mismatch")
                decoded[p] = tree
        rep.rounds += 1
        phase_s["decrypt"] = clock() - t_phase
        rep.phase_seconds = phase_s

        batch = Batch(epoch=self.epoch, contributions=decoded)
        self.epoch += 1
        self.reports.append(rep)
        self.counters.cranks += rep.rounds
        return {nid: batch for nid in self.ids}

    def era_change(self) -> EpochReport:
        """Validator turnover (vote → DKG → new era): not in this slice."""
        raise NotImplementedError("era_change needs the batched DKG (port slice 4)")

    def checkpoint(self) -> bytes:
        """Whole-engine snapshot: not in this slice."""
        raise NotImplementedError(
            "checkpoint/restore come with the era machinery (port slice 4)"
        )

    @classmethod
    def restore(cls, data: bytes, backend: CryptoBackend) -> "ArrayHoneyBadgerNet":
        """Rebuild from :meth:`checkpoint` bytes: not in this slice."""
        raise NotImplementedError(
            "checkpoint/restore come with the era machinery (port slice 4)"
        )

    def run_epochs(self, k: int, payload_size: int = 128) -> List[Dict[Any, Batch]]:
        """Run k epochs with synthetic per-node contributions."""
        out = []
        for _ in range(k):
            contribs = {
                nid: self.rng.getrandbits(8 * payload_size).to_bytes(payload_size, "big")
                for nid in self.ids
            }
            out.append(self.run_epoch(contribs))
        return out


def _roots_batch(shard_lists: List[List[bytes]], reps: int) -> List[bytes]:
    """Merkle roots of many shard vectors, built ``reps`` times each —
    C batch kernel when available, python MerkleTree otherwise."""
    import numpy as np

    from hbbft_tpu_torch import native

    n_leaves = len(shard_lists[0])
    leaf_len = len(shard_lists[0][0])
    uniform = all(
        len(sl) == n_leaves and all(len(s) == leaf_len for s in sl)
        for sl in shard_lists
    )
    size = 1 << _depth(n_leaves)
    if uniform and size <= 256 and leaf_len + 1 <= 4096:
        leaves = np.frombuffer(
            b"".join(b"".join(sl) for sl in shard_lists), dtype=np.uint8
        ).reshape(len(shard_lists), n_leaves, leaf_len)
        roots = native.merkle_root_batch(leaves, size, reps)
        if roots is not None:
            return [roots[i].tobytes() for i in range(len(shard_lists))]
    out = []
    for sl in shard_lists:
        for _ in range(reps):
            tree = MerkleTree(sl)
        out.append(tree.root_hash)
    return out
