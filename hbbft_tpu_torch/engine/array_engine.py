"""ArrayHoneyBadgerNet — the whole network as data (lockstep array engine),
the port's copy of the JAX package's ``engine/array_engine.py``.

Run all N nodes in **lockstep rounds** — every message sent in round r is
delivered in round r+1 (a zero-latency full-mesh network) — and execute
each round as a handful of *batched* operations over the whole network
instead of per-message dispatch:

* merkle proof checks:   one batched backend hash call per round (N³ items;
                         on ``TorchBackend`` the device proof walk)
* pairing verifications: one batched backend call per round (N³ items)
* RS encode/decode:      one batched backend GF(2⁸) product per epoch (on
                         ``TorchBackend`` the device bit product)
* threshold counting:    plain arithmetic (symmetric under lockstep)

**Workload fidelity.** Per-receiver work is NOT deduplicated: every
(receiver, sender) pair contributes its own hash validation and its own
share-verification item, exactly as N independent nodes would perform.
Message counts are tallied from the same Target expansion rules the
object runtime applies.

**Protocol equivalence.** Under the lockstep schedule with honest nodes
every threshold (N−f Echo, f+1/2f+1 BVal, 2f+1 Ready, N−f Aux/Conf)
crosses for all receivers in the same round, every RBC decodes in the
same round, and every BA instance decides ``true`` on the fixed coin
(in its first round, or after ``coin_rounds`` real threshold-sign coin
rounds: the split-input schedule).  The engine executes exactly those
transitions, checking the thresholds it relies on with explicit raises,
and produces the same
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

**Era machinery.** ``dynamic=True`` wraps each contribution in
DynamicHoneyBadger's internal envelope; ``era_change()`` runs validator
turnover (signed votes → the batched DKG of engine/dkg_batch.py → new
keys, ``era += 1``), and ``run_epochs(k, churn_at=[...])`` fires one
before each listed epoch.  ``checkpoint()``/``restore()`` snapshot the
whole engine through utils/snapshot.py (the backend is re-attached).
The reference's per-node SyncKeyGen arm (``HBBFT_TPU_DKG`` other than
``batched``) raises ``NotImplementedError``: protocols/sync_key_gen.py
is not ported.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from hbbft_tpu_torch.core.network_info import NetworkInfo
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.erasure import rs_codec
from hbbft_tpu_torch.crypto.merkle import MerkleTree, PackedProofs, _depth, validate_proofs
from hbbft_tpu_torch.engine.dkg_batch import batched_encrypt, batched_era_dkg
from hbbft_tpu_torch.ops.pipeline import device_rs_enabled, hostpipe_enabled
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
        #: DynamicHoneyBadger flavor: contributions are wrapped in DHB's
        #: internal ("icontrib", user, votes, keygen) envelope.  With no
        #: membership churn inside the epoch the vote/key-gen lists are
        #: empty, so the per-batch signature verification of the DHB layer
        #: has zero items (era changes run between epochs: era_change)
        self.dynamic = dynamic
        #: real coin rounds per epoch: with coin_rounds=R every BA
        #: instance runs R rounds whose conf_values stay {true, false}
        #: (split inputs) and each invokes the threshold-sign coin: every
        #: node signs the round nonce, broadcasts its share, verifies every
        #: peer's share and Lagrange-combines f+1, before the definite
        #: round decides
        self.coin_rounds = coin_rounds
        self.epoch = 0
        self.era = 0
        self.counters = Counters()
        self.reports: List[EpochReport] = []
        self.churn_reports: List[EpochReport] = []
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
            "sig": self.backend.verify_sig_shares,
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
            "sig": self.backend.verify_sig_shares_deferred,
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
        # honey_badger.py propose(): canonical-encode the contribution
        # (wrapped in DHB's internal envelope in dynamic mode), then
        # threshold-encrypt.
        with bk.region("encode"):
            inners: List[Any] = [
                ("icontrib", bytes(contributions[nid]), [], [])  # match DHB propose()
                if self.dynamic
                else bytes(contributions[nid])
                for nid in self.ids
            ]
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
                # erasure/hash plane behind the backend seam: on
                # TorchBackend the N encodes collapse into one batched
                # GF(2⁸) bit product and the N tree builds into one
                # batched device SHA-256 dispatch; host backends run the
                # identical per-item loops behind the batch entry points
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
        # tree levels feed the backend's proof walk directly (PackedProofs:
        # the device kernel on TorchBackend, the C kernel on the host).
        proofs: Optional[List] = None
        packed: Optional[PackedProofs] = None
        with bk.region("rs_merkle"):
            if fast:
                # device=True lifts the native-SHA gate when the packed
                # batch is headed for the device proof walk instead of
                # the C kernel — the kill-switch arm keeps the host choice
                packed = PackedProofs.from_trees(
                    [trees[p] for p in self.ids], n,
                    device=self.backend.device_rs_plane and device_rs_enabled(),
                )
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
            # vector, batched across instances through the host C hash
            # kernel (on every backend, as in the JAX package's engine).
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
        # immediately, no threshold-sign traffic (coin_rounds == 0).  With
        # coin_rounds=R the engine executes R REAL coin rounds first (the
        # split-input schedule where conf_values stays {true, false}).
        t_coin = clock()
        for r in range(self.coin_rounds):
            self._coin_round(rep, round_no=r)
        if self.coin_rounds:
            phase_s["coin"] = clock() - t_coin
        self._count_msgs(rep, n * n * (n - 1))  # Term
        rep.rounds += 1
        t_now = clock()
        phase_s["ba"] = (t_now - t_phase) - phase_s.get("coin", 0.0)
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
        # honey_badger.py batch emission: canonical-decode each plaintext;
        # in dynamic mode also unwrap DHB's internal envelope (its per-batch
        # signature verification runs over the votes/key-gen lists, which
        # are empty within an epoch).
        decoded: Dict[Any, bytes] = {}
        with bk.region("encode"):
            plain_list = [plain[p] for p in self.ids]
            trees_out = (
                canonical.decode_batch(plain_list)
                if fast
                else [canonical.decode(b) for b in plain_list]
            )
            for p, tree in zip(self.ids, trees_out):
                if self.dynamic:
                    tag, user, votes, kg = tree
                    _require(
                        tag == "icontrib" and votes == [] and kg == [],
                        "array engine: DHB envelope mismatch",
                    )
                    tree = user
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

    def _coin_round(self, rep: EpochReport, round_no: int) -> None:
        """One real common-coin round across all N BA instances
        (threshold_sign.py sign → verify → combine → parity, batched
        network-wide).

        Per BA round the full SBV exchange repeats (BVal, Aux, Conf) and
        then every node broadcasts its coin share — 4×N²(N−1) messages.
        Crypto, batched through the backend seam:

        * sign:    N shares per instance (one x_s·H2(doc_p) G2 ladder each)
        * verify:  every receiver checks every OTHER sender's share
                   (N·(N−1) per instance; dedup mode: one representative)
        * combine: every receiver Lagrange-combines f+1 verified shares
                   (N per instance; dedup: 1) and takes sig.parity()

        All receivers must derive the SAME bit — checked per instance.
        Fast path (``hostpipe_enabled``): flat index arithmetic replaces
        the per-instance share dicts, and the combine assembly overlaps
        the deferred share verification.
        """
        bk = self.backend.buckets
        fast = hostpipe_enabled()
        n = self.n
        with bk.region("encode"):
            docs = [
                canonical.encode(("coin", self.epoch, p_idx, round_no))
                for p_idx in range(n)
            ]
        # SBV re-exchange for this BA round, then the share broadcast.
        self._count_msgs(rep, 4 * n * n * (n - 1))  # BVal, Aux, Conf, share
        with bk.region("assemble"):
            sk_shares = [self.netinfos[s].secret_key_share for s in self.ids]
            sign_items = [(sk, docs[p_idx]) for p_idx in range(n) for sk in sk_shares]
        with bk.region("dispatch"):
            shares_flat = self.backend.sign_shares_batch(sign_items)
        rep.coin_signs += len(sign_items)
        shares: Optional[List[Dict[int, Any]]] = None
        if not fast:
            with bk.region("scatter"):
                shares = []
                pos = 0
                for p_idx in range(n):
                    shares.append({s_idx: shares_flat[pos + s_idx] for s_idx in range(n)})
                    pos += n
        # per-receiver share verification (own share trusted).
        reps = 1 if self.dedup_verifies else n - 1
        with bk.region("assemble"):
            if fast:
                distinct = [
                    (self.pk_shares[s_idx], docs[p_idx], shares_flat[p_idx * n + s_idx])
                    for p_idx in range(n)
                    for s_idx in range(n)
                ]
                items = [it for it in distinct for _ in range(reps)]
            else:
                items = []
                for p_idx in range(n):
                    for s_idx in range(n):
                        item = (self.pk_shares[s_idx], docs[p_idx], shares[p_idx][s_idx])
                        items.extend([item] * reps)
        sig_resolve = None
        if fast:
            with bk.region("dispatch"):
                sig_resolve = self._verify_deferred("sig", items)
        else:
            with bk.region("dispatch"):
                ok = self._verify_batch("sig", items)
            _require(all(ok), "array engine: honest coin share rejected")
        rep.sig_shares_verified += len(items)
        # per-receiver combine: receiver i uses the f+1 verified shares
        # with the lowest indices starting at its own (subsets differ by
        # receiver; the combined signature must not).
        k = self.threshold + 1
        with bk.region("assemble"):
            combine_items = []
            per_instance_slots: List[List[int]] = []
            for p_idx in range(n):
                slots = []
                for recv in range(1 if self.dedup_verifies else n):
                    if fast:
                        chosen = {
                            (recv + j) % n: shares_flat[p_idx * n + (recv + j) % n]
                            for j in range(k)
                        }
                    else:
                        chosen = {(recv + j) % n: shares[p_idx][(recv + j) % n] for j in range(k)}
                    slots.append(len(combine_items))
                    combine_items.append((chosen, None))
                per_instance_slots.append(slots)
        sigs = []
        with bk.region("dispatch"):
            for i in range(0, len(combine_items), self.verify_chunk):
                sigs.extend(
                    self.backend.combine_sig_shares_batch(
                        self.pk_set, combine_items[i : i + self.verify_chunk]
                    )
                )
        rep.sig_combines += len(combine_items)
        if sig_resolve is not None:
            with bk.region("dispatch"):
                ok = sig_resolve()
            _require(all(ok), "array engine: honest coin share rejected")
        with bk.region("scatter"):
            for p_idx in range(n):
                bits = {sigs[slot].parity() for slot in per_instance_slots[p_idx]}
                _require(len(bits) == 1, "array engine: coin bit disagreement")
        rep.coin_rounds += 1
        rep.rounds += 1

    def era_change(self) -> EpochReport:
        """Mid-run validator turnover: vote → DKG → new era, executed
        lockstep between epochs.

        1. **Vote**: every node signs a Change vote with its per-node key;
           every receiver verifies every vote: one batched
           ``verify_signatures`` call (N·(N−1) checks; dedup: N).
        2. **DKG**: all N nodes run the key generation through
           engine/dkg_batch.py: every Part handled by every node (N² row
           decryptions and checks), every Ack by every node (N³ value
           checks).
        3. **Era turnover**: NetworkInfo is rebuilt with the new key
           shares, era += 1.  The NEXT run_epoch's decrypt-equality checks
           prove consensus still holds under the new keys.

        ``HBBFT_TPU_DKG`` (read per call) other than ``batched`` selects
        the reference's per-node SyncKeyGen arm, which raises here:
        protocols/sync_key_gen.py waits for a later port slice.

        Returns the work report (also appended to ``churn_reports``).
        """
        with self.backend.buckets.epoch():
            return self._era_change()

    def _era_change(self) -> EpochReport:
        dkg_mode = os.environ.get("HBBFT_TPU_DKG", "batched")
        if dkg_mode != "batched":
            raise NotImplementedError(
                f"HBBFT_TPU_DKG={dkg_mode} selects the per-node SyncKeyGen arm, "
                "which needs protocols/sync_key_gen.py: not ported yet (a later "
                "port slice; ROADMAP queue 1)"
            )
        n, f = self.n, self.f
        rep = EpochReport(epoch=self.epoch)
        bk = self.backend.buckets

        # 1) signed votes, batch-verified per receiver (ride inside one
        # epoch's contributions, so no extra message rounds).
        with bk.region("encode"):
            vote_doc = canonical.encode(("vote", self.era, "rotate-keys"))
        vote_sigs = {
            nid: self.netinfos[nid].secret_key.sign(vote_doc)
            for nid in self.ids
        }
        reps = 1 if self.dedup_verifies else n - 1
        pub_keys = self.netinfos[self.ids[0]].public_key_map()
        with bk.region("assemble"):
            vote_items = [
                (pub_keys[nid], vote_doc, vote_sigs[nid])
                for nid in self.ids
                for _ in range(reps)
            ]
        with bk.region("dispatch"):
            ok = self.backend.verify_signatures(vote_items)
        _require(all(ok), "array engine: honest vote rejected")
        rep.votes_verified += len(vote_items)

        # 2) the key generation among all N (lockstep Part then Ack
        # phases), device-batched ladders, batched pairing checks and
        # RLC-aggregated commitment checks.
        self._count_msgs(rep, n * (n - 1))  # Part: Target.All
        self._count_msgs(rep, n * n * (n - 1))  # Ack: Target.All
        with bk.region("dispatch"):
            first, shares, kstats = batched_era_dkg(
                self.backend,
                self.ids,
                {nid: self.netinfos[nid].secret_key.x for nid in self.ids},
                {nid: pub_keys[nid].el for nid in self.ids},
                f,
                self.rng,
            )
        rep.kg_parts_handled += kstats.parts_handled
        rep.kg_acks_handled += kstats.acks_handled
        rep.ciphertexts_verified += kstats.ciphertexts_verified
        rep.hashes += kstats.hashes_g2
        rep.rounds += 2

        # 3) era turnover: every node takes the one derived key set.
        secret_keys = {nid: self.netinfos[nid].secret_key for nid in self.ids}
        self.netinfos = {
            nid: NetworkInfo(
                our_id=nid,
                secret_key_share=shares[nid],
                public_key_set=first,
                secret_key=secret_keys[nid],
                public_keys=pub_keys,
            )
            for nid in self.ids
        }
        self.pk_set = first
        self.pk_master = first.public_key()
        self.threshold = first.threshold()
        self.pk_shares = [first.public_key_share(i) for i in range(n)]
        self.era += 1
        # era-keyed staging invalidation: the backend drops the residue
        # rows staged for the dead era's key material (ops/staging.py)
        self.backend.new_era(self.era)
        self.churn_reports.append(rep)
        return rep

    def checkpoint(self) -> bytes:
        """Whole-engine state (keys, era, epoch, RNG, reports) to canonical
        snapshot bytes, taken at a quiescent point: the backend's pipeline
        is flushed first.  The crypto backend is environment, not state
        (utils/snapshot.py): ``restore`` re-attaches one."""
        from hbbft_tpu_torch.utils.snapshot import save_node

        self.backend.flush()
        return save_node(self)

    @classmethod
    def restore(cls, data: bytes, backend: CryptoBackend) -> "ArrayHoneyBadgerNet":
        """Rebuild from :meth:`checkpoint` bytes on ``backend``; resumes
        byte-identically (the RNG state round-trips, so epoch E+1 after
        restore equals epoch E+1 of the uninterrupted run)."""
        from hbbft_tpu_torch.utils.snapshot import SnapshotError, load_node

        net = load_node(data, backend)
        if not isinstance(net, cls):
            raise SnapshotError(
                f"snapshot holds {type(net).__name__}, not {cls.__name__}"
            )
        return net

    def run_epochs(
        self,
        k: int,
        payload_size: int = 128,
        churn_at: Optional[Sequence[int]] = None,
    ) -> List[Dict[Any, Batch]]:
        """Run k epochs with synthetic per-node contributions; an
        ``era_change()`` fires before each epoch index in ``churn_at``."""
        churn = set(churn_at or ())
        out = []
        for i in range(k):
            if i in churn:
                self.era_change()
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
