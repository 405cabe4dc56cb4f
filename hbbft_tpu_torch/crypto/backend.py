"""CryptoBackend — the north-star seam between protocols and device kernels.

BASELINE.json's north star: "introduce a `CryptoBackend` trait behind the
existing `DistAlgorithm` step boundary so that `threshold_sign`,
`threshold_decrypt`, and the `binary_agreement` common coin hand their
BLS12-381 pairing checks, multi-scalar-mults, and Lagrange share-combination
to a batched device kernel".

A backend bundles:

* a :class:`~hbbft_tpu_torch.crypto.group.Group` (the curve implementation),
* key-material factories,
* **batched** verify/combine entry points — the protocols and the VirtualNet
  runtime only ever call these with *lists* of independent work items, so a
  device backend can resolve a whole crank-round of pairing checks in one
  dispatch (SURVEY.md §7 "deferred verification").

Implementations:

* :class:`MockBackend`   — MockGroup; replaces the reference's
  `use-insecure-test-only-mock-crypto` Cargo feature (SURVEY.md §2.2).
  The object runtime's protocol tests run on it.
* :class:`CpuBackend`    — pure-Python BLS12-381 golden reference.
* ``TorchBackend`` (hbbft_tpu_torch/ops/backend.py) — the batched device
  paths on the hand-written CUDA kernels.

The host defaults of the ABC below are the per-item golden loops.
"""

from __future__ import annotations

import abc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.crypto.group import Group, MockGroup
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    DecryptionShare,
    PublicKeySet,
    PublicKeyShare,
    SecretKey,
    SecretKeySet,
    Signature,
    SignatureShare,
)


class CryptoBackend(abc.ABC):
    """Factory + batched crypto operations over one group backend."""

    #: True on backends whose erasure/hash plane runs on the device
    #: (TorchBackend): the engine uses it to decide whether PackedProofs
    #: may skip the native-SHA gate (crypto/merkle.py from_trees).
    device_rs_plane: bool = False

    def __init__(self, group: Group) -> None:
        self.group = group
        from hbbft_tpu_torch.obs.hostbuckets import HostBuckets
        from hbbft_tpu_torch.utils.metrics import Counters

        #: operative-metric tallies (SURVEY.md §5): shares verified/combined,
        #: pairing checks, device dispatches.
        self.counters = Counters()
        #: opt-in tracer; when attached, the
        #: batched entry points emit dispatch spans + batch-size histograms
        #: (host backends span the batched host call; TpuBackend spans the
        #: actual jitted dispatch+fetch with ``device=True``).
        self.tracer = None
        #: host-time attribution regions (obs/hostbuckets.py): the array
        #: engine wraps its epoch phases in ``buckets.region(...)`` blocks
        #: so ``host_seconds`` splits into named ``host_bucket_*``
        #: counters; device backends nest their staging blocks under it.
        self.buckets = HostBuckets(
            self.counters, tracer_ref=lambda: self.tracer
        )

    def _traced(self, kind: str, n_items: int, fn: Callable[[], Any]) -> Any:
        """Run one batched backend call under a dispatch span when tracing.

        ``kind`` reuses the ``device_seconds_*`` label vocabulary as the
        span category.  Zero-cost when no tracer is attached; empty
        batches (no-op flushes) are not recorded — a flood of items=0
        samples would drag the batch-size percentiles to zero."""
        tr = self.tracer
        if tr is None or not n_items:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        tr.complete(
            f"dispatch:{kind}", t0, t1, cat=kind, track="device",
            items=n_items, device=False,
        )
        tr.hist("dispatch_batch_items").record(n_items)
        return out

    # -- key material --------------------------------------------------------

    def generate_key_set(self, threshold: int, rng) -> SecretKeySet:
        return SecretKeySet.random(self.group, threshold, rng)

    def generate_secret_key(self, rng) -> SecretKey:
        return SecretKey.random(self.group, rng)

    # -- batched verification (the hot loop; SURVEY.md §3.2) -----------------

    def verify_sig_shares(
        self, items: Sequence[Tuple[PublicKeyShare, bytes, SignatureShare]]
    ) -> List[bool]:
        """Verify a batch of (pk_share, document, sig_share) triples."""
        c = self.counters
        c.sig_shares_verified += len(items)
        c.pairing_checks += len(items)
        return self._traced(
            "pairing",
            len(items),
            lambda: [pk.verify_sig_share(share, doc) for pk, doc, share in items],
        )

    def verify_dec_shares(
        self, items: Sequence[Tuple[PublicKeyShare, Ciphertext, DecryptionShare]]
    ) -> List[bool]:
        """Verify a batch of (pk_share, ciphertext, dec_share) triples."""
        c = self.counters
        c.dec_shares_verified += len(items)
        c.pairing_checks += len(items)
        return self._traced(
            "pairing",
            len(items),
            lambda: [pk.verify_decryption_share(share, ct) for pk, ct, share in items],
        )

    def verify_signatures(
        self, items: Sequence[Tuple[Any, bytes, Signature]]
    ) -> List[bool]:
        """Verify a batch of full (public_key, message, signature) triples
        (per-node vote/key-gen signatures — SURVEY.md §3.2 DHB path)."""
        self.counters.signatures_verified += len(items)
        self.counters.pairing_checks += len(items)
        return self._traced(
            "pairing",
            len(items),
            lambda: [pk.verify(sig, msg) for pk, msg, sig in items],
        )

    def verify_ciphertexts(self, items: Sequence[Ciphertext]) -> List[bool]:
        self.counters.ciphertexts_verified += len(items)
        self.counters.pairing_checks += len(items)
        return self._traced(
            "pairing", len(items), lambda: [ct.verify() for ct in items]
        )

    # -- deferred verification (cross-round host pipelining) -----------------
    #
    # The array engine overlaps round r+1's item-list assembly with round
    # r's verification dispatches: each *_deferred entry point SUBMITS the
    # batch and returns a zero-arg resolver producing the same List[bool]
    # the synchronous twin returns.  Device backends submit the work
    # behind the bounded in-flight queue (ops/pipeline.py) and resolve on
    # call; the defaults here compute eagerly (host backends have nothing
    # to overlap), so every backend satisfies the contract: identical
    # results and counter accounting, dispatch counts unchanged.

    def verify_sig_shares_deferred(
        self, items: Sequence[Tuple[PublicKeyShare, bytes, SignatureShare]]
    ) -> Callable[[], List[bool]]:
        out = self.verify_sig_shares(items)
        return lambda: out

    def verify_dec_shares_deferred(
        self, items: Sequence[Tuple[PublicKeyShare, Ciphertext, DecryptionShare]]
    ) -> Callable[[], List[bool]]:
        out = self.verify_dec_shares(items)
        return lambda: out

    def verify_ciphertexts_deferred(
        self, items: Sequence[Ciphertext]
    ) -> Callable[[], List[bool]]:
        out = self.verify_ciphertexts(items)
        return lambda: out

    # -- combination ---------------------------------------------------------

    def combine_signatures(
        self,
        pk_set: PublicKeySet,
        shares: Dict[int, SignatureShare],
        doc: Optional[bytes] = None,
    ) -> Signature:
        """Lagrange-combine ≥ threshold+1 verified shares into a signature.

        `doc` (the signed document) is optional context: host backends
        ignore it, device backends use it to re-verify the combined
        signature against the master public key (defense in depth for the
        batched ladder path)."""
        self.counters.sig_shares_combined += len(shares)
        return pk_set.combine_signatures(shares)

    def combine_decryption_shares(
        self, pk_set: PublicKeySet, shares: Dict[int, DecryptionShare], ct: Ciphertext
    ) -> bytes:
        self.counters.dec_shares_combined += len(shares)
        return pk_set.combine_decryption_shares(shares, ct)

    def combine_dec_shares_batch(
        self,
        pk_set: PublicKeySet,
        items: Sequence[Tuple[Dict[int, DecryptionShare], Ciphertext]],
    ) -> List[bytes]:
        """Combine many share sets at once.

        Device backends override this with a single batched dispatch (the
        share-combination kernel is BASELINE config 5's "ICI all-gather"
        shape); the default is the per-item loop.
        """
        return self._traced(
            "combine",
            len(items),
            lambda: [
                self.combine_decryption_shares(pk_set, shares, ct)
                for shares, ct in items
            ],
        )

    def sign_shares_batch(
        self, items: Sequence[Tuple[Any, bytes]]
    ) -> List[SignatureShare]:
        """Produce signature shares for many (secret_key_share, doc) pairs
        at once — the share-GENERATION side of the common coin (each item
        is one x_i·H2(doc) G2 scalar multiplication; SURVEY.md §3.2 marks
        the coin as the hottest loop).  Device backends override with one
        batched ladder dispatch."""
        return self._traced(
            "sign",
            len(items),
            lambda: [sk.sign_share(doc) for sk, doc in items],
        )

    def combine_sig_shares_batch(
        self,
        pk_set: PublicKeySet,
        items: Sequence[Tuple[Dict[int, SignatureShare], Optional[bytes]]],
    ) -> List[Signature]:
        """Combine many signature-share sets at once (each item: shares,
        optional doc for the combined-signature re-verify).  Device
        backends override with a batched G2 Lagrange dispatch; the default
        is the per-item loop."""
        return self._traced(
            "combine",
            len(items),
            lambda: [
                self.combine_signatures(pk_set, shares, doc=doc)
                for shares, doc in items
            ],
        )

    def decrypt_shares_batch(
        self, items: Sequence[Tuple[Any, Ciphertext]]
    ) -> List[DecryptionShare]:
        """Produce decryption shares for many (secret_key_share, ciphertext)
        pairs at once — the share-GENERATION side of threshold decryption
        (each item is one x_i·U scalar multiplication).

        The whole-network simulation emits N² of these per epoch (every
        node shares every accepted proposer's ciphertext); device backends
        override with one batched ladder dispatch.
        """
        return self._traced(
            "decrypt",
            len(items),
            lambda: [sk.decrypt_share_unchecked(ct) for sk, ct in items],
        )

    def g1_mul_batch(
        self, scalars: Sequence[int], points: Sequence[Any], kind: str = "dkg"
    ) -> List[Any]:
        """Batched independent G1 scalar multiplications s_i·P_i — the
        primitive the batched era-change DKG (engine/dkg_batch.py) feeds
        with commitment/encryption/decryption ladders.  Device backends
        override with batched ladder dispatches."""
        g = self.group
        return [g.g1_mul(s, p) for s, p in zip(scalars, points)]

    def g2_mul_batch(
        self, scalars: Sequence[int], points: Sequence[Any], kind: str = "dkg"
    ) -> List[Any]:
        """Batched independent G2 scalar multiplications (ciphertext W
        components in the batched DKG)."""
        g = self.group
        return [g.g2_mul(s, p) for s, p in zip(scalars, points)]

    def g1_lincomb(self, scalars: Sequence[int], points: Sequence[Any]) -> Any:
        """One multi-scalar combination Σ s_i·P_i — the aggregated side of
        the DKG's RLC commitment checks and era-change cross-checks (one
        MSM replaces N³ per-item Horner evaluations).  Default: batched
        muls + host fold; TorchBackend overrides with one
        linear_combine_g1 dispatch per lane-capped chunk, riding the
        GLV joint-table ladder (ops/backend.py)."""
        g = self.group
        acc = g.g1_identity()
        for el in self.g1_mul_batch(scalars, points):
            acc = g.g1_add(acc, el)
        return acc

    # -- erasure/hash plane ----------------------------------------------------
    #
    # The RBC plane's RS encode/reconstruct and Merkle build/verify, batched
    # across proposers exactly like the crypto entry points batch across
    # shares.  These host codec/hashlib loops (the native C kernels where
    # they are built) are bit-identical to calling the codec / MerkleTree
    # directly.

    def rs_encode_batch(self, codec, datas: Sequence[bytes]) -> List[List[bytes]]:
        """RS-encode many data blocks with one codec: per block, k data
        shards + m parity shards (``RSCodec.encode`` semantics)."""
        return self._traced("rs_enc", len(datas), lambda: [codec.encode(d) for d in datas])

    def rs_reconstruct_batch(
        self, codec, shard_lists: Sequence[Sequence[Optional[bytes]]]
    ) -> List[List[bytes]]:
        """Reconstruct many shard vectors (``RSCodec.reconstruct``
        semantics, including its error raises and the zero-math
        all-present fast case)."""
        return self._traced(
            "rs_dec", len(shard_lists), lambda: [codec.reconstruct(list(s)) for s in shard_lists]
        )

    def merkle_build_batch(self, shard_lists: Sequence[Sequence[bytes]]) -> List[Any]:
        """Build one MerkleTree per shard vector."""
        from hbbft_tpu_torch.crypto.merkle import MerkleTree

        return self._traced(
            "merkle", len(shard_lists), lambda: [MerkleTree(list(sl)) for sl in shard_lists]
        )

    def merkle_verify_batch(self, packed, reps: int = 1) -> List[bool]:
        """Validate a ``PackedProofs`` batch (``reps`` repetitions keep the
        measured hash workload equal to N independent receivers)."""
        return self._traced("merkle", len(packed), lambda: packed.validate(reps))

    # -- misc ----------------------------------------------------------------

    @property
    def name(self) -> str:
        return type(self).__name__

    def flush(self) -> None:
        """Device backends override to force pending batches to resolve."""

    def new_era(self, era: int) -> None:
        """Era-turnover hook (the engine calls it after every DKG):
        device backends drop per-era staged key material (the limb-row
        staging cache); host backends have nothing staged."""


class MockBackend(CryptoBackend):
    """Fast insecure backend for protocol-logic tests (mock bilinear group).

    The batched verifies are plain loops; the deferred entry points are the
    ABC's defaults.  (The JAX package's copy also routes them through a
    chunked out-of-order pipeline for its schedule explorer, which the port
    does not have yet.)
    """

    def __init__(self) -> None:
        super().__init__(MockGroup())

    def verify_sig_shares(self, items) -> List[bool]:
        # Inlined mock math (e(a,b) = a·b over Z_r): the generic loop costs
        # several Python frames per item.  Same equation as
        # PublicKeyShare.verify_sig_share.
        c = self.counters
        c.sig_shares_verified += len(items)
        c.pairing_checks += len(items)
        r = self.group.r
        h2 = self.group.hash_to_g2
        return self._traced(
            "pairing",
            len(items),
            lambda: [share.el % r == (pk.el * h2(doc)) % r for pk, doc, share in items],
        )

    def verify_dec_shares(self, items) -> List[bool]:
        # Same equation as PublicKeyShare.verify_decryption_share.
        c = self.counters
        c.dec_shares_verified += len(items)
        c.pairing_checks += len(items)
        r = self.group.r
        return self._traced(
            "pairing",
            len(items),
            lambda: [
                (share.el * ct.hash_point()) % r == (pk.el * ct.w) % r
                for pk, ct, share in items
            ],
        )


class CpuBackend(CryptoBackend):
    """Pure-Python BLS12-381 — the golden reference backend.

    Slow (Python-int pairings) but real: used to golden-test both the
    protocol layer and the JAX kernels.  Imported lazily to keep MockBackend
    import-light.
    """

    def __init__(self) -> None:
        from hbbft_tpu_torch.crypto.bls381 import BLS381Group

        super().__init__(BLS381Group())
