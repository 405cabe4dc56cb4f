"""TorchBackend — batched device crypto behind the CryptoBackend seam (the
JAX package's ``TpuBackend``, threshold-decryption path).

The protocols hand whole *batches* of pairing checks and share
combinations to this backend, which resolves them in a handful of device
dispatches instead of per-share host loops.  Every verification equation
has the shape ``e(a1, b1) == e(a2, b2)``, i.e.
``FE(ML(a1, b1)·ML(−a2, b2)) == 1``:

* dec share:    e(D_i, H)   == e(PK_i, W)
* ciphertext:   e(G1, W)    == e(U, H)

so ONE composition — two batched Miller loops + one shared final
exponentiation (``pairing.product2_fast``) — serves both.  Batches are
padded to power-of-two buckets with trivially-true items.  Hash-to-curve
and the canonical ``== 1`` comparison run on the host.

Carried over from TpuBackend: grouped random-linear-combination (RLC)
share verification with bisection and the contamination-adaptive group
cap, lane-capped pipelined chunking, the staging cache, bucket padding,
the dispatch kinds and the ``device_dispatches`` accounting.  The
jitted graphs of the JAX package are plain functions here; on the card
every field product inside them runs through the kernels of
``ops/fq_rns_cuda.py``, and every verification graph rides the fused
tower kernels (``ops/pairing_chain.py``) unless
``HBBFT_TPU_NO_FUSED_TOWER=1`` — resolved per dispatch and billed by
``_bill_chain``.  ``g1_mul_batch``/``g2_mul_batch`` (the batched
threshold encryption of the array engine) ride the same ladders as
decryption-share generation.  The signature/coin paths and the DKG are
not ported yet: those ``CryptoBackend`` methods run the seam's per-item
host defaults (crypto/backend.py), never a device path.

The RLC coefficients are drawn from the OS CSPRNG (``os.urandom``): a
seeded generator would make them predictable and void the batch check.
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.bls381 import BLS381Group
from hbbft_tpu_torch.crypto.field import lagrange_coeffs_at_zero
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    CryptoError,
    DecryptionShare,
    PublicKeySet,
    PublicKeyShare,
)
from hbbft_tpu_torch.ops import curve, pairing, pairing_chain
from hbbft_tpu_torch.ops.pipeline import DispatchPipeline, fetch_to_host
from hbbft_tpu_torch.ops.staging import StagingCache
from hbbft_tpu_torch.utils.device import resolve
from hbbft_tpu_torch.utils.tree import tree_map

_MIN_BUCKET = 4


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def _squeeze_point(P):
    """(G, 1, ...) Jacobian from a batched combine → (G, ...)."""
    return tree_map(lambda c: c[:, 0], P)


def _rlc_dec(D, PK, H, W, rbits, fused=None):
    """Grouped dec-share check: e(Σr·D_i, H) == e(Σr·PK_i, W) per group.
    D, PK: (G, k) Jacobian G1; H, W (G,) affine G2; rbits (G, k, RLC_BITS).
    The device graph of the check, a plain function: every Fq product in
    it is a kernel launch; ``fused`` routes its pairing as
    ``pairing.product2_fast`` does."""
    zeros = torch.zeros(rbits.shape[:2], dtype=torch.bool, device=rbits.device)
    comb_d = curve.linear_combine_g1(D, rbits, zeros)
    comb_pk = curve.linear_combine_g1(PK, rbits, zeros)
    d_aff = curve.jac_to_affine_g1(_squeeze_point(comb_d))
    pk_aff = curve.jac_to_affine_g1(_squeeze_point(comb_pk))
    neg_pk = (pk_aff[0], -pk_aff[1], pk_aff[2])
    return pairing.product2_fast(d_aff, H, neg_pk, W, fused=fused)


#: (to_device, from_device, ladder, scalar prep) of the batched G1 and G2
#: independent-ladder dispatches
_G1_LADDER = (curve.g1_to_device, curve.g1_from_device, curve.g1_scalar_mul_signed,
              curve.prep_g1_scalars)
_G2_LADDER = (curve.g2_to_device, curve.g2_from_device, curve.g2_scalar_mul_signed,
              curve.prep_g2_scalars)


class TorchBackend(CryptoBackend):
    """PyTorch/CUDA batched BLS12-381 backend.

    ``device`` defaults to the card; without CUDA the constructor raises
    (pass ``device="cpu"`` to run the plain versions on the CPU).
    Protocol-visible semantics are identical to the host golden path."""

    #: combine on device only when at least this many shares are batched
    device_combine_threshold = 8
    #: max ladder lanes (items × shares) per combine/generation dispatch
    device_lane_cap = 1 << 15
    #: max pairing checks per device dispatch
    pairing_lane_cap = 2048
    #: groups of at least this many same-ciphertext shares take the RLC path
    rlc_min_group = 3
    #: RLC coefficient width: a forged share survives a group check with
    #: probability 2^-64, and False only ever comes from an exact pairing
    rlc_bits = 64
    #: observed-rejection rate below which groups are left at full size
    rlc_adapt_min_rate = 0.005

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        super().__init__(BLS381Group())
        self._h2_cache: Dict[bytes, Any] = {}
        self._pipe = DispatchPipeline(counters=self.counters, tracer_ref=lambda: self.tracer)
        self._stage = StagingCache(counters=self.counters)
        # decayed (items seen, items rejected) window of the grouped
        # verifies — sizes the NEXT batch's groups (_rlc_adaptive_cap)
        self._rlc_obs_items = 0.0
        self._rlc_obs_rejects = 0.0
        # share indices → Lagrange ladder rows: the engine's N²
        # combines per epoch all interpolate over the same indices
        self._prep_memo: Dict[Any, Tuple[np.ndarray, np.ndarray]] = {}

    def flush(self) -> None:
        """Resolve every pending (dispatched-but-unfetched) chunk."""
        self._pipe.flush()

    def new_era(self, era: int) -> None:
        """Era turnover: drop staged residue rows of dead key material."""
        self._stage.clear()

    @contextmanager
    def _host_assembly(self):
        """Time one host staging block into counters.host_assembly_seconds
        (and the ``staging`` host bucket)."""
        t0 = time.perf_counter()
        with self.buckets.region("staging"):
            try:
                yield
            finally:
                self.counters.host_assembly_seconds += time.perf_counter() - t0

    def _prep_scalars(self, prep, scalars):
        """Run a curve.prep_g*_scalars host prep under the GLV counters."""
        t0 = time.perf_counter()
        bits, negs = prep(scalars)
        c = self.counters
        c.glv_table_build_seconds += time.perf_counter() - t0
        c.glv_decompositions += len(scalars)
        return bits, negs

    def _count_ladder(self, bits, lanes: int, glv: bool, ladders_per_lane: int = 1) -> None:
        """Analytic ladder accounting (ladder_field_muls, glv_table_field_muls)."""
        c = self.counters
        c.ladder_field_muls += curve.ladder_scan_field_muls(bits, glv) * lanes * ladders_per_lane
        if glv:
            c.glv_table_field_muls += curve.glv_table_field_muls(bits) * lanes * ladders_per_lane

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _to_device_gather(self, points, to_device, transform=None):
        """Stage ``points`` with identity-deduplicated conversion: the
        engine replicates the SAME point objects across receivers, so the
        residue conversion runs per DISTINCT object and the full-width
        rows are rebuilt by one numpy gather per coordinate plane."""

        def conv(pts, gather=None):
            if transform is not None:
                pts = [transform(p) if p is not None else None for p in pts]
            return to_device(pts, cache=self._stage, gather=gather, device=self.device)

        if len(points) <= 1:
            return conv(list(points))
        index: Dict[Any, int] = {}
        order: List[Any] = []
        idx = np.empty(len(points), dtype=np.int64)
        for j, p in enumerate(points):
            key = None if p is None else id(p)
            pos = index.get(key)
            if pos is None:
                pos = index[key] = len(order)
                order.append(p)
            idx[j] = pos
        if len(order) == len(points):
            return conv(order)
        return conv(order, gather=idx)

    def _hash_g2(self, doc: bytes):
        h = self._h2_cache.get(doc)
        if h is None:
            t0 = time.perf_counter()
            h = self.group.hash_to_g2(doc)
            self.counters.hash_g2_seconds += time.perf_counter() - t0
            while len(self._h2_cache) >= 4096:  # bounded LRU
                self._h2_cache.pop(next(iter(self._h2_cache)))
        else:
            del self._h2_cache[doc]  # re-insert → most-recently-used
        self._h2_cache[doc] = h
        return h

    # -- dispatch ------------------------------------------------------------

    def _dispatch_fetch(self, fn, args, kind: str = "", items: int = 0):
        """Dispatch one device call and fetch its result synchronously
        (draining pending pipelined chunks first, FIFO)."""
        return self._pipe.submit(
            lambda: fn(*args), fetch_to_host, kind=kind, items=items, sync=True
        ).value

    def _dispatch_async(self, fn, args, kind: str = "", items: int = 0, on_result=None):
        """Dispatch one device call with a DEFERRED fetch behind the
        bounded in-flight queue."""
        return self._pipe.submit(
            lambda: fn(*args), fetch_to_host, kind=kind, items=items, on_result=on_result
        )

    # -- exact pairing checks --------------------------------------------------

    def _check_batch(self, quads) -> List[bool]:
        """quads: (a1, b1, a2, b2) affine tuples checking e(a1,b1) == e(a2,b2)."""
        quads = list(quads)
        results: List[Optional[bool]] = [None] * len(quads)
        self._check_batch_async(quads, results.__setitem__)
        self._pipe.flush()
        return [bool(r) for r in results]

    def _check_batch_async(self, quads, write) -> None:
        """Submit pairing checks in pipelined lane-capped chunks; per-item
        booleans arrive as ``write(index, ok)`` from each chunk's fetch."""
        quads = list(quads)
        for lo in range(0, len(quads), self.pairing_lane_cap):
            self._submit_check_chunk(quads[lo : lo + self.pairing_lane_cap], lo, write)

    def _bill_chain(self, fused: bool, lanes: int) -> None:
        """Fused-chain accounting for one verification dispatch of
        ``lanes`` pairing lanes: the analytic per-graph kernel-launch
        count of whichever composition routes, and on the fused arm the
        analytic Fq-product count inside the fused kernels."""
        c = self.counters
        if fused:
            c.fused_tower_calls += 1
            c.fused_chain_field_muls += pairing_chain.analytic_chain_field_muls(lanes)
            c.fused_chain_pallas_calls += pairing_chain.analytic_pallas_calls(2, fused=True)
        else:
            c.stacked_chain_pallas_calls += pairing_chain.analytic_pallas_calls(2, fused=False)

    def _submit_check_chunk(self, chunk, base: int, write) -> None:
        n = len(chunk)
        if n == 0:
            return
        self.counters.pairing_checks += n
        self.counters.device_dispatches += 1
        # per-dispatch routing: flipping HBBFT_TPU_NO_FUSED_TOWER between
        # calls takes effect at the next dispatch
        fused = pairing_chain.fused_tower_mode()
        g1 = self.group.g1()
        g2 = self.group.g2()
        pad = (g1, g2, g1, g2)  # trivially true
        b = _bucket(n)
        chunk = chunk + [pad] * (b - n)
        neg = self.group.g1_neg
        with self._host_assembly():
            P1 = self._to_device_gather([q[0] for q in chunk], pairing.g1_affine_to_device)
            Q1 = self._to_device_gather([q[1] for q in chunk], pairing.g2_affine_to_device)
            # negation per DISTINCT point, after the dedup
            P2 = self._to_device_gather(
                [q[2] for q in chunk], pairing.g1_affine_to_device, transform=neg
            )
            Q2 = self._to_device_gather([q[3] for q in chunk], pairing.g2_affine_to_device)

        def deliver(f, base=base, n=n):
            for i, ok in enumerate(pairing.is_one_host_batch(f, n)):
                write(base + i, ok)

        self._bill_chain(fused, b)
        self._dispatch_async(
            functools.partial(pairing.product2_fast, fused=fused), (P1, Q1, P2, Q2),
            kind="fused_chain" if fused else "pairing", items=n, on_result=deliver,
        )

    # -- grouped (random-linear-combination) verification --------------------
    #
    # For k same-ciphertext shares, ONE check e(Σr_i·D_i, H) == e(Σr_i·PK_i, W)
    # with unpredictable RLC_BITS-wide r_i replaces k pairing checks: a forged
    # share survives only with probability 2^-RLC_BITS.  Failing groups are
    # bisected; leaves below 2·rlc_min_group get exact per-item checks, so
    # False only ever comes from an exact pairing.

    @staticmethod
    def _rlc_scalars(count: int) -> List[int]:
        """``count`` nonzero RLC coefficients from ONE OS-CSPRNG draw."""
        bits = TorchBackend.rlc_bits
        top = (1 << bits) - 1
        nb = (bits + 7) // 8
        buf = os.urandom(nb * count)
        return [1 + int.from_bytes(buf[o : o + nb], "big") % top for o in range(0, len(buf), nb)]

    def _rlc_observed_rate(self) -> float:
        if self._rlc_obs_items <= 0:
            return 0.0
        return self._rlc_obs_rejects / self._rlc_obs_items

    def _rlc_adaptive_cap(self) -> Optional[int]:
        """Max initial group size for the next batch (k* ≈ 0.7/c for an
        observed contamination c), or None in the honest regime."""
        rate = self._rlc_observed_rate()
        if rate < self.rlc_adapt_min_rate:
            return None
        return max(self.rlc_min_group, round(0.7 / rate))

    def _rlc_observe(self, indices: List[int], results: List) -> None:
        """Fold one finished grouped verify into the decayed window."""
        if not indices:
            return
        rejects = sum(1 for idx in indices if results[idx] is False)
        self._rlc_obs_items = self._rlc_obs_items * 0.5 + len(indices)
        self._rlc_obs_rejects = self._rlc_obs_rejects * 0.5 + rejects

    def _rlc_apply_cap(self, groups: List[List[int]]) -> List[List[int]]:
        """Split groups to the adaptive cap (contiguous slices; a short
        tail is folded into the previous slice)."""
        cap = self._rlc_adaptive_cap()
        if cap is None:
            return groups
        out: List[List[int]] = []
        split = False
        for grp in groups:
            if len(grp) <= cap:
                out.append(grp)
                continue
            split = True
            for lo in range(0, len(grp), cap):
                piece = grp[lo : lo + cap]
                if len(piece) < self.rlc_min_group and out and split:
                    out[-1].extend(piece)
                else:
                    out.append(list(piece))
        if split:
            self.counters.rlc_adaptive_splits += 1
        return out

    @staticmethod
    def _reshape_groups(dev, g: int, k: int):
        return tree_map(lambda c: c.reshape((g, k) + tuple(c.shape[1:])), dev)

    def _grouped_rlc(self, groups, items, build_group_arrays, fn, results, direct_quad,
                     kind: str = "", deferred: bool = False):
        """Run RLC group checks; write per-item booleans into ``results``.
        ``deferred=True`` submits the first round behind the in-flight
        queue and returns a resumer that finishes the bisection."""
        pending = self._rlc_apply_cap([list(grp) for grp in groups if grp])
        grouped_idx = [i for grp in pending for i in grp]
        if deferred and pending:
            args, n_items = self._rlc_round_stage(pending, build_group_arrays)
            holder: List[Any] = []
            self.counters.device_dispatches += 1
            self._dispatch_async(fn, args, kind=kind, items=n_items, on_result=holder.append)

            def resume():
                if not holder:
                    self._pipe.flush()
                nxt = self._rlc_process_round(pending, holder[0], items, results, direct_quad)
                self._rlc_rounds(nxt, items, build_group_arrays, fn, results, direct_quad, kind)
                self._rlc_observe(grouped_idx, results)

            return resume
        self._rlc_rounds(pending, items, build_group_arrays, fn, results, direct_quad, kind)
        self._rlc_observe(grouped_idx, results)
        return None

    def _rlc_rounds(self, pending, items, build_group_arrays, fn, results, direct_quad,
                    kind) -> None:
        """The synchronous bisection loop: one sync group dispatch per round."""
        while pending:
            args, n_items = self._rlc_round_stage(pending, build_group_arrays)
            self.counters.device_dispatches += 1
            f = self._dispatch_fetch(fn, args, kind=kind, items=n_items)
            pending = self._rlc_process_round(pending, f, items, results, direct_quad)
        self._pipe.flush()

    def _rlc_round_stage(self, pending, build_group_arrays):
        """Stage one round: pad groups, draw fresh coefficients for the
        whole (g, k) matrix, build the group point arrays."""
        with self._host_assembly():
            k = _bucket(max(len(grp) for grp in pending))
            g = _bucket(len(pending))
            padded: List[List[Optional[int]]] = [
                list(grp) + [None] * (k - len(grp)) for grp in pending
            ] + [[None] * k] * (g - len(pending))
            flat_rs = self._rlc_scalars(k * len(padded))
            scalars = [
                flat_rs[gi * k + j] if idx is not None else 0
                for gi, grp in enumerate(padded)
                for j, idx in enumerate(grp)
            ]
            rbits = curve.scalars_to_bits(scalars, self.rlc_bits).reshape(g, k, -1)
            args = tuple(build_group_arrays(padded, g, k)) + (self._tensor(rbits),)
        # two RLC_BITS-wide w2 ladders per lane (share + key combine)
        n_items = sum(len(grp) for grp in pending)
        self._count_ladder(rbits, n_items, glv=False, ladders_per_lane=2)
        self.counters.rlc_groups += len(pending)
        return args, n_items

    def _rlc_process_round(self, pending, f, items, results, direct_quad):
        """Passing groups write True, small failing groups drop to async
        exact per-item checks, larger ones bisect into the next round."""
        next_pending: List[List[int]] = []
        new_leaves: List[int] = []
        group_ok = pairing.is_one_host_batch(f, len(pending))
        for gi, grp in enumerate(pending):
            if group_ok[gi]:
                for idx in grp:
                    results[idx] = True
            elif len(grp) < 2 * self.rlc_min_group:
                new_leaves.extend(grp)
            else:
                mid = len(grp) // 2
                next_pending.append(grp[:mid])
                next_pending.append(grp[mid:])
        if new_leaves:
            self._check_batch_async(
                [direct_quad(items[idx]) for idx in new_leaves],
                lambda j, ok, leaves=tuple(new_leaves): results.__setitem__(leaves[j], ok),
            )
        return next_pending

    def _finish_verify(self, results, cont, deferred):
        if not deferred:
            self._pipe.flush()
            return [bool(r) for r in results]

        def resolve_results():
            self._pipe.flush()
            if cont is not None:
                cont()
            return [bool(r) for r in results]

        return resolve_results

    # -- batched verification ------------------------------------------------

    def verify_dec_shares(
        self, items: Sequence[Tuple[PublicKeyShare, Ciphertext, DecryptionShare]]
    ) -> List[bool]:
        return self._verify_dec_shares_impl(items, deferred=False)

    def verify_dec_shares_deferred(
        self, items: Sequence[Tuple[PublicKeyShare, Ciphertext, DecryptionShare]]
    ):
        """Submit now, resolve later: the returned resolver yields the same
        booleans ``verify_dec_shares`` would, with identical dispatch counts."""
        return self._verify_dec_shares_impl(items, deferred=True)

    def _verify_dec_shares_impl(self, items, deferred: bool):
        def direct(item):
            pk, ct, share = item
            h = self._hash_g2(self.group.g1_to_bytes(ct.u) + ct.v)
            return (share.el, h, pk.el, ct.w)

        self.counters.dec_shares_verified += len(items)
        results: List[Optional[bool]] = [None] * len(items)

        by_ct: Dict[bytes, List[int]] = {}
        for i, (pk, ct, share) in enumerate(items):
            by_ct.setdefault(ct.digest(), []).append(i)
        rlc_groups = [g for g in by_ct.values() if len(g) >= self.rlc_min_group]
        direct_idx = [i for g in by_ct.values() if len(g) < self.rlc_min_group for i in g]

        if direct_idx:
            self._check_batch_async(
                [direct(items[i]) for i in direct_idx],
                lambda j, ok, idx=tuple(direct_idx): results.__setitem__(idx[j], ok),
            )

        def build(padded, g, k):
            flat = [i for grp in padded for i in grp]
            D_jac = self._reshape_groups(
                self._to_device_gather(
                    [items[i][2].el if i is not None else None for i in flat],
                    curve.g1_to_device,
                ),
                g, k,
            )
            PK_jac = self._reshape_groups(
                self._to_device_gather(
                    [items[i][0].el if i is not None else None for i in flat],
                    curve.g1_to_device,
                ),
                g, k,
            )
            hs, ws = [], []
            for gi in range(g):
                first = next((i for i in padded[gi] if i is not None), None)
                if first is None:
                    hs.append(None)
                    ws.append(None)
                else:
                    ct = items[first][1]
                    hs.append(self._hash_g2(self.group.g1_to_bytes(ct.u) + ct.v))
                    ws.append(ct.w)
            H = pairing.g2_affine_to_device(hs, cache=self._stage, device=self.device)
            W = pairing.g2_affine_to_device(ws, cache=self._stage, device=self.device)
            return (D_jac, PK_jac, H, W)

        def rlc(D_jac, PK_jac, H, W, rbits):
            # per-dispatch routing + fused-chain accounting; the dispatch
            # KIND stays rlc_dec (the fused/stacked split reads off the
            # counters)
            fused = pairing_chain.fused_tower_mode()
            self._bill_chain(fused, rbits.shape[0])
            return _rlc_dec(D_jac, PK_jac, H, W, rbits, fused=fused)

        cont = self._grouped_rlc(
            rlc_groups, items, build, rlc, results, direct, kind="rlc_dec",
            deferred=deferred,
        )
        return self._finish_verify(results, cont, deferred)

    def verify_ciphertexts(self, items: Sequence[Ciphertext]) -> List[bool]:
        self.counters.ciphertexts_verified += len(items)
        return self._check_batch(self._ct_quads(items))

    def verify_ciphertexts_deferred(self, items: Sequence[Ciphertext]):
        """Deferred twin of ``verify_ciphertexts``."""
        self.counters.ciphertexts_verified += len(items)
        results: List[Optional[bool]] = [None] * len(items)
        self._check_batch_async(self._ct_quads(items), results.__setitem__)
        return self._finish_verify(results, None, deferred=True)

    def _ct_quads(self, items: Sequence[Ciphertext]):
        g1 = self.group.g1()
        quads = []
        for ct in items:
            h = self._hash_g2(self.group.g1_to_bytes(ct.u) + ct.v)
            quads.append((g1, ct.w, ct.u, h))
        return quads

    # -- combination ---------------------------------------------------------

    def _plaintext_from_combined(self, combined, ct: Ciphertext) -> bytes:
        """Shared tail of threshold decryption: pad = H(s·PK), v ⊕ pad."""
        g = self.group
        pad = g.hash_bytes(g.g1_to_bytes(combined), len(ct.v))
        return bytes(a ^ b for a, b in zip(ct.v, pad))

    def combine_dec_shares_batch(
        self,
        pk_set: PublicKeySet,
        items: Sequence[Tuple[Dict[int, DecryptionShare], Ciphertext]],
    ) -> List[bytes]:
        """All combines in one device dispatch per lane-capped chunk of each
        share-count group: a (B, k) Lagrange linear combination over the
        item axis, padded to power-of-two B buckets."""
        out: List[Optional[bytes]] = [None] * len(items)
        by_k: Dict[int, List[int]] = {}
        for idx, (shares, _ct) in enumerate(items):
            if len(shares) <= pk_set.threshold():
                raise CryptoError(f"need {pk_set.threshold() + 1} shares, got {len(shares)}")
            by_k.setdefault(len(shares), []).append(idx)
        for k, all_idxs in by_k.items():
            self.counters.dec_shares_combined += k * len(all_idxs)
            # gate on TOTAL ladder lanes (k shares × items)
            if k * len(all_idxs) < self.device_combine_threshold:
                for idx in all_idxs:
                    shares, ct = items[idx]
                    out[idx] = pk_set.combine_decryption_shares(shares, ct)
                continue
            step = self._lane_capped_step(k)
            for lo in range(0, len(all_idxs), step):
                self._combine_dec_chunk(items, all_idxs[lo : lo + step], k, out)
        self._pipe.flush()
        return out  # type: ignore[return-value]

    def _combine_dec_chunk(self, items, idxs, k, out) -> None:
        def deliver(combined, idxs=tuple(idxs)):
            els = curve.g1_from_device(_squeeze_point(combined))
            for idx, el in zip(idxs, els[: len(idxs)]):
                out[idx] = self._plaintext_from_combined(el, items[idx][1])

        self._lagrange_chunk([items[idx][0] for idx in idxs], k, deliver)

    def _combine_prep(self, idxs: Tuple[int, ...]):
        """Memoized (bits, negs) ladder form of the Lagrange coefficients
        over share indices ``idxs`` (0-based)."""
        hit = self._prep_memo.get(idxs)
        if hit is None:
            lam = lagrange_coeffs_at_zero([i + 1 for i in idxs])
            hit = self._prep_scalars(curve.prep_g1_scalars, lam)
            if len(self._prep_memo) >= 4096:
                self._prep_memo.clear()
            self._prep_memo[idxs] = hit
        return hit

    def _lane_capped_step(self, k: int) -> int:
        """Items per combine chunk: lane-capped, a power of two, and never
        below the bucket floor (which would only add padding lanes)."""
        step = max(1, self.device_lane_cap // k)
        if step & (step - 1):
            step = 1 << (step.bit_length() - 1)
        return max(step, _bucket(1))

    def _lagrange_chunk(self, share_dicts, k, on_result):
        """(B, k) point tree + per-item coefficient rows, padded with copies
        of the first item (discarded) to a power-of-two item bucket."""
        with self._host_assembly():
            b = _bucket(len(share_dicts))
            flat_pts: List[Any] = []
            bits_rows = []
            negs_rows = []
            for shares in share_dicts:
                srt = sorted(shares.items())
                flat_pts.extend(s.el for _, s in srt)
                row_bits, row_negs = self._combine_prep(tuple(i for i, _ in srt))
                bits_rows.append(row_bits)
                negs_rows.append(row_negs)
            pad = b - len(share_dicts)
            flat_pts.extend(flat_pts[:k] * pad)
            bits_rows.extend([bits_rows[0]] * pad)
            negs_rows.extend([negs_rows[0]] * pad)
            P = self._to_device_gather(flat_pts, curve.g1_to_device)
            P = tree_map(lambda c: c.reshape((b, k) + tuple(c.shape[1:])), P)
            bits = self._tensor(np.stack(bits_rows))
            negs = self._tensor(np.stack(negs_rows))
        self._count_ladder(bits_rows[0], len(share_dicts) * k, glv=True)
        self.counters.device_dispatches += 1
        return self._dispatch_async(
            curve.linear_combine_g1, (P, bits, negs), kind="combine", items=len(share_dicts),
            on_result=on_result,
        )

    def decrypt_shares_batch(self, items: Sequence[Tuple[Any, Ciphertext]]) -> List[DecryptionShare]:
        """All decrypt-share generations (x_i·U_p) as batched G1 ladders.

        Precondition: every ct.u has order r (encrypt() constructs u = rG1
        and deserialized points pass the subgroup check)."""
        els = self._ladder_batch(
            [sk.x for sk, _ in items],
            [ct.u for _, ct in items],
            lambda i: items[i][0].decrypt_share_unchecked(items[i][1]),
            _G1_LADDER,
            kind="decrypt",
        )
        return [
            el if isinstance(el, DecryptionShare) else DecryptionShare(self.group, el)
            for el in els
        ]

    def g1_mul_batch(self, scalars: Sequence[int], points: Sequence[Any],
                     kind: str = "dkg") -> List[Any]:
        """Batched independent G1 ladders s_i·P_i (the batched threshold
        encryption's U and shared components).  ``kind`` picks the
        device-time bucket.  Precondition (as for decrypt_shares_batch):
        points have order r."""
        return self._ladder_batch(
            list(scalars), list(points),
            lambda i: self.group.g1_mul(scalars[i], points[i]),
            _G1_LADDER, kind=kind,
        )

    def g2_mul_batch(self, scalars: Sequence[int], points: Sequence[Any],
                     kind: str = "dkg") -> List[Any]:
        """Batched independent G2 ladders (ciphertext W = s·H2(U‖V))."""
        return self._ladder_batch(
            list(scalars), list(points),
            lambda i: self.group.g2_mul(scalars[i], points[i]),
            _G2_LADDER, kind=kind,
        )

    def _ladder_batch(self, scalars, points, host_fn, ladder, kind=""):
        """Threshold gate → lane-capped pipelined chunk loop → bucket pad →
        deferred-fetch dispatch per chunk; ``host_fn(i)`` serves batches
        (and trailing chunks) below the device threshold.  ``ladder`` is
        ``_G1_LADDER`` or ``_G2_LADDER``."""
        n = len(scalars)
        if n < self.device_combine_threshold:
            return [host_fn(i) for i in range(n)]
        out: List[Any] = [None] * n
        cap = self.device_lane_cap
        for lo in range(0, n, cap):
            hi = min(n, lo + cap)
            if hi - lo < self.device_combine_threshold:
                for i in range(lo, hi):
                    out[i] = host_fn(i)
                continue
            self._submit_ladder_chunk(scalars[lo:hi], points[lo:hi], lo, out, ladder, kind)
        self._pipe.flush()
        return out

    def _submit_ladder_chunk(self, scalars, points, base, out, ladder, kind) -> None:
        to_device, from_device, fn, prep = ladder
        n = len(scalars)
        with self._host_assembly():
            b = _bucket(n)
            bits, negs = self._prep_scalars(prep, list(scalars))
            pts = list(points)
            if b > n:
                bits = np.concatenate([bits, np.repeat(bits[:1], b - n, axis=0)])
                negs = np.concatenate([negs, np.repeat(negs[:1], b - n, axis=0)])
                pts = pts + [pts[0]] * (b - n)
            P = self._to_device_gather(pts, to_device)
            args = (P, self._tensor(bits), self._tensor(negs))
        self._count_ladder(bits, n, glv=bits.ndim == 3)
        self.counters.device_dispatches += 1

        def deliver(fetched, base=base, n=n):
            out[base : base + n] = from_device(fetched)[:n]

        self._dispatch_async(fn, args, kind=kind, items=n, on_result=deliver)
