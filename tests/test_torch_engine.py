"""The port's array engine against the JAX package's, and the port's native
host kernels against numpy/hashlib.

The port's ``ArrayHoneyBadgerNet`` on ``TorchBackend(device="cpu")`` (the
fused chain's plain versions, the RLC grouped checks, the ladders) runs
the same N=4, ``dedup_verifies=True``, ``coin_rounds=1``, 2-epoch schedule
(its RS/Merkle work on the device plane, as on the card)
as the JAX package's engine on its host golden ``CpuBackend`` (as
tests/test_array_engine.py runs it): the Batches must be identical and
every count field of every ``EpochReport`` equal, the coin's included.
The coin round is a superset of the engine's default epoch (its other
rounds are the same code), so the default rides along.  A run under
``HBBFT_TPU_NO_HOSTPIPE=1`` must give the same Batches and dispatches,
and the per-node DKG arm must equal the reference's.
"""

import hashlib
import os
from dataclasses import asdict, fields

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.backend import CpuBackend
from hbbft_tpu.crypto import merkle as ref_merkle
from hbbft_tpu.engine.array_engine import ArrayHoneyBadgerNet as RefNet
from hbbft_tpu_torch import native
from hbbft_tpu_torch.crypto.erasure import _GF
from hbbft_tpu_torch.crypto.merkle import MerkleTree, PackedProofs, validate_proofs
from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet, EpochReport
from hbbft_tpu_torch.ops.backend import TorchBackend

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

N, SEED, EPOCHS, COIN_ROUNDS = 4, 3, 2, 1
_COUNTS = [f.name for f in fields(EpochReport) if f.name != "phase_seconds"]


def _port_run(hostpipe: bool):
    old = os.environ.pop("HBBFT_TPU_NO_HOSTPIPE", None)
    if not hostpipe:
        os.environ["HBBFT_TPU_NO_HOSTPIPE"] = "1"
    try:
        net = ArrayHoneyBadgerNet(range(N), backend=TorchBackend(device="cpu"), seed=SEED,
                                  dedup_verifies=True, coin_rounds=COIN_ROUNDS)
        return net, net.run_epochs(EPOCHS)
    finally:
        os.environ.pop("HBBFT_TPU_NO_HOSTPIPE", None)
        if old is not None:
            os.environ["HBBFT_TPU_NO_HOSTPIPE"] = old


@pytest.fixture(scope="module")
def runs():
    ref = RefNet(range(N), backend=CpuBackend(), seed=SEED, dedup_verifies=True,
                 coin_rounds=COIN_ROUNDS)
    ref_batches = ref.run_epochs(EPOCHS)
    net, batches = _port_run(hostpipe=True)
    return {"ref": ref, "ref_batches": ref_batches, "net": net, "batches": batches}


def _contribs(batches):
    return [{nid: b.contributions for nid, b in sorted(ep.items())} for ep in batches]


def test_batches_identical_to_the_reference(runs):
    got, want = runs["batches"], runs["ref_batches"]
    assert len(got) == EPOCHS
    for e, (ep, ref_ep) in enumerate(zip(got, want)):
        assert sorted(ep) == list(range(N))
        first = ep[0]
        assert first.epoch == e and len(first.contributions) == N
        assert all(b == first for b in ep.values())  # every node, one Batch
        assert {k: v.contributions for k, v in ep.items()} == {
            k: v.contributions for k, v in ref_ep.items()
        }
        assert [b.epoch for b in ep.values()] == [b.epoch for b in ref_ep.values()]


@pytest.mark.parametrize("field", _COUNTS)
def test_epoch_report_counts_equal_the_reference(runs, field):
    got = [asdict(r)[field] for r in runs["net"].reports]
    want = [asdict(r)[field] for r in runs["ref"].reports]
    assert got == want
    assert runs["net"].counters.messages_delivered == runs["ref"].counters.messages_delivered


def test_the_epoch_rode_the_fused_chain(runs):
    c = runs["net"].backend.counters
    assert c.fused_tower_calls > 0 and c.stacked_chain_pallas_calls == 0
    assert c.device_seconds_fused_chain > 0 and c.device_seconds_pairing == 0
    assert c.rlc_groups > 0 and c.device_dispatches > 0
    assert set(runs["net"].reports[-1].phase_seconds) == {"rbc", "coin", "ba", "decrypt"}


def test_the_epoch_rode_the_rs_plane(runs):
    """The erasure/hash plane is on by default: each epoch's encodes, tree
    builds and proof walks ran as device dispatches of kinds rs_enc and
    merkle, while its fault-free reconstructions needed no GF math."""
    c = runs["net"].backend.counters
    assert runs["net"].backend.device_rs_plane
    assert c.device_seconds_rs_enc > 0 and c.device_seconds_merkle > 0
    assert c.device_seconds_rs_dec == 0


def test_the_coin_rounds_ran_on_the_device_paths(runs):
    """Each epoch ran one real coin round (N² signs, N² dedup'd share
    verifies, N combines) through the backend's sig/coin methods: sign
    ladders, grouped sig-share checks and combines billed to their kinds."""
    for rep in runs["net"].reports:
        assert (rep.coin_rounds, rep.coin_signs, rep.sig_shares_verified,
                rep.sig_combines) == (COIN_ROUNDS, N * N, N * N, N)
    c = runs["net"].backend.counters
    assert c.sig_shares_verified == EPOCHS * N * N
    assert c.device_seconds_sign > 0 and c.device_seconds_rlc_sig > 0


def test_no_hostpipe_gives_the_same_batches(runs):
    """The per-item loops give the same Batches and bill the same crypto
    dispatches.  They bypass the erasure/hash plane, as the JAX package's
    engine does, so each epoch bills the plane's dispatches fewer: one
    encode, one tree build and one proof walk in each of rounds 1 and 2
    (``dedup_verifies``: one repetition)."""
    net, batches = _port_run(hostpipe=False)
    assert _contribs(batches) == _contribs(runs["batches"])
    plane = EPOCHS * (1 + 1 + 1 + 1)
    assert net.backend.counters.device_dispatches == (
        runs["net"].backend.counters.device_dispatches - plane)
    assert net.backend.counters.device_seconds_merkle == 0


def test_proofs_walk_one_batch_a_leaf_length():
    """Proposals of different sizes give trees of several leaf lengths:
    on the device plane the engine packs and walks their proofs one batch
    a length, ``reps`` dispatches each, with the verdicts in tree order
    (a corrupted root fails its own tree's proofs alone), equal to the
    per-proof objects'; the host's C kernel takes no ragged batch."""
    net = ArrayHoneyBadgerNet(range(N), backend=TorchBackend(device="cpu"), seed=SEED)
    rs = np.random.default_rng(12)
    trees = [MerkleTree([bytes(rs.integers(0, 256, size=length, dtype=np.uint8))
                         for _ in range(N)]) for length in (9, 13, 9, 40, 13)]
    packs = net._pack_proofs(trees, N)
    assert [rows for rows, _ in packs] == [[0, 2], [1, 4], [3]]
    for rows, packed in packs:
        want = PackedProofs.from_trees([trees[t] for t in rows], N, device=True)
        assert np.array_equal(packed.leaves, want.leaves) and np.array_equal(
            packed.paths, want.paths)
    rows, packed = packs[1]
    packed.roots[N:] ^= 1  # tree 4's proofs
    before = net.backend.counters.device_dispatches
    got = net._walk_packs(packs, N, reps=2)
    assert net.backend.counters.device_dispatches - before == 2 * len(packs)
    proofs = [t.proof(i) for t in trees for i in range(N)]
    want = validate_proofs(proofs, N)
    assert got == [ok and i // N != 4 for i, ok in enumerate(want)]
    assert want == [True] * len(trees) * N
    host = ArrayHoneyBadgerNet(range(N), backend=TorchBackend(device="cpu"), seed=SEED)
    host.backend.device_rs_plane = False
    assert host._pack_proofs(trees, N) is None


def test_recommit_roots_take_the_c_kernel_a_shape_at_a_time(monkeypatch):
    """Round 3's host re-commit: shard vectors of several shapes go to the
    C batch kernel once a shape, a vector with leaves of mixed lengths to
    the python tree; the roots are the host trees' either way."""
    from hbbft_tpu_torch.engine import array_engine

    rs = np.random.default_rng(13)
    sls = [[bytes(rs.integers(0, 256, size=length, dtype=np.uint8)) for _ in range(count)]
           for count, length in ((5, 9), (5, 13), (5, 9), (4, 9))]
    sls.append([b"ab", b"c", b"de"])
    shapes = []
    root_batch = native.merkle_root_batch

    def spy(leaves, size, reps):
        shapes.append(leaves.shape)
        return root_batch(leaves, size, reps)

    monkeypatch.setattr(native, "merkle_root_batch", spy)
    assert array_engine._roots_batch(sls, 3) == [MerkleTree(sl).root_hash for sl in sls]
    assert shapes == [(2, 5, 9), (1, 5, 13), (1, 4, 9)]


def test_unported_options_raise(monkeypatch):
    """(The name is from when these two options raised; it is kept so that
    the case stays the same case.)  The per-node SyncKeyGen arm of the era
    change is ported: every
    ``HBBFT_TPU_DKG`` other than ``batched`` takes it, as in the reference.
    At N=5 on each package's ``MockBackend`` (the shape of
    tests/test_dkg_batch.py), the port's arm equals the reference's in every
    count field and in the new master key, equals the port's batched arm in
    the counts that tests/test_dkg_batch.py compares, and both key sets run
    a post-turnover epoch."""
    from hbbft_tpu.crypto.backend import MockBackend as RefMock
    from hbbft_tpu_torch.crypto.backend import MockBackend as PortMock

    def era_change(net_cls, backend, mode):
        monkeypatch.setenv("HBBFT_TPU_DKG", mode)
        net = net_cls(range(5), backend=backend, seed=7, dynamic=True)
        net.run_epochs(1, payload_size=32)
        rep = net.era_change()
        net.run_epochs(1, payload_size=32)
        assert net.era == 1
        counts = {k: v for k, v in asdict(rep).items() if k != "phase_seconds"}
        return counts, net.pk_master.to_bytes()

    monkeypatch.delenv("HBBFT_TPU_DKG", raising=False)
    batched, batched_pk = era_change(ArrayHoneyBadgerNet, PortMock(), "batched")
    for mode in ("pernode", "anything-but-batched"):
        ref, ref_pk = era_change(RefNet, RefMock(), mode)
        port, port_pk = era_change(ArrayHoneyBadgerNet, PortMock(), mode)
        assert (port, port_pk) == (ref, ref_pk)
        for k in ("kg_parts_handled", "kg_acks_handled", "messages_delivered"):
            assert port[k] == batched[k], k
        assert port["kg_acks_handled"] == 5**3 and port_pk != batched_pk


def test_batched_encryption_ladders_equal_the_host(runs):
    """g1_mul_batch/g2_mul_batch (the epoch's batched encryption) on the
    device ladders give the host's points."""
    be = TorchBackend(device="cpu")
    be.device_combine_threshold = 2
    g = be.group
    s = [5, 2**200 + 17]
    pts1 = [g.g1(), g.g1_mul(9, g.g1())]
    pts2 = [g.g2(), g.hash_to_g2(b"ladder")]
    assert be.g1_mul_batch(s, pts1, kind="encrypt") == [g.g1_mul(a, p) for a, p in zip(s, pts1)]
    assert be.g2_mul_batch(s, pts2, kind="encrypt") == [g.g2_mul(a, p) for a, p in zip(s, pts2)]
    assert be.counters.device_dispatches == 2 and be.counters.device_seconds_encrypt > 0


def test_native_kernels_equal_numpy_and_hashlib():
    assert native.available() and native.sha256_available()
    rs = np.random.default_rng(8)
    m = rs.integers(0, 256, size=(6, 4), dtype=np.uint8)
    x = rs.integers(0, 256, size=(4, 37), dtype=np.uint8)
    want = np.zeros((6, 37), dtype=np.uint8)
    for i in range(6):
        for j in range(4):
            want[i] ^= np.array([_GF.mul(int(m[i, j]), int(v)) for v in x[j]], dtype=np.uint8)
    assert np.array_equal(native.gf256_matmul(m, x), want)

    data = rs.integers(0, 256, size=(5, 100), dtype=np.uint8)
    assert [bytes(h) for h in native.sha256_batch(data)] == [
        hashlib.sha256(row.tobytes()).digest() for row in data
    ]
    shards = [[bytes(rs.integers(0, 256, size=16, dtype=np.uint8)) for _ in range(5)]
              for _ in range(3)]
    roots = native.merkle_root_batch(np.array([[list(s) for s in sl] for sl in shards],
                                              dtype=np.uint8), 8, 2)
    assert [r.tobytes() for r in roots] == [MerkleTree(sl).root_hash for sl in shards]


def test_packed_proofs_equal_the_reference_and_the_object_path():
    """The engine's packed N² proofs: the same arrays as the reference's
    PackedProofs, the same verdicts as the per-proof objects (a corrupted
    leaf fails alone), and no packing for ragged trees."""
    rs = np.random.default_rng(9)
    n = 5
    shards = [[bytes(rs.integers(0, 256, size=24, dtype=np.uint8)) for _ in range(n)]
              for _ in range(3)]
    packed = PackedProofs.from_trees([MerkleTree(sl) for sl in shards], n)
    want = ref_merkle.PackedProofs.from_trees([ref_merkle.MerkleTree(sl) for sl in shards], n)
    for name in ("leaves", "paths", "indices", "roots"):
        assert np.array_equal(getattr(packed, name), getattr(want, name))
    proofs = [MerkleTree(sl).proof(i) for sl in shards for i in range(n)]
    assert packed.validate(reps=2) == validate_proofs(proofs, n, reps=2) == [True] * 3 * n
    leaves = packed.leaves.copy()
    leaves[7, 0] ^= 1
    bad = PackedProofs(leaves, packed.paths, packed.indices, packed.roots, n)
    assert bad.validate() == [i != 7 for i in range(3 * n)]
    ragged = [MerkleTree(shards[0]), MerkleTree(shards[1][:-1] + [b"short"])]
    assert PackedProofs.from_trees(ragged, n) is None
