"""The port's array engine against the JAX package's, and the port's native
host kernels against numpy/hashlib.

The port's ``ArrayHoneyBadgerNet`` on ``TorchBackend(device="cpu")`` (the
fused chain's plain versions, the RLC grouped checks, the ladders) runs
the same N=4, ``dedup_verifies=True``, 2-epoch schedule as the JAX
package's engine on its host golden ``CpuBackend`` (as
tests/test_array_engine.py runs it): the Batches must be identical and
every count field of every ``EpochReport`` equal.  A run under
``HBBFT_TPU_NO_HOSTPIPE=1`` must give the same Batches and dispatches,
and the options this slice does not carry must raise.
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

N, SEED, EPOCHS = 4, 3, 2
_COUNTS = [f.name for f in fields(EpochReport) if f.name != "phase_seconds"]


def _port_run(hostpipe: bool):
    old = os.environ.pop("HBBFT_TPU_NO_HOSTPIPE", None)
    if not hostpipe:
        os.environ["HBBFT_TPU_NO_HOSTPIPE"] = "1"
    try:
        net = ArrayHoneyBadgerNet(range(N), backend=TorchBackend(device="cpu"), seed=SEED,
                                  dedup_verifies=True)
        return net, net.run_epochs(EPOCHS)
    finally:
        os.environ.pop("HBBFT_TPU_NO_HOSTPIPE", None)
        if old is not None:
            os.environ["HBBFT_TPU_NO_HOSTPIPE"] = old


@pytest.fixture(scope="module")
def runs():
    ref = RefNet(range(N), backend=CpuBackend(), seed=SEED, dedup_verifies=True)
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
    assert set(runs["net"].reports[-1].phase_seconds) == {"rbc", "ba", "decrypt"}


def test_no_hostpipe_gives_the_same_batches(runs):
    net, batches = _port_run(hostpipe=False)
    assert _contribs(batches) == _contribs(runs["batches"])
    assert net.backend.counters.device_dispatches == runs["net"].backend.counters.device_dispatches


def test_unported_options_raise(runs):
    net = runs["net"]
    with pytest.raises(NotImplementedError, match="slice 3"):
        ArrayHoneyBadgerNet(range(N), backend=net.backend, coin_rounds=1)
    with pytest.raises(NotImplementedError, match="slice 4"):
        ArrayHoneyBadgerNet(range(N), backend=net.backend, dynamic=True)
    for call in (net.era_change, net.checkpoint, lambda: ArrayHoneyBadgerNet.restore(b"", None)):
        with pytest.raises(NotImplementedError, match="slice 4"):
            call()


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
