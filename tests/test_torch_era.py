"""The port's era machinery against the JAX package's.

The port's ``ArrayHoneyBadgerNet`` on ``TorchBackend(device="cpu")`` and the
JAX package's engine on its host golden ``CpuBackend`` run the same N=4,
``dedup_verifies=True``, ``dynamic=True`` schedule with an era change before
the second epoch (``run_epochs(2, churn_at=[1])``).  Both draw the engine's
RNG in one order, so the batched DKG must derive the same key set on both
sides: the Batches, every report's counts, ``era``, the new
``PublicKeySet`` and every node's new secret key share are held exactly.
The era change's ``device_dispatches`` are held against the rule the
reference's device backend bills by (one per lane-capped ladder, MSM or
pairing chunk at or above the device threshold).

Also here: checkpoint → restore (byte-equal re-encoding, the same next
epoch), the DKG's two RLC checks rejecting a corrupted plaintext (the
reference's monkeypatch pattern, n=2, t=0), and the backend's device MSM
``g1_lincomb`` against the reference's host fold, a sub-threshold host
tail included.
"""

import random
from dataclasses import asdict, fields

import pytest
import torch

from hbbft_tpu.crypto.backend import CpuBackend
from hbbft_tpu.engine.array_engine import ArrayHoneyBadgerNet as RefNet
from hbbft_tpu_torch import convert
from hbbft_tpu_torch.engine import dkg_batch
from hbbft_tpu_torch.engine.array_engine import ArrayHoneyBadgerNet, EpochReport
from hbbft_tpu_torch.ops.backend import TorchBackend
from hbbft_tpu_torch.utils import canonical
from hbbft_tpu_torch.utils.snapshot import SnapshotError, save_node

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

N, SEED, EPOCHS, CHURN_AT = 4, 5, 2, [1]
_COUNTS = [f.name for f in fields(EpochReport) if f.name != "phase_seconds"]


class _MarkingBackend(TorchBackend):
    """TorchBackend that notes ``device_dispatches`` where the era change's
    device work begins (its vote check: the run's only
    ``verify_signatures``), where the DKG begins (that check's return) and
    where the turnover ends (``new_era``), and the staging cache's size
    after ``new_era`` cleared it."""

    def __init__(self, device):
        super().__init__(device=device)
        self.marks = {}

    def verify_signatures(self, items):
        self.marks["votes"] = self.counters.device_dispatches
        out = super().verify_signatures(items)
        self.marks["dkg"] = self.counters.device_dispatches
        return out

    def new_era(self, era):
        self.marks["end"] = self.counters.device_dispatches
        super().new_era(era)
        self.marks["staged_after_new_era"] = len(self._stage)


@pytest.fixture(scope="module")
def runs():
    ref = RefNet(range(N), backend=CpuBackend(), seed=SEED, dedup_verifies=True, dynamic=True)
    ref_batches = ref.run_epochs(EPOCHS, churn_at=CHURN_AT)
    net = ArrayHoneyBadgerNet(range(N), backend=_MarkingBackend("cpu"), seed=SEED,
                              dedup_verifies=True, dynamic=True)
    master0 = net.pk_master
    batches = net.run_epochs(EPOCHS, churn_at=CHURN_AT)
    return {"ref": ref, "ref_batches": ref_batches, "net": net, "batches": batches,
            "master0": master0, "reports": list(net.reports),
            "churn_reports": list(net.churn_reports), "blob": net.checkpoint()}


def _contribs(batches):
    return [{nid: b.contributions for nid, b in sorted(ep.items())} for ep in batches]


def test_batches_identical_to_the_reference(runs):
    got, want = runs["batches"], runs["ref_batches"]
    assert len(got) == EPOCHS
    for e, ep in enumerate(got):
        first = ep[0]
        assert sorted(ep) == list(range(N)) and all(b == first for b in ep.values())
        assert first.epoch == e and len(first.contributions) == N
    assert _contribs(got) == _contribs(want)


@pytest.mark.parametrize("field", _COUNTS)
def test_report_counts_equal_the_reference(runs, field):
    """Every epoch report and the churn report, field by field."""
    for mine, ref in ((runs["reports"], runs["ref"].reports),
                      (runs["churn_reports"], runs["ref"].churn_reports)):
        assert [asdict(r)[field] for r in mine] == [asdict(r)[field] for r in ref]


def test_churn_report_counts_the_whole_dkg(runs):
    (rep,) = runs["churn_reports"]
    assert (rep.kg_parts_handled, rep.kg_acks_handled, rep.ciphertexts_verified,
            rep.votes_verified, rep.rounds) == (N * N, N**3, N * N + N**3, N, 2)
    assert runs["net"].counters.messages_delivered == runs["ref"].counters.messages_delivered


def test_the_new_keys_equal_the_reference(runs):
    net, ref = runs["net"], runs["ref"]
    assert net.era == ref.era == 1
    assert net.pk_set == convert.public_key_set(ref.pk_set)
    assert net.pk_master != runs["master0"]
    assert net.threshold == ref.threshold == (N - 1) // 3
    for nid in net.ids:
        got = net.netinfos[nid].secret_key_share
        assert got.x == convert.secret_key_share(ref.netinfos[nid].secret_key_share).x
        assert net.netinfos[nid].public_key_set is net.pk_set
    assert net.pk_shares == [net.pk_set.public_key_share(i) for i in range(N)]


def _device_chunks(n: int, cap: int, threshold: int) -> int:
    """Dispatches of one lane-capped ladder or MSM batch of n items: one per
    chunk at or above the device threshold (smaller chunks run on the host)."""
    if n < threshold:
        return 0
    return sum(1 for lo in range(0, n, cap) if min(cap, n - lo) >= threshold)


def _pairing_chunks(n: int, cap: int) -> int:
    return -(-n // cap)


def test_era_dispatches_follow_the_reference_rule(runs):
    """Votes: one pairing dispatch per chunk of N (dedup) checks.  The DKG,
    in its order: commitments (n·m² ladders), row encryption (two G1 and
    one G2 ladder batches of n²), row checks (n² pairings) and decryption
    (n² ladders), the row MSM (n·m² terms), the same for the n³ acks, the
    ack MSM, and the n share-consistency ladders."""
    be = runs["net"].backend
    n, m = N, (N - 1) // 3 + 1
    cap, thr, pcap = be.device_lane_cap, be.device_combine_threshold, be.pairing_lane_cap

    def lad(k):
        return _device_chunks(k, cap, thr)

    want_dkg = (lad(n * m * m) + 3 * lad(n * n) + _pairing_chunks(n * n, pcap) + lad(n * n)
                + lad(n * m * m) + 3 * lad(n**3) + _pairing_chunks(n**3, pcap) + lad(n**3)
                + lad(n * m * m) + lad(n))
    marks = be.marks
    assert marks["dkg"] - marks["votes"] == _pairing_chunks(n, pcap) == 1
    assert marks["end"] - marks["dkg"] == want_dkg == 13
    assert marks["staged_after_new_era"] == 0
    assert be.counters.device_seconds_dkg > 0 and be.counters.signatures_verified == n


def test_checkpoint_restores_byte_equal_and_resumes(runs):
    """The snapshot after the run re-encodes byte-equal from a fresh
    backend, and the restored engine's next epoch equals the original's.
    Runs last: it moves the fixture's engine one epoch on."""
    blob = runs["blob"]
    restored = ArrayHoneyBadgerNet.restore(blob, TorchBackend(device="cpu"))
    assert restored.checkpoint() == blob
    assert (restored.era, restored.epoch, restored.pk_set) == (1, EPOCHS, runs["net"].pk_set)
    assert isinstance(restored.backend, TorchBackend) and restored.backend.group is not None
    with pytest.raises(SnapshotError, match="not ArrayHoneyBadgerNet"):
        ArrayHoneyBadgerNet.restore(save_node(restored.counters), TorchBackend(device="cpu"))
    restored.resolve_hook = lambda: None  # a callable in state: refused
    with pytest.raises(SnapshotError, match="callable in state"):
        restored.checkpoint()
    del restored.resolve_hook
    assert _contribs(restored.run_epochs(1)) == _contribs(runs["net"].run_epochs(1))


def _run_dkg_with_corruption(monkeypatch, corrupt_call: int):
    """batched_era_dkg at n=2, t=0 with _batched_decrypt's output corrupted
    on the given call (1 = row phase, 2 = ack phase): the first decoded
    integer bumped by one and re-encoded, so the ciphertext/pairing layer is
    untouched and only the RLC aggregate can catch it."""
    real = dkg_batch._batched_decrypt
    calls = {"n": 0}

    def corrupting(backend, cts, sk_xs, stats):
        out = real(backend, cts, sk_xs, stats)
        calls["n"] += 1
        if calls["n"] == corrupt_call:
            val = canonical.decode(out[0])
            val = [val[0] + 1] + val[1:] if isinstance(val, list) else val + 1
            out[0] = canonical.encode(val)
        return out

    monkeypatch.setattr(dkg_batch, "_batched_decrypt", corrupting)
    backend = TorchBackend(device="cpu")
    g = backend.group
    rng = random.Random(9)
    ids = [0, 1]
    sk_xs = {i: rng.randrange(1, g.r) for i in ids}
    pk_els = {i: g.g1_mul(sk_xs[i], g.g1()) for i in ids}
    return dkg_batch.batched_era_dkg(backend, ids, sk_xs, pk_els, 0, rng)


@pytest.mark.parametrize("call, msg", [(1, "row-commitment check failed"),
                                       (2, "ack-value check failed")])
def test_rlc_checks_reject_a_corrupted_plaintext(monkeypatch, call, msg):
    with pytest.raises(ValueError, match=msg):
        _run_dkg_with_corruption(monkeypatch, corrupt_call=call)


@pytest.mark.parametrize("terms, lane_cap, dispatches", [(7, None, 0), (8, None, 1),
                                                        (37, 16, 2)])
def test_g1_lincomb_equals_the_reference_fold(terms, lane_cap, dispatches):
    """Below the device threshold (7 terms) the seam's host default; at 8
    one device chunk; at 37 with the lane cap at 16, two device chunks and
    a 5-term host tail.  Held against the reference CpuBackend's fold."""
    be = TorchBackend(device="cpu")
    if lane_cap is not None:
        be.device_lane_cap = lane_cap
    g, ref = be.group, CpuBackend()
    rng = random.Random(terms)
    pts = [g.g1_mul(rng.randrange(1, g.r), g.g1()) for _ in range(terms)]
    scalars = [rng.randrange(0, g.r) for _ in range(terms)]
    got = be.g1_lincomb(scalars, pts)
    want = ref.g1_lincomb(scalars, [ref.group.g1_from_bytes(g.g1_to_bytes(p)) for p in pts])
    assert g.g1_to_bytes(got) == ref.group.g1_to_bytes(want)
    assert be.counters.device_dispatches == dispatches
    assert (be.counters.device_seconds_dkg > 0) == (dispatches > 0)
