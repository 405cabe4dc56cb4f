"""The port's multi-device dispatch (``hbbft_tpu_torch/parallel/``:
``MeshBackend``, ``mesh.py``) on a CPU mesh, against the JAX package's
``parallel/`` and the host golden.

Every case of the reference's ``tests/test_mesh_backend.py`` runs here as a
hand-written A/B (that file compiles ``TpuBackend`` graphs on XLA:CPU, so
it is not loaded twice): bucket widening and the small-batch clamp, the
sharded share verify with a forged share, the sharded decryption round
trip, lane-capped combine chunks across the mesh, the
``HBBFT_TPU_NO_SHARD_PIPE=1`` kill-switch A/B at chunk boundaries, and the
per-device spans summing to ``device_seconds`` (through the port's
``trace_report``).  A CPU mesh of n is n entries of the one CPU device
(``device_mesh(n, device="cpu")``), the counterpart of the reference's
virtual 8-device mesh.

Sizes: the port's CPU ladder runs a chunk in about the same time whatever
its width (8.2 s for a 64-item ``sign_shares_batch`` at the reference's
cap 8, 0.5 s for 3 items), and the kill switch's sharded arm runs one
ladder a mesh entry.  So the kill-switch A/B runs on a mesh of 4 at a lane
cap of 2 (cap·n_dev = 8) with n = 7, 8, 9 items instead of the reference's
8 × cap 8 with 63, 64, 65; the combine chunks at 16 items and cap 8 (4
chunks, as the reference's 256 at cap 128); the spans over 8 items at cap
2 (4 chunks on 4 entries).  With a cap of 2 the "− 1" and "+ 1" cases'
short tail is one item, below the device threshold of 2, so it folds on
the host: 3, 4 and 4 device chunks.  To keep the file near 35 s on one
worker, the n = 7 and 9 cases (~10 and ~16 s), the sharded share verify
(~11 s: one pairing a mesh entry) and ``sharded_product2`` (~4 s; the
card's mesh phase runs it too) run behind ``-m slow``.

Also here: ``_pad_bucket`` equal to the reference's ``MeshBackend``'s for
n = 1…300 (called unbound on a stand-in mesh size), ``shard_batch`` equal
to the reference's on its virtual 8-device mesh shard by shard, a field
multiply on sharded rows, ``sharded_combine_g2`` and ``sharded_product2``
against their unsharded forms and the host group, the lazy ``parallel``
exports, ``mesh_probe``, the CLIs' ``--backend mesh``/``mesh-cpu``, and
``MeshBackend()`` taking the card.
"""

import json
import random
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.crypto import bls381 as gold
from hbbft_tpu_torch.crypto.field import Q, R
from hbbft_tpu_torch.ops import curve, fq_rns, fq_rns_cuda, pairing
from hbbft_tpu_torch.parallel import MeshBackend, device_mesh, shard_batch
from hbbft_tpu_torch.parallel.mesh import (
    entry_streams, run_sharded, sharded_combine_g2, sharded_product2,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_DEV = 4


@pytest.fixture(scope="module")
def backend():
    return MeshBackend(device_mesh(N_DEV, device="cpu"))


@pytest.fixture(scope="module")
def keyset(backend):
    rng = random.Random(13)
    sks = backend.generate_key_set(1, rng)
    return sks, sks.public_keys()


@pytest.fixture()
def rng():
    return random.Random(99)


# -- buckets and placement ---------------------------------------------------


@pytest.mark.parametrize("n_dev", (8, 6, 4, 1))
def test_pad_bucket_equals_the_reference(n_dev):
    from hbbft_tpu.parallel.backend import MeshBackend as RefMesh

    stand_in = types.SimpleNamespace(_n_dev=n_dev)
    got = [MeshBackend._pad_bucket(stand_in, n) for n in range(1, 301)]
    assert got == [RefMesh._pad_bucket(stand_in, n) for n in range(1, 301)]


def test_bucket_widens_to_mesh():
    be = MeshBackend(device_mesh(8, device="cpu"))
    # a sub-mesh-width batch keeps the single-device bucket
    assert be._pad_bucket(1) == 4 and be._pad_bucket(4) == 4
    # at and above the mesh width the bucket widens to a mesh multiple
    assert be._pad_bucket(8) == 8 and be._pad_bucket(9) == 16
    assert be._pad_bucket(64) % 8 == 0
    assert be.name == "MeshBackend[8]"
    assert MeshBackend(device_mesh(1, device="cpu")).name == "MeshBackend[1]"


def test_shard_batch_equals_the_reference():
    """Shard by shard against the reference's ``shard_batch`` on its
    virtual 8-device mesh: entry d holds the reference's device-d shard."""
    import jax

    from hbbft_tpu.parallel.mesh import device_mesh as ref_mesh, shard_batch as ref_shard

    g = np.random.default_rng(5)
    tree = ((g.integers(0, 2047, (16, 79)).astype(np.float32),
             g.integers(0, 2, 16).astype(bool)), g.integers(0, 9, (16, 2, 3)).astype(np.int32))
    mesh = ref_mesh(8)
    ref = ref_shard(jax.tree_util.tree_map(jax.numpy.asarray, tree), mesh)
    port = shard_batch(((torch.as_tensor(tree[0][0]), torch.as_tensor(tree[0][1])),
                        torch.as_tensor(tree[1])), device_mesh(8, device="cpu"))
    ref_leaves = jax.tree_util.tree_leaves(ref)
    devices = list(mesh.devices.flat)
    assert len(port) == 8
    for d in range(8):
        port_leaves = [port[d][0][0], port[d][0][1], port[d][1]]
        for pl, rl in zip(port_leaves, ref_leaves):
            (shard,) = [s for s in rl.addressable_shards if s.device == devices[d]]
            assert np.array_equal(pl.numpy(), np.asarray(shard.data))


def test_shard_batch_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        shard_batch((torch.zeros(6, 2),), device_mesh(4, device="cpu"))


def test_sharded_field_multiply_equals_the_unsharded_one():
    """A field multiply on sharded rows, concatenated in entry order, is
    the whole batch's multiply, residue for residue (the analogue of the
    reference's mesh-sharded Pallas multiply)."""
    rng = random.Random(31)
    xs = [rng.randrange(Q) for _ in range(16)]
    ys = [rng.randrange(Q) for _ in range(16)]
    a = torch.as_tensor(fq_rns.from_ints(xs))
    b = torch.as_tensor(fq_rns.from_ints(ys))
    mesh = device_mesh(N_DEV, device="cpu")
    got = run_sharded(fq_rns_cuda.mul, shard_batch((a, b), mesh), mesh, entry_streams(mesh))
    assert torch.equal(got, fq_rns_cuda.mul(a, b))
    # Montgomery form: mul(x·R, y·R) = x·y·R, from_ints/to_ints hide R
    assert fq_rns.to_ints(got) == [x * y % Q for x, y in zip(xs, ys)]


@pytest.mark.parametrize("k", (2, 3, 4))
def test_sharded_combine_g2_equals_the_unsharded_combine(k):
    """k shares over a k-entry mesh: the per-entry partial points, tree-added
    on the first entry, are the unsharded ``linear_combine_g2`` point and
    the host group's Σ λ_i·P_i (16-bit coefficients keep the CPU ladder
    short; the reduction is the same at any width)."""
    rng = random.Random(40 + k)
    shares = [gold.ec_mul(gold.FQ2, rng.randrange(1, R), gold.G2_GEN) for _ in range(k)]
    lams = [rng.randrange(1, 1 << 16) for _ in range(k)]
    bits = torch.as_tensor(curve.scalars_to_bits(lams, 16))
    negs = torch.zeros(k, dtype=torch.bool)
    pts = curve.g2_to_device(shares, device="cpu")
    sharded = sharded_combine_g2(device_mesh(k, device="cpu"))(pts, bits, negs)
    whole = curve.linear_combine_g2(pts, bits, negs)
    assert curve.g2_from_device(sharded) == curve.g2_from_device(whole)
    host = None
    for lam, p in zip(lams, shares):
        host = gold.ec_add(gold.FQ2, host, gold.ec_mul(gold.FQ2, lam, p))
    assert curve.g2_from_device(sharded)[0] == host


@pytest.mark.slow
def test_sharded_product2_equals_the_unsharded_one():
    """The data-parallel pairing product over a 2-entry mesh: the same
    fq12 values, lane for lane, as one unsharded ``product2_fast``."""
    from hbbft_tpu_torch.ops import tower

    rng = random.Random(7)
    g1, g2 = gold.G1_GEN, gold.G2_GEN
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    quads = [(gold.ec_mul(gold.FQ, a, g1), g2, gold.ec_neg(gold.FQ, g1),
              gold.ec_mul(gold.FQ2, a, g2)),
             (g1, gold.ec_mul(gold.FQ2, b, g2), gold.ec_neg(gold.FQ, g1), g2)]
    args = (pairing.g1_affine_to_device([q[0] for q in quads], device="cpu"),
            pairing.g2_affine_to_device([q[1] for q in quads], device="cpu"),
            pairing.g1_affine_to_device([q[2] for q in quads], device="cpu"),
            pairing.g2_affine_to_device([q[3] for q in quads], device="cpu"))
    got = sharded_product2(device_mesh(2, device="cpu"))(*args)
    want = pairing.product2_fast(*args)
    assert tower.fq12_to_ints_batch(got, 2) == tower.fq12_to_ints_batch(want, 2)
    assert pairing.is_one_host_batch(got, 2) == [True, False]


# -- the reference's MeshBackend cases ----------------------------------------


@pytest.mark.slow
def test_sharded_sig_share_verify(backend, keyset):
    sks, pks = keyset
    doc = b"mesh doc"
    items = [(pks.public_key_share(i), doc, sks.secret_key_share(i).sign_share(doc))
             for i in range(3)]
    bad = sks.secret_key_share(0).sign_share(b"other doc")  # one forged share
    items.append((pks.public_key_share(1), doc, bad))
    assert backend.verify_sig_shares(items) == [True, True, True, False]


def test_sharded_decrypt_roundtrip(backend, keyset, rng):
    sks, pks = keyset
    msg = b"sharded threshold decryption"
    ct = pks.encrypt(msg, rng)
    assert backend.verify_ciphertexts([ct]) == [True]
    shares = {i: sks.secret_key_share(i).decrypt_share_unchecked(ct) for i in (0, 2)}
    items = [(pks.public_key_share(i), ct, s) for i, s in shares.items()]
    assert backend.verify_dec_shares(items) == [True, True]
    backend.device_combine_threshold = 2  # force the device combine
    try:
        out = backend.combine_dec_shares_batch(pks, [(shares, ct)] * 3)
    finally:
        backend.device_combine_threshold = 8
    assert out == [msg] * 3


def test_lane_capped_chunks_across_mesh(backend, keyset, rng):
    """A combine batch above ``device_lane_cap`` splits into lane-capped
    chunks, each a mesh-multiple bucket, results correct and in order."""
    sks, pks = keyset
    items, msgs = [], []
    for j in range(16):
        msg = bytes([j % 251]) * 8
        ct = pks.encrypt(msg, rng)
        items.append(({i: sks.secret_key_share(i).decrypt_share_unchecked(ct)
                       for i in (0, 2)}, ct))
        msgs.append(msg)
    d0 = backend.counters.device_dispatches
    saved = backend.device_lane_cap, backend.device_combine_threshold
    backend.device_combine_threshold = 2
    backend.device_lane_cap = 8  # k=2 → 4 items a chunk → 4 chunks
    try:
        got = backend.combine_dec_shares_batch(pks, items)
    finally:
        backend.device_lane_cap, backend.device_combine_threshold = saved
    assert got == msgs
    assert backend.counters.device_dispatches == d0 + 4
    assert backend._pad_bucket(4) % N_DEV == 0


@pytest.mark.parametrize("n", (
    pytest.param(7, marks=pytest.mark.slow), 8, pytest.param(9, marks=pytest.mark.slow)))
def test_shard_killswitch_ab_at_chunk_boundaries(backend, keyset, monkeypatch, n):
    """The per-entry run and the ``HBBFT_TPU_NO_SHARD_PIPE=1`` sharded run
    give bit-identical shares, equal to the host golden, with conserved
    ``device_dispatches``, at cap·n_dev − 1, cap·n_dev and cap·n_dev + 1
    (a one-item tail folds on the host); the chunks land round-robin on
    consecutive entries and the kill switch reserves none."""
    sks, _ = keyset
    doc = b"shard ab doc"
    items = [(sks.secret_key_share(i % 3), doc) for i in range(n)]
    golden = [sk.sign_share(d) for sk, d in items]
    chunks = n // 2  # cap 2, a one-item tail on the host
    saved = backend.device_lane_cap, backend.device_combine_threshold
    backend.device_lane_cap = 2  # cap·n_dev = 8
    backend.device_combine_threshold = 2
    try:
        monkeypatch.delenv("HBBFT_TPU_NO_SHARD_PIPE", raising=False)
        p0 = len(backend._pipe.placements)
        d0 = backend.counters.device_dispatches
        sharded = backend.sign_shares_batch(items)
        placements = backend._pipe.placements[p0:]
        disp_sharded = backend.counters.device_dispatches - d0
        monkeypatch.setenv("HBBFT_TPU_NO_SHARD_PIPE", "1")
        p1 = len(backend._pipe.placements)
        d1 = backend.counters.device_dispatches
        single = backend.sign_shares_batch(items)
        disp_single = backend.counters.device_dispatches - d1
    finally:
        backend.device_lane_cap, backend.device_combine_threshold = saved
    assert single == sharded == golden
    assert disp_single == disp_sharded == chunks
    assert len(backend._pipe.placements) == p1  # the kill switch reserves nothing
    assert len(placements) == chunks
    assert placements == [(placements[0] + i) % N_DEV for i in range(chunks)]


def test_small_batch_clamps_to_single_device(keyset, monkeypatch):
    """A 3-item ladder pads to the 4-lane minimum bucket, not to the
    8-entry mesh, and rides ONE entry whole in both arms (the sharded arm
    routes a bucket the mesh does not divide to the first entry)."""
    be = MeshBackend(device_mesh(8, device="cpu"))
    sks, _ = keyset
    doc = b"small batch"
    items = [(sks.secret_key_share(i), doc) for i in range(3)]
    golden = [sk.sign_share(d) for sk, d in items]
    be.device_combine_threshold = 2
    monkeypatch.delenv("HBBFT_TPU_NO_SHARD_PIPE", raising=False)
    assert be.sign_shares_batch(items) == golden
    assert be.counters.device_dispatches == 1
    assert len(be._pipe.placements) == 1  # one whole chunk
    monkeypatch.setenv("HBBFT_TPU_NO_SHARD_PIPE", "1")
    placed = be._place((torch.zeros(4, 2),))
    assert isinstance(placed, tuple) and placed[0].shape == (4, 2)  # not split
    assert be.sign_shares_batch(items) == golden
    assert be._pad_bucket(3) == 4


def test_per_device_spans_sum_to_device_seconds(backend, keyset, tmp_path):
    """Every placed dispatch spans its entry's ``device/<n>`` track, and
    the per-entry partition sums to ``counters.device_seconds`` within ±5%
    (the port's ``trace_report.check_per_device_seconds`` and its CLI)."""
    from hbbft_tpu_torch.obs import Tracer
    from hbbft_tpu_torch.tools.trace_report import (
        check_per_device_seconds, load_events, main as tr_main, validate_chrome_trace,
    )

    sks, _ = keyset
    items = [(sks.secret_key_share(i % 3), b"per-device") for i in range(8)]
    backend.tracer = Tracer()
    saved = backend.device_lane_cap, backend.device_combine_threshold
    backend.device_lane_cap = 2  # 4 chunks on 4 entries
    backend.device_combine_threshold = 2
    d0 = backend.counters.device_seconds
    try:
        assert len(backend.sign_shares_batch(items)) == 8
    finally:
        backend.device_lane_cap, backend.device_combine_threshold = saved
        tr = backend.tracer
        backend.tracer = None
    dev = backend.counters.device_seconds - d0
    path = str(tmp_path / "shard_trace.json")
    tr.write(path)
    events = load_events(path)
    assert validate_chrome_trace(events) == []
    ok, per = check_per_device_seconds(events, dev)
    assert ok, (per, dev)
    assert len([t for t in per if t.startswith("device/")]) >= N_DEV
    assert tr_main([path, "--device-seconds", str(dev)]) == 0


def test_killswitch_plane_equals_the_torch_backend(backend, monkeypatch):
    """Under ``HBBFT_TPU_NO_SHARD_PIPE=1`` the RS/Merkle plane's inputs are
    not one batch axis (the GF product's matrix and data) or shard evenly
    (the trees, the proofs): the encodes run whole, the tree builds and
    proof walks sharded, every value ``TorchBackend``'s."""
    from hbbft_tpu_torch.crypto.erasure import RSCodec
    from hbbft_tpu_torch.crypto.merkle import PackedProofs
    from hbbft_tpu_torch.ops.backend import TorchBackend

    monkeypatch.setenv("HBBFT_TPU_NO_SHARD_PIPE", "1")
    plain = TorchBackend(device="cpu")
    codec = RSCodec(2, 2)
    datas = [bytes(range(j, j + 13)) for j in range(4)]
    enc = backend.rs_encode_batch(codec, datas)
    assert enc == plain.rs_encode_batch(codec, datas)
    trees = backend.merkle_build_batch(enc)
    assert [t.root_hash for t in trees] == [t.root_hash for t in plain.merkle_build_batch(enc)]
    packed = PackedProofs.from_trees(trees, 4, device=True)
    assert backend.merkle_verify_batch(packed) == plain.merkle_verify_batch(packed) == [True] * 16


def test_shard_stats_and_the_torch_backend_values(backend, keyset):
    """The per-entry tallies sum to the placements; on one entry the
    backend's values and dispatches are ``TorchBackend``'s."""
    from hbbft_tpu_torch.ops.backend import TorchBackend

    st = backend.shard_stats()
    assert st["shard_devices"] == N_DEV
    assert sum(st["shard_dispatches"]) == st["shard_placements"] == len(backend._pipe.placements)
    sks, _ = keyset
    items = [(sks.secret_key_share(i % 3), b"one entry") for i in range(9)]
    one, plain = MeshBackend(device_mesh(1, device="cpu")), TorchBackend(device="cpu")
    for be in (one, plain):
        be.device_combine_threshold = 2
    assert one.sign_shares_batch(items) == plain.sign_shares_batch(items)
    assert one.counters.device_dispatches == plain.counters.device_dispatches == 1
    assert one.shard_stats()["shard_dispatches"] == [1]
    assert one.shard_stats()["shard_imbalance"] == 1.0


# -- defaults, the lazy package, the tools ------------------------------------


def test_mesh_backend_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshBackend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        device_mesh(2, device="cuda")
    assert device_mesh(3, device="cpu") == [torch.device("cpu")] * 3


def test_parallel_exports_are_lazy():
    """``hbbft_tpu_torch.parallel.shardpipe`` imports no torch through the
    package init; the lazy names resolve to the modules' objects."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; import hbbft_tpu_torch.parallel.shardpipe as s; "
         "import hbbft_tpu_torch.parallel as p; "
         "print('torch' in sys.modules, p.shardpipe_enabled is s.shardpipe_enabled)"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True"]
    import hbbft_tpu_torch.parallel as par

    assert sorted(par.__all__) == sorted(["MeshBackend", "BATCH_AXIS", "device_mesh",
                                          "shard_batch", "sharded_combine_g2",
                                          "sharded_product2", "ShardedDispatchPipeline",
                                          "placement_policy", "shardpipe_enabled"])
    with pytest.raises(AttributeError):
        par.no_such_name  # noqa: B018


@pytest.mark.parametrize("k", (1, 4))
def test_mesh_probe_on_the_cpu(k):
    from hbbft_tpu_torch.tools import mesh_probe

    res = mesh_probe.probe(k, chunks=10, lanes=64, device="cpu")
    assert res["placements_ok"] and res["balanced"] and res["results_ok"]
    assert res["dev_dispatches"] == [10 // k + (d < 10 % k) for d in range(k)]
    assert res["chunks_per_s_is"] == "structural"


def test_cli_mesh_backends(capsys, monkeypatch):
    """``--backend mesh`` (the card) and ``mesh-cpu`` in both CLIs: the card
    form raises here, the CPU form builds a ``MeshBackend`` over CPU entries
    and the simulation hands its ``shard_stats`` to the heartbeat."""
    from hbbft_tpu_torch.tools import simulation, soak

    be = simulation.make_backend("mesh-cpu")
    assert be.name == f"MeshBackend[{simulation.MESH_CPU_ENTRIES}]"
    assert {d.type for d in be.mesh} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulation.make_backend("mesh")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulation.main(["-n", "4", "-f", "1", "--epochs", "0", "--backend", "mesh"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            soak.main(["--backend", "mesh", "--cells", "passive:uniform"])
    reporters = []
    real = simulation.HealthReporter

    def spy(*args, **kwargs):
        reporters.append(real(*args, **kwargs))
        return reporters[-1]

    monkeypatch.setattr(simulation, "HealthReporter", spy)
    assert simulation.main(["-n", "4", "-f", "1", "--epochs", "0", "--backend", "mesh-cpu",
                            "--heartbeat", "5"]) == 0
    assert "backend=mesh-cpu " in capsys.readouterr().out
    (health,) = reporters
    assert health.shard_stats_fn() == {
        "shard_devices": simulation.MESH_CPU_ENTRIES,
        "shard_dispatches": [0] * simulation.MESH_CPU_ENTRIES,
        "shard_seconds": [0.0] * simulation.MESH_CPU_ENTRIES,
        "shard_imbalance": 0.0, "shard_placements": 0}
