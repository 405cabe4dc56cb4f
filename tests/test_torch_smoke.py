"""chip_smoke.py without the card: it refuses to run (no result line, a
non-zero exit), and its main-path phase drives the port correctly at a
tiny size on the CPU backend (the same code the card runs at N=100)."""

import importlib.util
import json
import random
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.crypto.keys import Ciphertext
from hbbft_tpu_torch.ops import fq_rns, fq_rns_cuda
from hbbft_tpu_torch.ops.backend import TorchBackend

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_without_the_card(smoke, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "needs the card" in out


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_lazy_rows_carry_their_values(smoke):
    rows, vals = smoke.lazy_rows(random.Random(3), 50, fq_rns)
    assert rows.shape == (50, fq_rns.NLIMBS) and len(vals) == 50
    assert fq_rns.to_ints(rows) == vals
    assert all(0 <= v < Q for v in vals)


def test_bound_model(smoke):
    assert smoke.MUL_EW_OPS_REDUCED == 4250 and smoke.MUL_EW_OPS == 4882
    assert smoke.MUL_TC_OPS == 25600
    # one product per lane moves 3 rows: memory is the bound
    ms, by = smoke.bound(1 << 17, 1, smoke.MUL_EW_OPS, 3)
    assert by == "bytes" and ms == pytest.approx((1 << 17) * 3 * 316 / 3.35e12 * 1e3)
    # the Fermat chain does ~570 products on 2 rows: operations are
    ms, by = smoke.bound(4096, 570, 570 * smoke.MUL_EW_OPS_REDUCED, 2)
    assert by == "operations" and ms > 0
    # the tensor cores and the float32 pipe overlap: the longer of the two
    ms, by = smoke.roofline(0, 67e9, 1979e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = smoke.roofline(0, 67e9, 2 * 1979e9)
    assert ms == pytest.approx(2.0)
    # the integer pipe: a quarter of the float32 rate, ~16.7 T ops/s
    ms, by = smoke.roofline(0, 67e9, 0, int_ops=2 * 16.75e9)
    assert by == "operations" and ms == pytest.approx(2.0)
    assert smoke.SHA_OPS == 1384 and smoke.gf_ops(34) == 12  # LOP3 and IADD3: one op each
    assert (smoke.RS_K, smoke.RS_M) == (34, 66)


def test_rs_plane_checks_and_rows_at_a_tiny_size(smoke, capsys, monkeypatch):
    """The plane's kernel checks (phase 2's edges at the epoch's codec) and
    its rows at the shapes of an N=4 epoch, on the CPU (the wrappers run
    the plain versions; the device timer is stubbed out)."""
    errs: dict = {}
    smoke.check_rs_plane_kernels("cpu", random.Random(5), errs)
    assert set(errs) == {"sha256_tagged", "gf256_matmul"} and not any(errs.values())
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps=7: (fn(), 0.0)[1])
    launches = {"sha256_tagged": 3, "sha256_proofs": 5, "gf256_matmul": 1}
    lanes = {"sha256_tagged": 3 * 8, "sha256_proofs": 5 * 16, "gf256_matmul": 4 * 9}
    rows = smoke.rs_plane_rows("cpu", random.Random(6), errs, launches, lanes, n=4)
    assert [r["name"] for r in rows] == ["gf256_matmul", "sha256_tagged", "sha256_proofs"]
    for r in rows:
        assert r["route"] == "cuda" and r["launches"] == launches[r["name"]]
        assert r["bound_ms"] > 0 and r["max_abs_err"] == 0.0 and r["library_ms"] is None
    assert [r["lanes"] for r in rows] == [36, 8, 16]
    out = capsys.readouterr().out
    assert "same bits: False" not in out and "equal the host's native walk" in out
    assert "every level equal to the host MerkleTree's" in out
    json.dumps(rows)


def test_rs_kill_switch_epoch_at_a_tiny_size(smoke, capsys):
    """Phase 4's plane arm and its kill-switch epoch at N=4 on the CPU: the
    same Batch and counts, 3 + N plane dispatches fewer, no plane work."""
    plane = smoke.phase_epoch(TorchBackend(device="cpu"), 0, 4, 1, "cpu")
    assert plane["device_seconds"]["rs_enc"] > 0 and plane["device_seconds"]["merkle"] > 0
    res = smoke.phase_rs_kill_switch(0, 4, plane, "cpu", device="cpu")
    assert res["plane_dispatches"] == 7
    (off,) = res["epochs"]
    assert off["batch"] == plane["epochs"][0]["batch"]
    assert off["counters"]["device_seconds_merkle"] == 0
    assert "rs_enc" not in res["device_seconds"] and "merkle" not in res["device_seconds"]
    assert "the plane arm's Batch and counts" in capsys.readouterr().out
    json.dumps(res)


def test_main_phase_at_a_tiny_size(smoke, capsys):
    backend = TorchBackend(device="cpu")
    fq_rns_cuda.reset_launches()
    phases = []

    @contextmanager
    def wrap(name):
        phases.append(name)
        yield

    res = smoke.phase_main(backend, random.Random(0), 4, 1, 48, 12, 2, wrap=wrap)
    out = capsys.readouterr().out
    assert phases == list(res["seconds"]) == [
        "host_setup", "verify_ciphertexts", "decrypt_shares_batch", "verify_dec_shares",
        "combine_dec_shares_batch",
    ]
    assert res["verify_items"] == 48 and res["forged_items"] == 6 and res["combines"] == 12
    assert "all rejected" in out and "every plaintext equal" in out
    assert backend.counters.device_dispatches > 0
    # CPU tensors run the plain versions: no kernel launches are counted
    assert fq_rns_cuda.mul.launches == 0 and fq_rns_cuda.pow_fixed.launches == 0
    json.dumps(res)  # the phase result is what the script prints as JSON


def test_stacked_arm_and_epoch_phases_at_a_tiny_size(smoke, capsys):
    """Phase 3's stacked-arm pass and phase 4's whole epochs, on the CPU
    backend at N=4 (the card runs the same code at N=100)."""
    state: dict = {}
    smoke.phase_main(TorchBackend(device="cpu"), random.Random(1), 4, 1, 12, 4, 0, keep=state)
    res = smoke.phase_stacked_arm(state, 12, device="cpu")
    assert {k: res[k] for k in ("ciphertexts", "dec_items")} == {"ciphertexts": 5, "dec_items": 12}
    assert res["dec_seconds"]["fused"] > 0 and res["dec_seconds"]["stacked"] > 0
    backend = TorchBackend(device="cpu")
    ep = smoke.phase_epoch(backend, 0, 4, 1, "cpu")
    out = capsys.readouterr().out
    assert "equal the fused arm" in out and "same Batch of 4 contributions" in out
    (only,) = ep["epochs"]
    assert only["report"]["dec_shares_verified"] == 4 * 4 * 3 and only["seconds"] > 0
    assert ep["device_seconds"]["fused_chain"] > 0 and ep["device_dispatches"] > 0
    json.dumps(ep)


def test_sig_path_at_a_tiny_size(smoke, capsys):
    """The sig path on phase 3's keys, on the CPU backend at N=4 (the card
    runs the same code at N=100; the coin epoch's engine path is held at
    N=4 by tests/test_torch_engine.py)."""
    backend = TorchBackend(device="cpu")
    sks = backend.generate_key_set(1, random.Random(2))
    pks = sks.public_keys()
    state = {"n": 4, "f": 1, "pks": pks,  # the keys phase_main keeps
             "sk_shares": [sks.secret_key_share(i) for i in range(4)],
             "pk_shares": [pks.public_key_share(i) for i in range(4)]}
    res = smoke.phase_sig(backend, random.Random(3), state, 24, 1, "cpu")
    out = capsys.readouterr().out
    assert list(res["seconds"]) == ["sign_shares_batch", "verify_sig_shares",
                                    "combine_sig_shares_batch", "verify_signatures"]
    assert (res["signs"], res["verify_items"], res["forged_items"], res["combines"],
            res["signatures"]) == (16, 24, 3, 16, 5)
    assert "all rejected" in out and "1 tampered rejected" in out
    assert backend.counters.device_seconds_sign > 0 and backend.counters.rlc_groups > 0
    json.dumps(res)


def test_limb_arm_payload_roundtrip(smoke):
    """The limb arm's file carries phase 3's objects to the child intact:
    the key set, secret shares, ciphertexts (the tampered one too), the
    RNS arm's shares, the verify items with their repeated objects, and
    the combine items as phase_main builds them."""
    rng = random.Random(4)
    group = TorchBackend(device="cpu").group
    n, f = 3, 1
    sks = TorchBackend(device="cpu").generate_key_set(f, rng)
    pks = sks.public_keys()
    sk_shares = [sks.secret_key_share(i) for i in range(n)]
    pk_shares = [pks.public_key_share(i) for i in range(n)]
    cts = [pks.encrypt(b"proposer %d" % p, rng) for p in range(n)]
    cts.append(Ciphertext(group, cts[0].u, bytes([cts[0].v[0] ^ 1]) + cts[0].v[1:], cts[0].w))
    gen = [sk.decrypt_share_unchecked(ct) for ct in cts[:n] for sk in sk_shares]
    distinct = [(pk_shares[s], cts[p], gen[p * n + s]) for p in range(2) for s in range(n)]
    state = {"n": n, "f": f, "combines": 4, "pks": pks, "sk_shares": sk_shares,
             "pk_shares": pk_shares, "cts": cts, "gen": gen,
             "items": [it for it in distinct for _ in range(n - 1)]}
    got = smoke.limb_arm_unpack(json.loads(json.dumps(smoke.limb_arm_payload(state, 10))), group)

    def enc(item):
        return tuple(x.to_bytes() for x in item)

    assert got["pks"].to_bytes() == pks.to_bytes()
    assert [sk.x for sk in got["sk_shares"]] == [sk.x for sk in sk_shares]
    assert got["cts"] == cts and got["gen"] == gen
    assert [enc(it) for it in got["items"]] == [enc(it) for it in state["items"][:10]]
    assert len({id(it) for it in got["items"]}) == 5  # each distinct item once
    assert [({i: s.to_bytes() for i, s in ch.items()}, ct) for ch, ct in got["combine_items"]] == [
        ({i: gen[p * n + i].to_bytes() for i in range(f + 1)}, cts[p]) for p in range(n)]


def test_era_phase_at_a_tiny_size(smoke, capsys):
    """The era phase and the device MSM's checks on the CPU backend at N=4
    (the card runs the same code at N=32, and at N=100 with ``--era-n``):
    the churn counts, the new era, the restored engine, the sampled host
    split; ``g1_lincomb`` with the lane cap at 16 (37 terms: two device
    chunks and a host tail)."""
    res = smoke.phase_era(3, 4, "cpu", device="cpu")
    era = res["era_change"]
    rep = era["report"]
    assert (rep["kg_parts_handled"], rep["kg_acks_handled"], rep["ciphertexts_verified"],
            rep["votes_verified"]) == (16, 64, 80, 12)
    assert era["device_seconds"]["dkg"] > 0 and era["device_dispatches"] == 14
    assert era["host_samples"] and len(res["epoch_seconds"]) == 2
    assert res["checkpoint"]["bytes"] > 0
    lin = smoke.check_lincomb(4, "cpu", device="cpu", lane_cap=16)
    assert (lin["terms"], lin["dispatches"]) == (37, 2)
    out = capsys.readouterr().out
    assert "re-encodes byte-equal" in out and "equals the host fold at 64 terms" in out
    json.dumps(res)


def test_object_phase_at_a_tiny_size(smoke, capsys):
    """The object runtime's phase at N=4, f=1, seed 11, one epoch, on
    ``TorchBackend(device="cpu")`` (the kernels' plain versions): real-
    crypto HoneyBadger over VirtualNet gives the port's MockBackend run's
    Batch, its 348 deliveries and cranks and its work counts (the JAX
    package's MockBackend and CpuBackend agree at this shape); the host
    split covers the epoch and the timed functions are restored after."""
    from hbbft_tpu_torch.crypto.keys import PublicKeySet, SecretKeyShare

    timed = (PublicKeySet.encrypt, PublicKeySet.public_key_share,
             SecretKeyShare.decrypt_share_unchecked)
    res = smoke.phase_object(11, "cpu", device="cpu", shapes=((4, 1, 1),))
    assert timed == (PublicKeySet.encrypt, PublicKeySet.public_key_share,
                     SecretKeyShare.decrypt_share_unchecked)
    (sh,) = res["shapes"]
    real, mock = sh["torch"], sh["mock"]
    (ep,), (mep,) = real["epochs"], mock["epochs"]
    assert (ep["messages_delivered"], ep["cranks"], ep["proposals"]) == (348, 348, 4)
    assert ep["batch"] == mep["batch"] and real["faulty"] == mock["faulty"] == [1]
    assert real["counters"] == mock["counters"]
    assert (real["counters"]["ciphertexts_verified"], real["counters"]["dec_shares_verified"],
            real["counters"]["dec_shares_combined"]) == (16, 36, 32)
    assert ep["device_dispatches"] > 0 and mep["device_dispatches"] == 0
    calls = ep["host_calls"]
    assert (calls["encrypt"], calls["dec_share"], calls["combine_decryption_shares"]) == (4, 16, 16)
    assert calls["key_share"] == 36  # one per share checked
    assert ep["host_seconds"]["rest"] >= 0 and ep["host_seconds"]["backend"] > 0
    assert "TorchBackend equals MockBackend epoch for epoch" in capsys.readouterr().out
    json.dumps(res)


def test_object_contributions_are_distinct(smoke):
    txs = smoke.object_contributions(random.Random(0), 4, 10)
    flat = [tx for ep in txs for node in ep.values() for tx in node]
    assert len(txs) == 10 and all(len(node) == 25 for ep in txs for node in ep.values())
    assert len(set(flat)) == len(flat) == 1000 and {len(tx) for tx in flat} == {10}
