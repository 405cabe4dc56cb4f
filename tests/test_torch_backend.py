"""The slice as a whole: ``TorchBackend(device="cpu")`` against the JAX
package's ``TpuBackend`` on XLA:CPU, with the same keys.

The keys are made by the JAX package and carried into the port with
``hbbft_tpu_torch.convert`` (through ints and bytes), so both sides
verify the same shares.  Shapes are the smallest of tests/test_rlc_verify.py
and tests/test_tpu_backend.py (threshold 1, buckets of 4); the reference
compiles two graphs: the (4, 4) grouped dec-share check and the 4-lane
pairing check.

* verify_dec_shares: one forged share in an RLC group of 4 — equal
  verdicts, equal ``device_dispatches`` and, with the RLC coefficients
  pinned on both sides, equal fq12 readback of the group check.
* verify_ciphertexts: equal verdicts with one tampered ciphertext.
* decrypt_shares_batch / combine_dec_shares_batch: the port's device path
  gives the shares and plaintexts the reference gives.
* the contamination-adaptive group cap: same cap, same re-partition.
"""

import itertools
import random

import numpy as np
import pytest
import torch

from hbbft_tpu.ops import fq_rns as JR, tower as JT
from hbbft_tpu.ops.backend import TpuBackend
from hbbft_tpu.utils.metrics import Counters as RefCounters
from hbbft_tpu_torch import convert
from hbbft_tpu_torch.crypto import keys as port_keys
from hbbft_tpu_torch.ops import tower as TT
from hbbft_tpu_torch.ops.backend import TorchBackend
from hbbft_tpu_torch.utils.metrics import Counters

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    rng = random.Random(77)
    ref = TpuBackend()
    sks = ref.generate_key_set(1, rng)
    pks = sks.public_keys()
    msgs = [b"grouped decryption", b"second proposer", b"third one"]
    cts = [pks.encrypt(m, rng) for m in msgs]
    return {
        "rng": rng, "ref": ref, "sks": sks, "pks": pks, "msgs": msgs, "cts": cts,
        "port_sks": convert.secret_key_set(sks), "port_pks": convert.public_key_set(pks),
        "port_cts": [convert.ciphertext(ct) for ct in cts],
    }


def test_conversion_keeps_the_keys(world):
    sks, pks, psks, ppks = world["sks"], world["pks"], world["port_sks"], world["port_pks"]
    assert ppks.to_bytes() == pks.to_bytes()
    assert psks.public_keys().to_bytes() == pks.to_bytes()
    for i in range(3):
        assert psks.secret_key_share(i).x == sks.secret_key_share(i).x
        assert convert.secret_key_share(sks.secret_key_share(i)).x == sks.secret_key_share(i).x
        assert (convert.public_key_share(pks.public_key_share(i)).to_bytes()
                == pks.public_key_share(i).to_bytes())
    for ct, pct in zip(world["cts"], world["port_cts"]):
        assert pct.to_bytes() == ct.to_bytes() and pct.digest() == ct.digest()
    share = sks.secret_key_share(2).decrypt_share_unchecked(world["cts"][0])
    assert convert.decryption_share(share).to_bytes() == share.to_bytes()
    rows = JR.from_ints([5, 7])
    t = convert.residues(rows, device="cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), rows)
    assert isinstance(psks, port_keys.SecretKeySet)


def _dec_items(world, port: bool):
    """4 same-ciphertext items, the one at index 3 forged (node 0's share
    presented for node 3)."""
    sks = world["port_sks"] if port else world["sks"]
    pks = world["port_pks"] if port else world["pks"]
    ct = (world["port_cts"] if port else world["cts"])[0]
    items = []
    for i in range(4):
        share = sks.secret_key_share(0 if i == 3 else i).decrypt_share_unchecked(ct)
        items.append((pks.public_key_share(i), ct, share))
    return items


def _pinned_scalars():
    """Deterministic stand-in for the OS-CSPRNG RLC coefficients: one
    counter per backend, so the reference's per-group draws and the
    port's single flat draw read the same sequence."""
    seq = itertools.count(0x9E3779B97F4A7C15)

    def draw(count):
        return [(next(seq) * 0x2545F4914F6CDD1D) % ((1 << 64) - 1) + 1 for _ in range(count)]

    return draw


def _capture_rlc(backend, store):
    orig = backend._dispatch_fetch

    def fetch(fn, args, kind="", items=0):
        out = orig(fn, args, kind=kind, items=items)
        if kind == "rlc_dec":
            store.append(out)
        return out

    backend._dispatch_fetch = fetch


@pytest.fixture(scope="module")
def dec_runs(world):
    """verify_dec_shares on both backends with pinned coefficients."""
    mp = pytest.MonkeyPatch()
    try:
        # the reference reads _rlc_scalars only on its per-item host arm
        mp.setenv("HBBFT_TPU_NO_HOSTPIPE", "1")
        mp.setattr(TpuBackend, "_rlc_scalars", staticmethod(_pinned_scalars()))
        mp.setattr(TorchBackend, "_rlc_scalars", staticmethod(_pinned_scalars()))
        out = {}
        for name, backend in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
            captured = []
            _capture_rlc(backend, captured)
            verdicts = backend.verify_dec_shares(_dec_items(world, name == "port"))
            c = backend.counters
            out[name] = {
                "verdicts": verdicts, "rlc": captured, "dispatches": c.device_dispatches,
                "rlc_groups": c.rlc_groups, "pairing_checks": c.pairing_checks,
                "ladder_field_muls": c.ladder_field_muls,
            }
        return out
    finally:
        mp.undo()


def test_verify_dec_shares_verdicts(dec_runs):
    assert dec_runs["port"]["verdicts"] == dec_runs["ref"]["verdicts"]
    assert dec_runs["port"]["verdicts"] == [True, True, True, False]


@pytest.mark.parametrize(
    "counter", ["dispatches", "rlc_groups", "pairing_checks", "ladder_field_muls"]
)
def test_verify_dec_shares_counters(dec_runs, counter):
    assert dec_runs["port"][counter] == dec_runs["ref"][counter]
    assert dec_runs["port"]["dispatches"] == 2  # one group check + one leaf chunk


def test_rlc_group_check_readback(dec_runs):
    """The failing group's fq12 value (and the padding groups' 1s) equal
    on both sides: same coefficients, same points, same composition."""
    (port_f,), (ref_f,) = dec_runs["port"]["rlc"], dec_runs["ref"]["rlc"]
    got = TT.fq12_to_ints_batch(port_f, 4)
    assert got == JT.fq12_to_ints_batch(ref_f, 4)
    assert got[0] != got[1] and got[1] == got[2] == got[3]


def test_verify_dec_shares_deferred_twin(world):
    port = TorchBackend(device="cpu")
    resolve = port.verify_dec_shares_deferred(_dec_items(world, True))
    d = port.counters.device_dispatches
    assert resolve() == [True, True, True, False]
    assert d >= 1 and port.counters.device_dispatches == 2


def _ct_batch(world, port: bool):
    cts = world["port_cts"] if port else world["cts"]
    Ct = port_keys.Ciphertext if port else type(cts[0])
    group = convert.group() if port else world["ref"].group
    bad = cts[1]
    tampered = Ct(group, bad.u, bytes([bad.v[0] ^ 1]) + bad.v[1:], bad.w)
    return cts + [tampered]


def test_verify_ciphertexts(world):
    port = TorchBackend(device="cpu")
    ref = TpuBackend()
    want = [True, True, True, False]
    assert port.verify_ciphertexts(_ct_batch(world, True)) == want
    assert ref.verify_ciphertexts(_ct_batch(world, False)) == want
    assert port.counters.device_dispatches == ref.counters.device_dispatches == 1
    resolve = port.verify_ciphertexts_deferred(_ct_batch(world, True))
    assert resolve() == want and port.counters.device_dispatches == 2


def test_decrypt_shares_batch(world):
    """The reference's shares (its host path at this size) against the
    port's device ladders (threshold lowered so the port dispatches)."""
    items = [(world["sks"].secret_key_share(i), ct) for ct in world["cts"][:2] for i in range(3)]
    port_items = [
        (world["port_sks"].secret_key_share(i), ct)
        for ct in world["port_cts"][:2] for i in range(3)
    ]
    ref_shares = world["ref"].decrypt_shares_batch(items)
    port = TorchBackend(device="cpu")
    port.device_combine_threshold = 2
    got = port.decrypt_shares_batch(port_items)
    assert port.counters.device_dispatches == 1
    assert [s.to_bytes() for s in got] == [s.to_bytes() for s in ref_shares]


def test_combine_dec_shares_batch(world):
    sks, psks = world["sks"], world["port_sks"]
    picks = [(0, (0, 2)), (1, (1, 2)), (2, (0, 1))]
    ref_items = [
        ({i: sks.secret_key_share(i).decrypt_share_unchecked(world["cts"][c]) for i in ix},
         world["cts"][c])
        for c, ix in picks
    ]
    port_items = [
        ({i: psks.secret_key_share(i).decrypt_share_unchecked(world["port_cts"][c]) for i in ix},
         world["port_cts"][c])
        for c, ix in picks
    ]
    want = world["ref"].combine_dec_shares_batch(world["pks"], ref_items)
    port = TorchBackend(device="cpu")
    port.device_combine_threshold = 2
    got = port.combine_dec_shares_batch(world["port_pks"], port_items)
    assert got == want == world["msgs"]
    assert port.counters.device_dispatches == 1


# -- contamination-adaptive group sizing (pure logic, both backends) ----------


@pytest.mark.parametrize(
    "window", [(0.0, 0.0), (100.0, 0.3), (100.0, 1.6), (100.0, 5.0), (100.0, 15.0),
               (100.0, 17.5), (100.0, 50.0)]
)
def test_adaptive_cap_and_split_equal_the_reference(window, monkeypatch):
    """Same observation window → same cap and the same re-partition of
    the groups (the bisection's starting structure) on both sides."""
    monkeypatch.delenv("HBBFT_TPU_NO_ADAPTIVE_RLC", raising=False)
    ref = TpuBackend.__new__(TpuBackend)
    ref.counters = RefCounters()
    port = TorchBackend.__new__(TorchBackend)
    port.counters = Counters()
    for b in (ref, port):
        b._rlc_obs_items, b._rlc_obs_rejects = window
    assert port._rlc_adaptive_cap() == ref._rlc_adaptive_cap()
    groups = [list(range(10)), list(range(10, 13)), list(range(13, 60))]
    assert port._rlc_apply_cap([list(g) for g in groups]) == ref._rlc_apply_cap(
        [list(g) for g in groups]
    )
    assert port.counters.rlc_adaptive_splits == ref.counters.rlc_adaptive_splits


def test_adaptive_window_observes_like_the_reference():
    ref = TpuBackend.__new__(TpuBackend)
    port = TorchBackend.__new__(TorchBackend)
    results = [True, False, None, True, False, True]
    for b in (ref, port):
        b._rlc_obs_items = b._rlc_obs_rejects = 0.0
        b._rlc_observe([0, 1, 3, 4, 5], results)
        b._rlc_observe([1, 4], results)
    assert (port._rlc_obs_items, port._rlc_obs_rejects) == (
        ref._rlc_obs_items, ref._rlc_obs_rejects,
    )
    assert port._rlc_observed_rate() == ref._rlc_observed_rate()


# -- the reference's env switches, end to end (same graph shapes as above) ----


def _pinned_for_width():
    """_pinned_scalars, cut to the coefficient width the backend reads."""
    base = _pinned_scalars()

    def draw(count):
        top = (1 << TorchBackend._rlc_bits()) - 1
        return [r % top + 1 for r in base(count)]

    return draw


def _dec_run(world, env, window=None):
    """verify_dec_shares on both backends under ``env``, coefficients
    pinned; the verdicts and every counter the switches move."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("HBBFT_TPU_NO_HOSTPIPE", "1")
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(TpuBackend, "_rlc_scalars", staticmethod(_pinned_for_width()))
        mp.setattr(TorchBackend, "_rlc_scalars", staticmethod(_pinned_for_width()))
        out = {}
        for name, backend in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
            if window is not None:
                backend._rlc_obs_items, backend._rlc_obs_rejects = window
            verdicts = backend.verify_dec_shares(_dec_items(world, name == "port"))
            c = backend.counters
            out[name] = (verdicts, c.device_dispatches, c.rlc_groups, c.rlc_adaptive_splits,
                         c.pairing_checks, c.ladder_field_muls)
        return out
    finally:
        mp.undo()


def test_no_adaptive_rlc_run_equals_the_reference(world):
    """HBBFT_TPU_NO_ADAPTIVE_RLC=1 with a contaminated window (cap 3 on
    the adaptive arm, which would count a split of the group of 4): both
    sides keep the group whole and count no split."""
    out = _dec_run(world, {"HBBFT_TPU_NO_ADAPTIVE_RLC": "1"}, window=(100.0, 30.0))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [True, True, True, False]
    assert out["port"][3] == 0 and out["port"][1] == 2


def test_rlc_bits_run_equals_the_reference(world):
    """HBBFT_TPU_RLC_BITS=32: 32-bit coefficients on both sides, so the
    same verdicts, dispatches and half the 64-bit ladder muls."""
    out = _dec_run(world, {"HBBFT_TPU_RLC_BITS": "32"})
    assert out["port"] == out["ref"]
    assert out["port"][0] == [True, True, True, False]
    # 16 windows of 2 doublings + 1 add, two ladders per lane, 4 items
    assert out["port"][5] == 16 * (2 * 7 + 16) * 2 * 4


def _ct_run(world, env, cap=None):
    mp = pytest.MonkeyPatch()
    try:
        for k, v in env.items():
            mp.setenv(k, v)
        if cap is not None:  # the value HBBFT_TPU_PAIR_CAP gives at import
            mp.setattr(TpuBackend, "pairing_lane_cap", cap)
            mp.setattr(TorchBackend, "pairing_lane_cap", cap)
        out = {}
        for name, backend in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
            verdicts = backend.verify_ciphertexts(_ct_batch(world, name == "port"))
            c = backend.counters
            out[name] = (verdicts, c.device_dispatches, c.pairing_checks,
                         c.stage_cache_hits, c.stage_cache_misses, backend._stage.capacity)
        return out
    finally:
        mp.undo()


def test_pair_cap_chunks_like_the_reference(world):
    """A pairing cap of 2: four ciphertext checks in two chunks (each
    padded to the 4-lane bucket) on both sides."""
    out = _ct_run(world, {}, cap=2)
    assert out["port"] == out["ref"]
    assert out["port"][:3] == ([True, True, True, False], 2, 4)


def test_stage_cap_zero_runs_like_the_reference(world):
    """HBBFT_TPU_STAGE_CAP=0: no staging cache on either side, so no hits
    and no misses are counted; the verdicts stand."""
    out = _ct_run(world, {"HBBFT_TPU_STAGE_CAP": "0"})
    assert out["port"] == out["ref"]
    assert out["port"][3:] == (0, 0, 0)
    assert out["port"][0] == [True, True, True, False]
