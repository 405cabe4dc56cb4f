"""The signature/coin side of the port's backend against the JAX package's
``TpuBackend`` on XLA:CPU, with the same keys (threshold 1, four signers).

The keys are made by the JAX package and carried into the port with
``hbbft_tpu_torch.convert``.  Each reference graph is called at one shape
only, so each compiles once: the (4, 4) grouped sig-share check
(``_jitted_rlc_sig``), the 4-lane pairing check and the (4, 2) G2
Lagrange combine; the G2 sign ladder and the single combines are held
against the reference's host results and its host-side billing.  The RLC coefficients are pinned on both
sides where the group check's value is read back.  Tolerance is exact
throughout: verdicts, points and counters.

* verify_sig_shares: two RLC groups (one holding a forged share), one
  direct group; its deferred twin; the stacked arm
  (``HBBFT_TPU_NO_FUSED_TOWER=1``).
* verify_signatures with one tampered signature.
* sign_shares_batch at the device threshold.
* combine_sig_shares_batch with and without a doc, in both hostpipe arms;
  the single combines with the device threshold lowered.
* the native hash-to-G2 against the pure path, and its kill switch.
"""

import itertools
import random

import numpy as np
import pytest
import torch

from hbbft_tpu import native as ref_native
from hbbft_tpu.ops import curve as ref_curve, tower as JT
from hbbft_tpu.ops.backend import TpuBackend
from hbbft_tpu_torch import convert, native
from hbbft_tpu_torch.crypto import bls381
from hbbft_tpu_torch.crypto.field import lagrange_coeffs_at_zero
from hbbft_tpu_torch.crypto.keys import Signature
from hbbft_tpu_torch.ops import backend as port_backend, tower as TT
from hbbft_tpu_torch.ops.backend import TorchBackend

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

SIGNERS = 4
DOCS = [b"coin 0 round 0", b"coin 1 round 0", b"coin 2 round 0"]
#: the counters a verification moves; the fused-chain ones are compared
#: in their own tests (the reference takes the stacked chain on XLA:CPU)
VERIFY_COUNTERS = ("device_dispatches", "rlc_groups", "pairing_checks", "sig_shares_verified",
                   "ladder_field_muls", "stage_cache_hits", "stage_cache_misses")
COMBINE_COUNTERS = ("device_dispatches", "sig_shares_combined", "ladder_field_muls",
                    "glv_decompositions", "glv_table_field_muls", "stage_cache_hits",
                    "stage_cache_misses", "pairing_checks")


@pytest.fixture(scope="module")
def world():
    rng = random.Random(91)
    sks = TpuBackend().generate_key_set(1, rng)
    pks = sks.public_keys()
    psks = convert.secret_key_set(sks)
    shares = {d: [sks.secret_key_share(i).sign_share(d) for i in range(SIGNERS)] for d in DOCS}
    return {
        "sks": sks, "pks": pks, "shares": shares,
        "port_sks": psks, "port_pks": convert.public_key_set(pks),
        "port_shares": {d: [convert.signature_share(s) for s in v] for d, v in shares.items()},
    }


def _side(world, port: bool):
    if port:
        return world["port_sks"], world["port_pks"], world["port_shares"]
    return world["sks"], world["pks"], world["shares"]


def _verify_items(world, port: bool):
    """Doc 0: signers 0-3, signer 3's slot holding signer 0's share (a
    forgery); doc 1: signers 0-2; doc 2: signers 1-2 (below the RLC
    group minimum: direct checks)."""
    _, pks, shares = _side(world, port)
    items = []
    for i in range(SIGNERS):
        items.append((pks.public_key_share(i), DOCS[0], shares[DOCS[0]][0 if i == 3 else i]))
    for i in range(3):
        items.append((pks.public_key_share(i), DOCS[1], shares[DOCS[1]][i]))
    for i in (1, 2):
        items.append((pks.public_key_share(i), DOCS[2], shares[DOCS[2]][i]))
    return items


WANT = [True, True, True, False, True, True, True, True, True]


def _pinned_scalars():
    """Deterministic stand-in for the OS-CSPRNG RLC coefficients: one
    counter per backend, so the reference's per-group draws and the
    port's single flat draw read the same sequence."""
    seq = itertools.count(0x9E3779B97F4A7C15)

    def draw(count):
        return [(next(seq) * 0x2545F4914F6CDD1D) % ((1 << 64) - 1) + 1 for _ in range(count)]

    return draw


def _counters(backend, names):
    return {k: getattr(backend.counters, k) for k in names}


@pytest.fixture(scope="module")
def verify_runs(world):
    """verify_sig_shares on both backends, coefficients pinned (the
    reference reads ``_rlc_scalars`` on its per-item host arm, so the run
    is under HBBFT_TPU_NO_HOSTPIPE=1), with the group checks' values
    captured."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("HBBFT_TPU_NO_HOSTPIPE", "1")
        mp.setattr(TpuBackend, "_rlc_scalars", staticmethod(_pinned_scalars()))
        mp.setattr(TorchBackend, "_rlc_scalars", staticmethod(_pinned_scalars()))
        out = {}
        for name, backend in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
            captured = []
            orig = backend._dispatch_fetch

            def fetch(fn, args, kind="", items=0, orig=orig, captured=captured):
                res = orig(fn, args, kind=kind, items=items)
                if kind == "rlc_sig":
                    captured.append(res)
                return res

            backend._dispatch_fetch = fetch
            verdicts = backend.verify_sig_shares(_verify_items(world, name == "port"))
            out[name] = {"verdicts": verdicts, "rlc": captured, "backend": backend,
                         "counters": _counters(backend, VERIFY_COUNTERS)}
        return out
    finally:
        mp.undo()


def test_conversion_keeps_the_signatures(world):
    for d in DOCS:
        for s, ps in zip(world["shares"][d], world["port_shares"][d]):
            assert ps.to_bytes() == s.to_bytes()
            assert convert.signature(s).to_bytes() == s.to_bytes()
    sig = world["pks"].combine_signatures({0: world["shares"][DOCS[0]][0],
                                           1: world["shares"][DOCS[0]][1]})
    psig = convert.signature(sig)
    assert isinstance(psig, Signature) and psig.parity() == sig.parity()


def test_verify_sig_shares_verdicts(verify_runs):
    assert verify_runs["port"]["verdicts"] == verify_runs["ref"]["verdicts"] == WANT


@pytest.mark.parametrize("counter", VERIFY_COUNTERS)
def test_verify_sig_shares_counters(verify_runs, counter):
    """Same counts, staging counters included (both sides convert every
    lane under HBBFT_TPU_NO_HOSTPIPE=1): one group check, one direct
    chunk, one leaf chunk."""
    assert verify_runs["port"]["counters"][counter] == verify_runs["ref"]["counters"][counter]
    assert verify_runs["port"]["counters"]["device_dispatches"] == 3


def test_rlc_sig_readback_equals_the_reference(verify_runs):
    """``_rlc_sig`` against ``_jitted_rlc_sig`` on the same points and
    coefficients: the failing group's fq12 value, the passing group's
    and the padding groups' 1s are equal on both sides."""
    (port_f,), (ref_f,) = verify_runs["port"]["rlc"], verify_runs["ref"]["rlc"]
    got = TT.fq12_to_ints_batch(port_f, 4)
    assert got == JT.fq12_to_ints_batch(ref_f, 4)
    assert got[0] != got[1] and got[1] == got[2] == got[3]


def test_the_fused_chain_bills_as_the_reference(verify_runs):
    """The port's fused arm bills what the reference's ``_bill_chain``
    bills for a fused dispatch of the same lanes (the reference itself
    takes the stacked chain on XLA:CPU)."""
    port = verify_runs["port"]["backend"].counters
    want = TpuBackend()
    for _ in range(port.device_dispatches):
        want._bill_chain("native", 4)
    for k in ("fused_tower_calls", "fused_chain_pallas_calls", "fused_chain_field_muls",
              "stacked_chain_pallas_calls"):
        assert getattr(port, k) == getattr(want.counters, k)
    assert verify_runs["ref"]["backend"].counters.fused_tower_calls == 0


def test_verify_sig_shares_deferred_twin(world, verify_runs):
    port = TorchBackend(device="cpu")
    ref = TpuBackend()
    resolve = port.verify_sig_shares_deferred(_verify_items(world, True))
    ref_resolve = ref.verify_sig_shares_deferred(_verify_items(world, False))
    assert port.counters.device_dispatches >= 1
    assert resolve() == ref_resolve() == WANT
    assert (port.counters.device_dispatches == ref.counters.device_dispatches
            == verify_runs["port"]["counters"]["device_dispatches"])


def test_stacked_arm_verdicts_and_counters(world, verify_runs, monkeypatch):
    """HBBFT_TPU_NO_FUSED_TOWER=1: the stacked chain, the verdicts and the
    chain counters of the reference's (stacked) run."""
    monkeypatch.setenv("HBBFT_TPU_NO_FUSED_TOWER", "1")
    port = TorchBackend(device="cpu")
    assert port.verify_sig_shares(_verify_items(world, True)) == WANT
    ref = verify_runs["ref"]["backend"].counters
    for k in ("device_dispatches", "pairing_checks", "rlc_groups", "fused_tower_calls",
              "stacked_chain_pallas_calls"):
        assert getattr(port.counters, k) == getattr(ref, k)
    assert port.counters.fused_tower_calls == 0 and port.counters.stacked_chain_pallas_calls > 0


def _combined(world, port: bool):
    _, pks, shares = _side(world, port)
    return [pks.combine_signatures({0: shares[d][0], 2: shares[d][2]}) for d in DOCS]


def test_verify_signatures(world):
    """Three combined signatures and doc 0's presented for doc 1."""
    out = {}
    for name, backend in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
        _, pks, _ = _side(world, name == "port")
        pk = pks.public_key()
        sigs = _combined(world, name == "port")
        items = [(pk, d, s) for d, s in zip(DOCS, sigs)] + [(pk, DOCS[1], sigs[0])]
        out[name] = (backend.verify_signatures(items),
                     _counters(backend, ("device_dispatches", "pairing_checks",
                                         "signatures_verified")))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [True, True, True, False]


def test_sign_shares_batch(world):
    """Eight signings (two docs x four signers) at the device threshold:
    one G2 ladder dispatch, the reference's shares (its host ``sign_share``,
    which its device ladder equals by contract), and the ladder counters
    that the reference's staging of the same chunk bills (its prep and
    ladder accounting run on the host; no reference graph compiles)."""
    port = TorchBackend(device="cpu")
    items = [(world["port_sks"].secret_key_share(i), d) for d in DOCS[:2]
             for i in range(SIGNERS)]
    assert len(items) == port.device_combine_threshold
    got = port.sign_shares_batch(items)
    ref_sks = world["sks"]
    assert [s.to_bytes() for s in got] == [
        ref_sks.secret_key_share(i).sign_share(d).to_bytes() for d in DOCS[:2]
        for i in range(SIGNERS)]
    ref = TpuBackend()
    bits, _ = ref._prep_scalars(ref_curve.prep_g2_scalars, [sk.x for sk, _ in items])
    ref._count_ladder(bits, len(items), glv=bits.ndim == 3)
    for k in ("ladder_field_muls", "glv_decompositions", "glv_table_field_muls"):
        assert getattr(port.counters, k) == getattr(ref.counters, k)
    assert port.counters.device_dispatches == 1 and port.counters.device_seconds_sign > 0


def _combine_items(world, port: bool, with_doc: bool):
    """Four items of k=2 (8 ladder lanes: the device threshold); the
    share pairs differ so that each item interpolates over other indices."""
    shares = _side(world, port)[2]
    picks = [(0, (0, 1)), (1, (1, 3)), (2, (0, 2)), (0, (2, 3))]
    return [({i: shares[DOCS[d]][i] for i in ix}, DOCS[d] if with_doc else None)
            for d, ix in picks]


def _combine_run(world, hostpipe: bool, with_doc: bool):
    mp = pytest.MonkeyPatch()
    try:
        if hostpipe:
            mp.delenv("HBBFT_TPU_NO_HOSTPIPE", raising=False)
        else:
            mp.setenv("HBBFT_TPU_NO_HOSTPIPE", "1")
        out = {}
        for name, backend in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
            pks = _side(world, name == "port")[1]
            sigs = backend.combine_sig_shares_batch(
                pks, _combine_items(world, name == "port", with_doc))
            out[name] = ([s.to_bytes() for s in sigs], _counters(backend, COMBINE_COUNTERS))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("hostpipe,with_doc", [(True, True), (True, False), (False, False)],
                         ids=["doc", "no-doc", "no-hostpipe"])
def test_combine_sig_shares_batch(world, hostpipe, with_doc):
    """The device-combined signatures and every combine counter equal the
    reference's: with a doc (one more dispatch, the re-verify), without,
    and under HBBFT_TPU_NO_HOSTPIPE=1 (no prep memo, no dedup)."""
    out = _combine_run(world, hostpipe, with_doc)
    assert out["port"] == out["ref"]
    pks = world["pks"]
    want = [pks.combine_signatures(sh).to_bytes()
            for sh, _ in _combine_items(world, False, with_doc)]
    assert out["port"][0] == want
    assert out["port"][1]["device_dispatches"] == (2 if with_doc else 1)


def test_single_combines_on_the_device(world):
    """combine_signatures and combine_decryption_shares with the device
    threshold lowered: one dispatch each (two with a doc: the re-verify),
    the host golden's results, and the ladder and staging counters that
    the reference's staging of the same combine bills."""
    psks, ppks, pshares = _side(world, True)
    port = TorchBackend(device="cpu")
    port.device_combine_threshold = 2
    shares = {1: pshares[DOCS[1]][1], 3: pshares[DOCS[1]][3]}
    want = ppks.combine_signatures(shares)
    assert port.combine_signatures(ppks, shares) == want

    ref = TpuBackend()
    rshares = world["shares"][DOCS[1]]
    ref._stage_combine(lagrange_coeffs_at_zero([2, 4]), [rshares[1].el, rshares[3].el],
                       ref_curve.g2_to_device, ref_curve.prep_g2_scalars)
    for k in ("ladder_field_muls", "glv_decompositions", "glv_table_field_muls",
              "stage_cache_hits", "stage_cache_misses"):
        assert getattr(port.counters, k) == getattr(ref.counters, k)
    assert port.combine_signatures(ppks, shares, doc=DOCS[1]) == want
    assert port.counters.device_dispatches == 3

    ct = ppks.encrypt(b"single combine", random.Random(5))
    dshares = {i: psks.secret_key_share(i).decrypt_share_unchecked(ct) for i in (0, 2)}
    dec = TorchBackend(device="cpu")
    dec.device_combine_threshold = 2
    assert dec.combine_decryption_shares(ppks, dshares, ct) == b"single combine"
    assert dec.counters.device_dispatches == 1 and dec.counters.dec_shares_combined == 2


def test_combine_below_threshold_runs_the_host_golden(world):
    port = TorchBackend(device="cpu")
    items = _combine_items(world, True, True)[:2]
    sigs = port.combine_sig_shares_batch(world["port_pks"], items)
    assert sigs == [world["port_pks"].combine_signatures(sh) for sh, _ in items]
    assert port.counters.device_dispatches == 0


def test_the_lagrange_chunk_is_shared():
    """One chunk body serves both groups' combines."""
    assert not hasattr(TorchBackend, "_lagrange_chunk_g2")
    assert port_backend._G2_LADDER.combine is port_backend.curve.linear_combine_g2
    assert port_backend._G1_LADDER.combine is port_backend.curve.linear_combine_g1


# -- the native hash-to-G2 ------------------------------------------------------


HASH_DOCS = list(native.HASHG2_PROBES) + [
    bytes(random.Random(s).getrandbits(8) for _ in range(s % 50)) for s in range(20)
]


def test_native_hash_equals_the_pure_path(monkeypatch):
    monkeypatch.delenv("HBBFT_TPU_NO_NATIVE_HASHG2", raising=False)
    assert native.hashg2_available()
    assert native.HASHG2_PROBES == (b"", b"g2-golden-0", b"g2-golden-1", bytes(range(97)))
    for d in HASH_DOCS:
        p = native.hashg2(d)
        assert p is not None and p == bls381._hash_to_g2_pure(d) == bls381.hash_to_g2(d)


def test_native_hash_equals_the_reference_kernel(monkeypatch):
    monkeypatch.delenv("HBBFT_TPU_NO_NATIVE_HASHG2", raising=False)
    from hbbft_tpu.crypto import bls381 as ref_bls

    for d in HASH_DOCS[:8]:
        want = ref_native.hashg2(d, pure_fn=ref_bls._hash_to_g2_pure)
        assert want is None or native.hashg2(d) == want
        assert native.hashg2(d) == ref_bls.hash_to_g2(d)


def test_no_native_hashg2_takes_the_pure_path(monkeypatch):
    assert native.hashg2_available()  # built and checked before the spy goes in
    calls = []
    pure = bls381._hash_to_g2_pure

    def spy(data):
        calls.append(data)
        return pure(data)

    monkeypatch.setattr(bls381, "_hash_to_g2_pure", spy)
    monkeypatch.setenv("HBBFT_TPU_NO_NATIVE_HASHG2", "1")
    assert native.hashg2(b"switched off") is None
    assert bls381.hash_to_g2(HASH_DOCS[5]) == native._hashg2_call(
        native._load("hashg2_kernel", native._bind_hashg2), HASH_DOCS[5])
    assert calls == [HASH_DOCS[5]]
    monkeypatch.delenv("HBBFT_TPU_NO_NATIVE_HASHG2")
    bls381.hash_to_g2(HASH_DOCS[6])
    assert calls == [HASH_DOCS[5]]


def test_zero_row_padding():
    bits = np.ones((3, 2, 5), dtype=np.uint8)
    negs = np.ones((3, 2), dtype=bool)
    b, n = port_backend._pad_zero_rows(bits, negs, 1)
    assert b.shape == (4, 2, 5) and not b[3].any() and not n[3].any() and b[:3].all()
    assert port_backend._pad_zero_rows(bits, negs, 0)[0] is bits
