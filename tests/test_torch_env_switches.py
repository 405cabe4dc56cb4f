"""The reference's env switches, read by the port as the reference reads
them (each set here, and the port held against the JAX package's
``TpuBackend``, ``StagingCache`` and ``ops/curve.py`` on the same inputs).

* ``HBBFT_TPU_NO_ADAPTIVE_RLC``: no adaptive group cap, groups kept whole;
* ``HBBFT_TPU_STAGE_CAP``: the staging cache's capacity (0 disables it);
* ``HBBFT_TPU_NO_GLV`` / ``HBBFT_TPU_LADDER_BINARY``: the classic
  ``safe_scalar`` ladder form instead of GLV/GLS, and the binary ladder;
* ``HBBFT_TPU_PAIR_CAP``: pairing checks per dispatch, read at import;
* ``HBBFT_TPU_RLC_BITS``: the RLC coefficient width, read per batch.

Counters are compared where the reference gives them without compiling a
ladder (its host prep and counter arithmetic).  The end-to-end runs that
need the reference's XLA:CPU graphs sit in test_torch_backend.py, beside
the runs that compile the same graph shapes.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.bls381 import BLS381Group as RefGroup
from hbbft_tpu.crypto.field import R
from hbbft_tpu.ops import curve as JC, staging as JS
from hbbft_tpu.ops.backend import TpuBackend
from hbbft_tpu.utils.metrics import Counters as RefCounters
from hbbft_tpu_torch import convert
from hbbft_tpu_torch.ops import curve as TC, staging as TS
from hbbft_tpu_torch.ops.backend import TorchBackend
from hbbft_tpu_torch.utils.metrics import Counters

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _bare(ref: bool):
    """A backend with counters and an empty window, nothing else built."""
    b = TpuBackend.__new__(TpuBackend) if ref else TorchBackend.__new__(TorchBackend)
    b.counters = RefCounters() if ref else Counters()
    b._rlc_obs_items = b._rlc_obs_rejects = 0.0
    return b


# -- HBBFT_TPU_NO_ADAPTIVE_RLC -----------------------------------------------------


@pytest.mark.parametrize(
    "switch, cap, sizes, splits",
    [("1", None, [10, 3, 47], 0), (None, 14, [10, 3, 14, 14, 14, 5], 1)],
)
def test_no_adaptive_rlc_keeps_groups_whole(switch, cap, sizes, splits, monkeypatch):
    """A window of 100 items with 5 rejects and groups [10, 3, 47]: with
    the switch set both sides give cap None and the groups unchanged;
    unset, both cap at 14 and split once."""
    if switch is None:
        monkeypatch.delenv("HBBFT_TPU_NO_ADAPTIVE_RLC", raising=False)
    else:
        monkeypatch.setenv("HBBFT_TPU_NO_ADAPTIVE_RLC", switch)
    got = {}
    for name in ("ref", "port"):
        b = _bare(name == "ref")
        b._rlc_obs_items, b._rlc_obs_rejects = 100.0, 5.0
        groups = [list(range(10)), list(range(10, 13)), list(range(13, 60))]
        out = b._rlc_apply_cap(groups)
        got[name] = (b._rlc_adaptive_cap(), [len(g) for g in out], out,
                     b.counters.rlc_adaptive_splits)
    assert got["port"] == got["ref"]
    assert got["port"][0] == cap and got["port"][1] == sizes and got["port"][3] == splits


# -- HBBFT_TPU_STAGE_CAP --------------------------------------------------------------


@pytest.mark.parametrize("value, capacity", [("0", 0), ("2", 2), ("junk", 32768), (None, 32768)])
def test_stage_cap_is_read_like_the_reference(value, capacity, monkeypatch):
    """The capacity each side reads from the switch, and the rows, hits
    and misses it then gives over the same calls."""
    if value is None:
        monkeypatch.delenv("HBBFT_TPU_STAGE_CAP", raising=False)
    else:
        monkeypatch.setenv("HBBFT_TPU_STAGE_CAP", value)
    port = TS.StagingCache(counters=Counters())
    ref = JS.StagingCache(counters=RefCounters())
    assert port.capacity == ref.capacity == capacity
    for batch in ([5, 7, 5], [7, 9, 11], [5, 13, 7]):
        assert np.array_equal(port.rows(batch), ref.rows(batch))
    assert len(port) == len(ref)
    assert (port.counters.stage_cache_hits, port.counters.stage_cache_misses) == (
        ref.counters.stage_cache_hits, ref.counters.stage_cache_misses,
    )
    if capacity == 0:
        assert len(port) == 0 and port.counters.stage_cache_misses == 0


def test_backend_staging_cache_reads_the_switch(monkeypatch):
    monkeypatch.setenv("HBBFT_TPU_STAGE_CAP", "0")
    assert TorchBackend(device="cpu")._stage.capacity == 0


# -- HBBFT_TPU_NO_GLV / HBBFT_TPU_LADDER_BINARY --------------------------------------

#: scalars below and above 2^254 (the latter negated by safe_scalar), and r − 1
_SCALARS = [5, R - 3, (1 << 254) + 12345, 0x1234_5678_9ABC_DEF0 << 130, R - 1]
_SWITCHES = [{"HBBFT_TPU_NO_GLV": "1"}, {"HBBFT_TPU_LADDER_BINARY": "1"}, {}]


def _set(monkeypatch, env):
    for k in ("HBBFT_TPU_NO_GLV", "HBBFT_TPU_LADDER_BINARY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", _SWITCHES, ids=["no_glv", "binary", "default"])
@pytest.mark.parametrize("prep", ["prep_g1_scalars", "prep_g2_scalars"])
def test_scalar_prep_and_counters_equal_the_reference(env, prep, monkeypatch):
    """The port's prep gives the reference's (bits, negs) form, and its
    backend bills the same ladder_field_muls, glv_table_field_muls and
    glv_decompositions for it."""
    _set(monkeypatch, env)
    assert TC.glv_enabled() == JC.glv_enabled() == (not env)
    for s in _SCALARS:
        assert TC.safe_scalar(s) == JC.safe_scalar(s)
    got = {}
    for name, mod in (("ref", JC), ("port", TC)):
        b = _bare(name == "ref")
        bits, negs = b._prep_scalars(getattr(mod, prep), _SCALARS)
        b._count_ladder(bits, len(_SCALARS), glv=bits.ndim == 3)
        c = b.counters
        got[name] = (bits, negs, c.ladder_field_muls, c.glv_table_field_muls,
                     c.glv_decompositions)
    for a, b in zip(got["port"], got["ref"]):
        assert np.array_equal(a, b)
    per_lane = {"no_glv": 127 * 30, "binary": 254 * 23}
    if env:
        assert got["port"][0].shape == (len(_SCALARS), 254)
        assert got["port"][4] == 0  # no decompositions on the classic path
        arm = "no_glv" if "HBBFT_TPU_NO_GLV" in env else "binary"
        assert got["port"][2] == per_lane[arm] * len(_SCALARS)


@pytest.mark.parametrize(
    "env, width",
    [({"HBBFT_TPU_NO_GLV": "1"}, 20), ({"HBBFT_TPU_LADDER_BINARY": "1"}, 20), ({}, 21)],
    ids=["no_glv", "binary", "odd_width"],
)
def test_classic_ladders_give_the_golden_points(env, width, monkeypatch):
    """The ladder the classic form routes to (w2 under HBBFT_TPU_NO_GLV;
    binary under HBBFT_TPU_LADDER_BINARY, or at an odd width with no
    switch) gives the reference group's ±s·P on G1 and G2, at a 20- or
    21-bit width (the ladder's steps do not depend on the width), and a
    full-width prep gives the classic form."""
    _set(monkeypatch, env)
    g = RefGroup()
    rng = random.Random(5)
    scalars = [rng.randrange(1, 1 << width) for _ in range(3)]
    scalars[0] |= 1 << (width - 1)  # the top bit set: every step of the ladder runs
    negs = np.array([False, True, False])
    bits = TC.scalars_to_bits(scalars, width)
    for mul, to_dev, from_dev, gen, smul in (
        (g.g1_mul, TC.g1_to_device, TC.g1_from_device, g.g1(), TC.g1_scalar_mul_signed),
        (g.g2_mul, TC.g2_to_device, TC.g2_from_device, g.g2(), TC.g2_scalar_mul_signed),
    ):
        pts = [mul(rng.randrange(1, R), gen) for _ in range(3)]
        out = from_dev(smul(to_dev(pts, device="cpu"), bits, negs))
        want = [mul(s if not n else R - s, p) for s, n, p in zip(scalars, negs, pts)]
        assert out == want
    if env:
        bits, negs = TC.prep_g1_scalars([R - 2])
        assert bits.shape == (1, 254) and bool(negs[0])


@pytest.fixture(scope="module")
def keyset():
    rng = random.Random(41)
    sks = TpuBackend().generate_key_set(1, rng)
    pks = sks.public_keys()
    msgs = [b"no glv", b"classic ladder", b"third"]
    cts = [pks.encrypt(m, rng) for m in msgs]
    return sks, pks, msgs, cts


def test_no_glv_combine_equals_the_reference(keyset, monkeypatch):
    """combine_dec_shares_batch with HBBFT_TPU_NO_GLV=1 on the port's
    device path (a (4, 2) classic w2 ladder): the reference's plaintexts,
    and the counters the reference bills for the same prep."""
    _set(monkeypatch, {"HBBFT_TPU_NO_GLV": "1"})
    sks, pks, msgs, cts = keyset
    picks = [(0, (0, 2)), (1, (1, 2)), (2, (0, 1))]
    items = [({i: sks.secret_key_share(i).decrypt_share_unchecked(cts[c]) for i in ix}, cts[c])
             for c, ix in picks]
    psks = convert.secret_key_set(sks)
    pcts = [convert.ciphertext(ct) for ct in cts]
    port_items = [
        ({i: psks.secret_key_share(i).decrypt_share_unchecked(pcts[c]) for i in ix}, pcts[c])
        for c, ix in picks
    ]
    port = TorchBackend(device="cpu")
    port.device_combine_threshold = 2
    got = port.combine_dec_shares_batch(convert.public_key_set(pks), port_items)
    assert got == TpuBackend().combine_dec_shares_batch(pks, items) == msgs
    # the reference's bill for the same chunk: three preps (one per index
    # set), one (4, 2) ladder dispatch
    ref = _bare(True)
    from hbbft_tpu.crypto.field import lagrange_coeffs_at_zero

    for _, ix in picks:
        bits, _ = ref._prep_scalars(JC.prep_g1_scalars,
                                    lagrange_coeffs_at_zero([i + 1 for i in ix]))
    ref._count_ladder(bits, 3 * 2, glv=bits.ndim == 3)
    c, rc = port.counters, ref.counters
    assert (c.ladder_field_muls, c.glv_table_field_muls, c.glv_decompositions) == (
        rc.ladder_field_muls, rc.glv_table_field_muls, rc.glv_decompositions,
    ) == (6 * 127 * 30, 0, 0)
    assert c.device_dispatches == 1


# -- HBBFT_TPU_PAIR_CAP and HBBFT_TPU_RLC_BITS ------------------------------------------


def test_pair_cap_is_read_at_import_like_the_reference():
    """Both classes read HBBFT_TPU_PAIR_CAP once, at import (a fresh
    interpreter with the switch set)."""
    code = ("from hbbft_tpu.ops.backend import TpuBackend as A; "
            "from hbbft_tpu_torch.ops.backend import TorchBackend as B; "
            "print(A.pairing_lane_cap, B.pairing_lane_cap)")
    env = dict(os.environ, HBBFT_TPU_PAIR_CAP="3", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["3", "3"]
    assert TorchBackend.pairing_lane_cap == TpuBackend.pairing_lane_cap


@pytest.mark.parametrize("bits", ["16", "32", "128", None])
def test_rlc_bits_is_read_per_batch_like_the_reference(bits, monkeypatch):
    """Each round's coefficient matrix has the switch's width on both
    sides, read at the call, and bills the same ladder muls."""
    if bits is None:
        monkeypatch.delenv("HBBFT_TPU_RLC_BITS", raising=False)
    else:
        monkeypatch.setenv("HBBFT_TPU_RLC_BITS", bits)
    width = int(bits or 64)
    assert TorchBackend._rlc_bits() == TpuBackend._rlc_bits() == width
    assert all(0 < r < (1 << width) for r in TorchBackend._rlc_scalars(64))
    pending = [[0, 1, 2], [3, 4, 5, 6, 7]]
    got = {}
    for name, b in (("ref", TpuBackend()), ("port", TorchBackend(device="cpu"))):
        args, n_items = b._rlc_round_stage(pending, lambda padded, g, k: ())
        rbits = np.asarray(args[-1])
        got[name] = (rbits.shape, n_items, b.counters.ladder_field_muls, b.counters.rlc_groups)
    assert got["port"] == got["ref"]
    assert got["port"][0] == (4, 8, width)


# -- HBBFT_TPU_FUSED_TOWER ------------------------------------------------------------


@pytest.mark.parametrize("value", ["off", "0", "auto", None])
def test_fused_tower_off_takes_the_stacked_chain(value, monkeypatch):
    """``HBBFT_TPU_FUSED_TOWER=off`` (or ``0``) routes one
    ``verify_ciphertexts`` of one ciphertext through the stacked chain and
    bills the reference's counters for its routing (``_bill_chain`` of the
    reference's ``fused_tower_mode()``, which compiles nothing); ``auto``
    and an unset variable keep the port's fused default."""
    from hbbft_tpu.ops import tower_fused as JTF

    monkeypatch.delenv("HBBFT_TPU_NO_FUSED_TOWER", raising=False)
    if value is None:
        monkeypatch.delenv("HBBFT_TPU_FUSED_TOWER", raising=False)
    else:
        monkeypatch.setenv("HBBFT_TPU_FUSED_TOWER", value)
    port = TorchBackend(device="cpu")
    pks = port.generate_key_set(1, random.Random(5)).public_keys()
    ct = pks.encrypt(b"one ciphertext", random.Random(6))
    assert port.verify_ciphertexts([ct]) == [True]
    keys = ("fused_tower_calls", "fused_chain_field_muls", "fused_chain_pallas_calls",
            "stacked_chain_pallas_calls")
    got = {k: getattr(port.counters, k) for k in keys}
    stacked = value in ("off", "0")
    assert (got["fused_tower_calls"] == 0) == stacked
    assert (got["stacked_chain_pallas_calls"] > 0) == stacked
    if stacked:
        assert JTF.fused_tower_mode() is None
        ref = _bare(True)
        TpuBackend._bill_chain(ref, JTF.fused_tower_mode(), 1)
        assert got == {k: getattr(ref.counters, k) for k in keys}
