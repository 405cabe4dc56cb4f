"""The port's fused tower chain against the JAX package's.

* The plain versions of the three CUDA kernels (``op_plain`` for all seven
  op kinds, ``dbl_plain``, ``hard_plain``) against the Pallas kernels of
  ``hbbft_tpu/ops/tower_fused.py`` in interpret mode, residue for residue
  (max |Δ| = 0), on lazy-domain inputs from a numpy seed that include edge
  values (0, 1, Q−1, large multiples of Q, sums and negations).
* The packed tower constants against the reference's.
* ``product2_fast_fused`` against ``pairing_chain.product2_fast_fused(
  mode="interpret")`` on canonical readback and verdicts, in one 4-lane
  batch: a valid check, a forged one, and two degenerate infinity lanes.
* The kill switch ``HBBFT_TPU_NO_FUSED_TOWER``: the port's fused and
  stacked arms agree on canonical readback, verdicts and
  ``device_dispatches``, and the fused counters bill only the fused arm.

The reference runs with ``tower_fused.TILE`` patched to 8 (as
tests/test_tower_fused.py runs it), once per module, on 2 lanes (4 for the
pairing batch).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import bls381 as jgold
from hbbft_tpu.crypto.field import Q, R as SUBR
from hbbft_tpu.ops import fq_rns as JR, pairing as JP, tower as JT
from hbbft_tpu.ops import pairing_chain as JPC, tower_fused as JTF
from hbbft_tpu_torch.ops import pairing as TP, pairing_chain as TPC, tower as TT
from hbbft_tpu_torch.ops import tower_fused as TTF

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

LANES = 2


def _lazy_rows(rs: np.random.Generator, n: int) -> np.ndarray:
    """(n, 79) residue rows of lazy-domain values: residues of random and
    edge integers (0, 1, Q−1, ±2^13·Q + x), then sums of up to 8 rows and
    negations — lanes in (−8p, 8p), values well inside the 2^16·Q bound
    after the kernels' own Karatsuba sums."""
    edge = [0, 1, Q - 1, (1 << 13) * Q + 5, -((1 << 13) * Q) + 7]
    vals = edge + [int.from_bytes(rs.bytes(48), "big") % Q for _ in range(16)]
    base = np.array(
        [[v % p for p in JR.B1 + JR.B2 + [JR.M_R]] for v in vals], dtype=np.float32
    )
    rows = []
    for _ in range(n):
        k = int(rs.integers(1, 9))
        pick = base[rs.integers(0, len(base), size=k)].sum(axis=0)
        rows.append(-pick if rs.random() < 0.3 else pick)
    return np.stack(rows).astype(np.float32)


def _el(rs, coeffs: int, n: int = LANES) -> np.ndarray:
    return np.stack([_lazy_rows(rs, n) for _ in range(coeffs)])


def _jax_el(arr: np.ndarray):
    return JTF._OF[arr.shape[0]]([jnp.asarray(c) for c in arr])


def _jax_leaves(el) -> np.ndarray:
    return np.stack([np.asarray(c) for c in JTF._leaves(el)])


def _jax_rows(arr: np.ndarray, lanes: int, width: int):
    return jnp.concatenate([JTF._to_rows(jnp.asarray(c), lanes, width) for c in arr], axis=0)


def _from_jax_rows(rows, n: int, lanes: int) -> np.ndarray:
    return np.stack([np.asarray(JTF._from_rows(c, lanes)) for c in JTF._unpack_rows(rows, n)])


def _pairing_quads():
    """4 lanes: a valid check, a forged one, then the valid check again
    with both pairs degenerate (pair-1 P and pair-2 Q at infinity: the
    product is one) and with pair-1 P alone at infinity (it is not)."""
    rng = random.Random(2020)
    g1, g2 = jgold.G1_GEN, jgold.G2_GEN
    a, b = rng.randrange(1, SUBR), rng.randrange(1, SUBR)
    valid = (jgold.ec_neg(jgold.FQ, g1), jgold.ec_mul(jgold.FQ2, a, g2),
             jgold.ec_mul(jgold.FQ, a, g1), g2)
    forged = (valid[0], valid[1], jgold.ec_mul(jgold.FQ, b, g1), g2)
    return [valid, forged, (None,) + valid[1:3] + (None,), (None,) + valid[1:]]


@pytest.fixture(scope="module")
def ref():
    """Inputs (numpy) and the JAX package's interpret-mode outputs."""
    rs = np.random.default_rng(2020)
    out = {"ops": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTF, "TILE", 8)
        for kind in TTF.OP_KINDS:
            c = TTF._OP_BODY[kind][1]
            a, b = _el(rs, c), _el(rs, c)
            fn = getattr(JTF, kind)
            if kind.endswith("_mul"):
                got = fn(_jax_el(a), _jax_el(b), interpret=True)
            else:
                got, b = fn(_jax_el(a), interpret=True), a
            out["ops"][kind] = (a, b, _jax_leaves(got))

        f, r, p = _el(rs, 12), _el(rs, 6), _el(rs, 2)
        fo, ro = JTF.miller_double_step_rows(
            _jax_rows(f, LANES, 8), _jax_rows(r, LANES, 8), _jax_rows(p, LANES, 8),
            interpret=True,
        )
        out["dbl"] = (f, r, p, _from_jax_rows(fo, 12, LANES), _from_jax_rows(ro, 6, LANES))

        m = _el(rs, 12)
        out["hard"] = (m, _jax_leaves(JTF.hard_exp(_jax_el(m), interpret=True)))

        quads = _pairing_quads()
        P1 = JP.g1_affine_to_device([q[0] for q in quads])
        Q1 = JP.g2_affine_to_device([q[1] for q in quads])
        P2 = JP.g1_affine_to_device([q[2] for q in quads])
        Q2 = JP.g2_affine_to_device([q[3] for q in quads])
        f12 = JPC.product2_fast_fused(P1, Q1, P2, Q2, mode="interpret")
        out["product2"] = (quads, JT.fq12_to_ints_batch(f12, len(quads)),
                           JP.is_one_host_batch(f12, len(quads)))
    tc = np.asarray(JTF._tower_consts())
    out["consts"] = np.concatenate([tc[:39], tc[40:]]).T  # drop the pad row
    return out


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(arr)


@pytest.mark.parametrize("kind", TTF.OP_KINDS)
def test_op_plain_equals_pallas_op_kernel(ref, kind):
    a, b, want = ref["ops"][kind]
    got = TTF.op_plain(kind, _t(a), _t(b)).numpy()
    assert np.abs(got - want).max() == 0


@pytest.mark.parametrize("kind", TTF.OP_KINDS)
def test_public_op_wrappers_route_to_the_plain_version_on_cpu(ref, kind):
    a, b, want = ref["ops"][kind]
    c = TTF._OP_BODY[kind][1]
    ea = TTF.unpack(_t(a), (LANES, TTF.NL))
    eb = TTF.unpack(_t(b), (LANES, TTF.NL))
    fn = getattr(TTF, kind)
    got = fn(ea, eb) if kind.endswith("_mul") else fn(ea)
    assert len(TTF._leaves(got)) == c
    assert np.abs(TTF.pack(got).numpy() - want).max() == 0


def test_dbl_plain_equals_pallas_dbl_kernel(ref):
    f, r, p, want_f, want_r = ref["dbl"]
    got_f, got_r = TTF.miller_double_step_rows(_t(f), _t(r), _t(p))
    assert np.abs(got_f.numpy() - want_f).max() == 0
    assert np.abs(got_r.numpy() - want_r).max() == 0


def test_hard_plain_equals_pallas_hard_kernel(ref):
    m, want = ref["hard"]
    got = TTF.hard_plain(_t(m)).numpy()
    assert np.abs(got - want).max() == 0


def test_tower_consts_equal_the_reference(ref):
    assert np.array_equal(TTF._tower_consts(), ref["consts"])
    assert TTF._X_CHAIN_BITS.tolist() == JTF._X_CHAIN_BITS.tolist()


def _port_operands(quads):
    dev = "cpu"
    return (
        TP.g1_affine_to_device([q[0] for q in quads], device=dev),
        TP.g2_affine_to_device([q[1] for q in quads], device=dev),
        TP.g1_affine_to_device([q[2] for q in quads], device=dev),
        TP.g2_affine_to_device([q[3] for q in quads], device=dev),
    )


def test_product2_fused_matches_reference_and_stacked(ref, monkeypatch):
    """Canonical readback and verdicts equal the reference's fused graph
    (valid, forged and both degenerate infinity lanes), and the stacked
    arm that HBBFT_TPU_NO_FUSED_TOWER=1 selects computes the same values."""
    quads, want, want_ok = ref["product2"]
    ops = _port_operands(quads)
    fused = TPC.product2_fast_fused(*ops)
    assert TT.fq12_to_ints_batch(fused) == want
    assert TP.is_one_host_batch(fused, 4) == want_ok == [True, False, True, False]
    monkeypatch.setenv("HBBFT_TPU_NO_FUSED_TOWER", "1")
    stacked = TP.product2_fast(*ops)
    assert TT.fq12_to_ints_batch(stacked) == want


def test_no_merge_arm_matches_reference(ref, monkeypatch):
    """HBBFT_TPU_NO_MERGE=1 runs the two Miller loops one after the other
    (the merge policy both arms share): the fused and the stacked arm
    still give the reference's canonical readback and verdicts."""
    quads, want, want_ok = ref["product2"]
    ops = _port_operands(quads)
    lanes = []  # lanes of every Miller loop (fused) or doubling (stacked)
    loop, dbl = TPC.miller_loop_fused, TP._miller_double_step
    monkeypatch.setattr(TPC, "miller_loop_fused",
                        lambda P, Qa: lanes.append(P[0].shape[0]) or loop(P, Qa))
    monkeypatch.setattr(TP, "_miller_double_step",
                        lambda f, R, x, y: lanes.append(x.shape[0]) or dbl(f, R, x, y))
    monkeypatch.setenv("HBBFT_TPU_NO_MERGE", "1")
    for kill, loops in (("", 2), ("1", 2 * 63)):
        monkeypatch.setenv("HBBFT_TPU_NO_FUSED_TOWER", kill)
        lanes.clear()
        got = TP.product2_fast(*ops)
        assert lanes == [len(quads)] * loops  # never one merged 8-lane loop
        assert TT.fq12_to_ints_batch(got) == want
        assert TP.is_one_host_batch(got, 4) == want_ok


def _ct_arm(monkeypatch, kill: bool):
    from hbbft_tpu_torch.crypto.keys import Ciphertext
    from hbbft_tpu_torch.ops.backend import TorchBackend

    if kill:
        monkeypatch.setenv("HBBFT_TPU_NO_FUSED_TOWER", "1")
    else:
        monkeypatch.delenv("HBBFT_TPU_NO_FUSED_TOWER", raising=False)
    rng = random.Random(77)
    be = TorchBackend(device="cpu")
    pks = be.generate_key_set(1, rng).public_keys()
    cts = [pks.encrypt(b"fused arm %d" % i, rng) for i in range(2)]
    bad = Ciphertext(be.group, cts[0].u, b"X" + cts[0].v[1:], cts[0].w)
    return be.verify_ciphertexts(cts + [bad]), be.counters.snapshot()


def test_backend_kill_switch_ab(monkeypatch):
    """Identical verdicts and device_dispatches in both arms; the fused
    counters and the fused_chain dispatch kind bill only the fused arm,
    the stacked launch counter only the stacked arm."""
    fused_v, fc = _ct_arm(monkeypatch, kill=False)
    kill_v, kc = _ct_arm(monkeypatch, kill=True)
    assert fused_v == kill_v == [True, True, False]
    assert fc["device_dispatches"] == kc["device_dispatches"] == 1
    assert fc["fused_tower_calls"] == 1 and kc["fused_tower_calls"] == 0
    assert fc["fused_chain_pallas_calls"] == TPC.analytic_pallas_calls(2, fused=True)
    assert fc["fused_chain_field_muls"] == TPC.analytic_chain_field_muls(4)
    assert fc["stacked_chain_pallas_calls"] == 0
    assert kc["stacked_chain_pallas_calls"] == TPC.analytic_pallas_calls(2, fused=False)
    assert fc["device_seconds_fused_chain"] > 0 and fc["device_seconds_pairing"] == 0
    assert kc["device_seconds_pairing"] > 0 and kc["device_seconds_fused_chain"] == 0


def test_analytic_counts_match_the_reference():
    for fused in (False, True):
        assert TPC.analytic_pallas_calls(2, fused) == JPC.analytic_pallas_calls(2, fused)
    assert TPC.analytic_chain_field_muls(5) == JPC.analytic_chain_field_muls(5)
    assert TPC.analytic_pallas_calls(2, True) == 132
    # the port's hard kernel branches on the bit: 5·63 cyclotomic squares
    # and 25 set-bit multiplies instead of 315 blended ones
    assert TTF.analytic_hard_field_muls() == 5 * 63 * 30 + 25 * 54 + 624
