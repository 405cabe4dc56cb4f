"""The port's SyncKeyGen against the JAX package's: every case of the
reference's ``test_sync_key_gen.py`` run in both packages on each one's
``MockGroup`` from the same seed.  The two runs must give the same Parts and
Acks byte for byte, the same fault kinds, the same ``PublicKeySet`` and the
same secret shares, and the next draw of the shared rng must agree."""

import importlib
import random

import pytest


class Pkg:
    def __init__(self, root):
        self.group = importlib.import_module(f"{root}.crypto.group")
        self.keys = importlib.import_module(f"{root}.crypto.keys")
        self.poly = importlib.import_module(f"{root}.crypto.poly")
        self.skg = importlib.import_module(f"{root}.protocols.sync_key_gen")
        self.canonical = importlib.import_module(f"{root}.utils.canonical")


REF, PORT = Pkg("hbbft_tpu"), Pkg("hbbft_tpu_torch")


def setup(P, seed, n=4, threshold=1, group=None):
    g = group or P.group.MockGroup()
    rng = random.Random(seed)
    sks = {i: P.keys.SecretKey.random(g, rng) for i in range(n)}
    pks = {i: sk.public_key() for i, sk in sks.items()}
    nodes, parts = {}, {}
    for i in range(n):
        nodes[i], parts[i] = P.skg.SyncKeyGen.new(i, sks[i], pks, threshold, rng, g)
    return g, rng, sks, pks, nodes, parts


def part_bytes(P, part):
    return P.canonical.encode(P.skg.part_to_canonical(part))


def ack_bytes(P, ack):
    return P.canonical.encode(P.skg.ack_to_canonical(ack))


def run_dkg(P, n, threshold, seed, drop_proposer=None, group=None):
    """The reference's synchronous DKG; the transcript of every message,
    outcome and key."""
    g, rng, sks, pks, nodes, parts = setup(P, seed, n, threshold, group)
    log = [part_bytes(P, parts[i]) for i in sorted(parts)]
    parts = {i: p for i, p in parts.items() if p is not None and i != drop_proposer}
    acks = []
    for proposer in sorted(parts):
        for i in range(n):
            out = nodes[i].handle_part(proposer, parts[proposer], rng)
            assert out.fault is None, out.fault
            if out.ack is not None:
                acks.append((i, out.ack))
                log.append(ack_bytes(P, out.ack))
    for acker, ack in acks:
        for i in range(n):
            assert nodes[i].handle_ack(acker, ack).fault is None
    results = {i: nodes[i].generate() for i in range(n)}
    pk_set = results[0][0]
    assert all(r[0] == pk_set for r in results.values())
    log.append(pk_set.to_bytes())
    log.append([results[i][1].x for i in range(n)])
    log.append(rng.random())
    return log, pk_set, {i: r[1] for i, r in results.items()}


@pytest.mark.parametrize("n, t, seed, drop", [(4, 1, 1, None), (7, 2, 1, None), (4, 0, 1, None),
                                              (4, 1, 2, None), (4, 1, 3, 2)],
                         ids=["n4-t1", "n7-t2", "n4-t0", "n4-t1-encrypt", "missing-proposer"])
def test_dkg_equals_the_reference(n, t, seed, drop):
    ref, _, _ = run_dkg(REF, n, t, seed, drop)
    port, pk_set, shares = run_dkg(PORT, n, t, seed, drop)
    assert port == ref
    # the reference test's own checks on the port's keys
    assert pk_set.threshold() == t
    doc = b"dkg doc"
    signers = [i for i in range(n) if i != drop][: t + 1]
    sig = pk_set.combine_signatures({i: shares[i].sign_share(doc) for i in signers})
    assert pk_set.public_key().verify(sig, doc)
    ct = pk_set.encrypt(b"post-dkg secret", random.Random(9))
    dshares = {i: shares[i].decrypt_share(ct) for i in signers}
    assert pk_set.combine_decryption_shares(dshares, ct) == b"post-dkg secret"


def corrupt_part(P):
    g, rng, sks, pks, nodes, parts = setup(P, 4)
    rows = list(parts[1].rows)
    rows[0] = rows[0][:-1] + bytes([rows[0][-1] ^ 1])
    return [nodes[0].handle_part(1, P.skg.Part(parts[1].commit, tuple(rows)), rng).fault,
            rng.random()]


def wrong_ack(P):
    g, rng, sks, pks, nodes, parts = setup(P, 5)
    out0 = nodes[0].handle_part(1, parts[1], rng)
    out2 = nodes[2].handle_part(1, parts[1], rng)
    vals = list(out2.ack.values)
    vals[0] = pks[0].encrypt(P.canonical.encode(12345), rng).to_bytes()
    bad = P.skg.Ack(out2.ack.proposer_idx, tuple(vals))
    return [nodes[0].handle_ack(2, bad).fault, nodes[0].handle_ack(0, out0.ack).fault,
            ack_bytes(P, out0.ack), rng.random()]


def ack_before_part(P):
    g, rng, sks, pks, nodes, parts = setup(P, 6)
    ack = nodes[1].handle_part(0, parts[0], rng).ack
    return [nodes[2].handle_ack(1, ack).fault, nodes[2].handle_part(0, parts[0], rng).fault,
            sorted(nodes[2].parts[0].acks), ack_bytes(P, ack)]


def not_ready(P):
    g, rng, sks, pks, nodes, parts = setup(P, 7)
    try:
        nodes[0].generate()
    except ValueError as e:
        return ["ValueError", str(e)]
    return ["no error"]


def bivar_asymmetric(P):
    c = P.poly.BivarCommitment(P.group.MockGroup(), [[1, 2, 3], [40, 5, 6], [700, 80, 9]])
    out = []
    for x in (1, 2, 5):
        for y in (1, 3, 4):
            assert c.col(y).evaluate(x) == c.evaluate(x, y) == c.row(x).evaluate(y)
            out.append(c.evaluate(x, y))
    assert c.col(2).coeffs != c.row(2).coeffs
    return out + [c.col(2).coeffs, c.row(2).coeffs]


CASES = {
    "corrupt-part-rows": (corrupt_part, lambda r: r[0] in (
        "sync_key_gen:invalid_row_encryption", "sync_key_gen:row_commitment_mismatch")),
    "wrong-ack-value": (wrong_ack, lambda r: r[:2] == ["sync_key_gen:ack_value_mismatch", None]),
    "ack-before-part": (ack_before_part, lambda r: r[:3] == [None, None, [1]]),
    "not-ready": (not_ready, lambda r: r[0] == "ValueError"),
    "bivar-col-asymmetric": (bivar_asymmetric, lambda r: True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_case_equals_the_reference(name):
    case, check = CASES[name]
    ref, port = case(REF), case(PORT)
    assert port == ref
    assert check(port), port


@pytest.mark.slow
def test_dkg_on_real_curve_equals_the_reference():
    from hbbft_tpu.crypto.bls381 import BLS381Group as RefGroup
    from hbbft_tpu_torch.crypto.bls381 import BLS381Group as PortGroup

    ref, _, _ = run_dkg(REF, 4, 1, 8, group=RefGroup())
    port, _, _ = run_dkg(PORT, 4, 1, 8, group=PortGroup())
    assert port == ref


@pytest.mark.parametrize("group", ["mock", "bls381"])
def test_public_key_shares_equal_the_reference_and_leave_the_key_set_as_it_was(group):
    """The port evaluates each share of a key set once: every share equals
    the reference's share of the same key set on every call, each call
    returns a fresh object, the key set's attributes (what a snapshot
    encodes) are untouched, and the points leave with the key set."""
    import gc

    mods = [importlib.import_module(f"{root}.crypto.{'bls381' if group == 'bls381' else 'group'}")
            for root in ("hbbft_tpu", "hbbft_tpu_torch")]
    ref_g, port_g = (m.BLS381Group() if group == "bls381" else m.MockGroup() for m in mods)
    ref_pks = REF.keys.SecretKeySet.random(ref_g, 2, random.Random(3)).public_keys()
    pks = PORT.keys.SecretKeySet.random(port_g, 2, random.Random(3)).public_keys()
    attrs = dict(vars(pks))
    want = [ref_pks.public_key_share(i).to_bytes() for i in range(5)]
    for _ in range(2):
        assert [pks.public_key_share(i).to_bytes() for i in range(5)] == want
    assert pks.public_key_share(1) is not pks.public_key_share(1)
    assert vars(pks) == attrs and PORT.keys.PublicKeySet.from_bytes(
        port_g, pks.to_bytes()).public_key_share(4).to_bytes() == want[4]
    key = id(pks)
    assert set(PORT.keys._SHARE_POINTS[key]) == set(range(5))
    del pks
    gc.collect()
    assert key not in PORT.keys._SHARE_POINTS
