"""The port's device erasure/hash plane against the JAX package's.

``TorchBackend(device="cpu")``'s four plane methods (``rs_encode_batch``,
``rs_reconstruct_batch``, ``merkle_build_batch``, ``merkle_verify_batch``)
run the plain versions of the ``gf256_matmul``, ``sha256_tagged`` and
``sha256_proofs`` kernels here.  They must be bit-identical to
``TpuBackend()``'s plane on XLA:CPU, to the seam's host defaults (the host
codec, hashlib and the native C kernels), error raises included, and bill
the same ``device_dispatches`` and ``device_seconds_*`` kinds.  Also held:
the bounded decode-matrix cache, ``TorchRSCodec`` against ``JaxRSCodec``,
``PackedProofs.from_trees(device=True)``, the ``HBBFT_TPU_NO_DEVICE_RS=1``
kill switch, the plain SHA-256 against hashlib at the block-count
boundaries, and the node block the kernel assembles from digest words.

A few small shapes are shared on purpose: each new reference SHA-256 or
GF shape costs an XLA:CPU compile.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.erasure import RSCodec as RefRSCodec
from hbbft_tpu.crypto.merkle import MerkleTree as RefTree, PackedProofs as RefPacked
from hbbft_tpu.ops import sha256 as ref_sha
from hbbft_tpu.ops.backend import TpuBackend
from hbbft_tpu.ops.gf256 import JaxRSCodec, expand_gf_matrix as ref_expand
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.crypto.erasure import RSCodec, gf256
from hbbft_tpu_torch.crypto.merkle import MerkleTree, PackedProofs
from hbbft_tpu_torch.ops import gf256 as G, sha256 as S
from hbbft_tpu_torch.ops.backend import TorchBackend

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

_KINDS = ("rs_enc", "rs_dec", "merkle")


@pytest.fixture(scope="module")
def tbe():
    return TpuBackend()


@pytest.fixture(scope="module")
def pbe():
    return TorchBackend(device="cpu")


@pytest.fixture(autouse=True)
def _device_rs_on(monkeypatch):
    monkeypatch.delenv("HBBFT_TPU_NO_DEVICE_RS", raising=False)


def _billing(be, fn):
    """fn()'s result, with the dispatches it added and the device-time
    kinds it moved."""
    before = be.counters.snapshot()
    out = fn()
    after = be.counters.snapshot()
    moved = {k for k in _KINDS if after[f"device_seconds_{k}"] > before[f"device_seconds_{k}"]}
    return out, after["device_dispatches"] - before["device_dispatches"], moved


def _both(tbe, pbe, method, *args, **kw):
    """The port's and the reference's plane on the same inputs: equal
    results, dispatches and kinds; returns the port's result."""
    got, d_got, k_got = _billing(pbe, lambda: getattr(pbe, method)(*args, **kw))
    want, d_want, k_want = _billing(tbe, lambda: getattr(tbe, method)(*args, **kw))
    assert (d_got, k_got) == (d_want, k_want), method
    return got, want


# ---------------------------------------------------------------------------
# GF(2⁸): the bit expansion, the plain product, the codec
# ---------------------------------------------------------------------------


def test_expand_gf_matrix_equals_the_reference():
    rs = np.random.default_rng(0)
    for r, k in ((1, 1), (3, 5), (10, 6)):
        m = rs.integers(0, 256, size=(r, k), dtype=np.uint8)
        assert np.array_equal(G.expand_gf_matrix(m), ref_expand(m))


@pytest.mark.parametrize("r,k", [(1, 1), (3, 4), (3, 5), (66, 34), (2, 256)])
def test_packed_words_hold_the_reference_bit_matrix(r, k):
    """``pack_gf_matrix``: ⌈k/4⌉ little-endian words a bit row, bit t of
    word w = bit column 32·w + t, zero past 8k."""
    m = np.random.default_rng(r * k).integers(0, 256, size=(r, k), dtype=np.uint8)
    words = G.pack_gf_matrix(m)
    assert words.dtype == np.int32 and words.shape == (8 * r, -(-k // 4))
    want = ref_expand(m)
    assert np.array_equal(G.unpack_gf_words(torch.as_tensor(words), k).numpy(), want)
    col = 8 * k - 1  # the last bit column, by hand
    assert np.array_equal((words[:, col // 32].view(np.uint32) >> (col % 32)) & 1, want[:, col])
    tail = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")[:, 8 * k:]
    assert not tail.any()


@pytest.mark.parametrize("r,k,L", [(0, 3, 5), (2, 3, 5), (7, 11, 33), (66, 34, 900)])
def test_gf256_plain_product_equals_the_host_codec(r, k, L):
    rs = np.random.default_rng(r + k + L)
    m = rs.integers(0, 256, size=(r, k), dtype=np.uint8)
    x = rs.integers(0, 256, size=(k, L), dtype=np.uint8)
    before = G.gf256_matmul.launches
    got = G.gf256_matmul(torch.as_tensor(G.pack_gf_matrix(m)), torch.as_tensor(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (r, L)
    assert np.array_equal(got.numpy(), gf256().matmul(m, x))
    assert G.gf256_matmul.launches == before  # a CPU tensor runs the plain version


def test_gf256_matmul_refuses_bad_operands():
    words = torch.zeros((16, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        G.gf256_matmul(words, torch.zeros((4, 5), dtype=torch.uint8))  # ⌈k/4⌉ ≠ 2
    with pytest.raises(ValueError):
        G.gf256_matmul(words.to(torch.int8), torch.zeros((5, 5), dtype=torch.uint8))
    with pytest.raises(ValueError):  # 8r rows
        G.gf256_matmul(words[:12], torch.zeros((5, 5), dtype=torch.uint8))


def test_torch_codec_equals_jax_codec():
    rng = random.Random(1)
    for k, m in ((2, 2), (3, 2), (10, 4)):
        host, ref, dev = RSCodec(k, m), JaxRSCodec(k, m), G.TorchRSCodec(k, m, device="cpu")
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 200)))
        shards = dev.encode(data)
        assert shards == ref.encode(data) == host.encode(data)
        erased = list(shards)
        for idx in rng.sample(range(k + m), m):
            erased[idx] = None
        assert dev.reconstruct(list(erased)) == ref.reconstruct(list(erased)) == shards
        assert dev.decode_data(erased, len(data)) == data
    # shards interoperate with the host codec's
    shards = RSCodec(5, 3).encode(bytes(range(97)))
    erased = [None, shards[1], shards[2], None, shards[4], shards[5], None, shards[7]]
    assert G.TorchRSCodec(5, 3, device="cpu").decode_data(erased, 97) == bytes(range(97))


def test_decode_cache_capacity_and_lru_eviction():
    c = G.DecodeMatrixCache(capacity=2, device="cpu")
    p1, p2, p3 = ((0, 1, 2), (3,)), ((0, 1, 3), (2,)), ((0, 2, 3), (1,))
    c.get(*p1)
    c.get(*p2)
    assert len(c) == 2
    c.get(*p1)  # touching p1 makes p2 the LRU victim of the next insert
    c.get(*p3)
    assert len(c) == 2, "capacity bound violated"
    assert list(c.keys()) == [p1, p3], "eviction is not least-recently-used"


def test_decode_cache_hit_returns_same_constant(pbe):
    c = G.DecodeMatrixCache(capacity=4, device="cpu")
    xs, missing = (0, 2, 4), (1, 3)
    first = c.get(xs, missing)
    assert c.get(list(xs), list(missing)) is first, "a hit must reuse the placed constant"
    want = ref_expand(gf256().lagrange_matrix(list(xs), list(missing)))
    assert first.device == torch.device("cpu") and first.dtype == torch.int32
    assert np.array_equal(G.unpack_gf_words(first, len(xs)).numpy(), want)
    assert G.TorchRSCodec._DECODE_CACHE_MAX == JaxRSCodec._DECODE_CACHE_MAX == 64
    assert G.TorchRSCodec(3, 2, device="cpu")._decode_cache.capacity == 64
    assert pbe._rs_dec_cache.capacity == 64 and pbe._rs_dec_cache.device == pbe.device


# ---------------------------------------------------------------------------
# The plane: RS parity fuzz against the reference and the host default
# ---------------------------------------------------------------------------

_CODEC_SHAPES = [(3, 2), (6, 10)]


def test_rs_encode_parity_fuzz(tbe, pbe):
    rng = random.Random(7)
    for k, m in _CODEC_SHAPES:
        codec, ref_codec = RSCodec(k, m), RefRSCodec(k, m)
        for lens in ((0, 7, 7, 17), (64, 1, 7)):  # several shard lengths: one dispatch each
            datas = [bytes(rng.randrange(256) for _ in range(n)) for n in lens]
            got, d_got, k_got = _billing(pbe, lambda: pbe.rs_encode_batch(codec, datas))
            want, d_want, k_want = _billing(tbe, lambda: tbe.rs_encode_batch(ref_codec, datas))
            assert got == want == CryptoBackend.rs_encode_batch(pbe, codec, datas)
            assert (d_got, k_got) == (d_want, k_want) == (len(set(
                codec.shard_length(n) for n in lens)), {"rs_enc"})


def test_rs_reconstruct_parity_fuzz(tbe, pbe):
    rng = random.Random(13)
    for k, m in _CODEC_SHAPES:
        codec, ref_codec = RSCodec(k, m), RefRSCodec(k, m)
        lists = []
        for blen in (24, 24, 7, 0, 24):  # repeats exercise pattern grouping
            shards = list(codec.encode(bytes(rng.randrange(256) for _ in range(blen))))
            for j in rng.sample(range(codec.n), rng.randrange(0, m + 1)):
                shards[j] = None  # ≤ m erasures, the all-present case included
            lists.append(shards)
        lists.append(list(codec.encode(b"all present")))
        got, d_got, k_got = _billing(pbe, lambda: pbe.rs_reconstruct_batch(codec, lists))
        want, d_want, k_want = _billing(tbe, lambda: tbe.rs_reconstruct_batch(ref_codec, lists))
        assert got == want == [codec.reconstruct(list(s)) for s in lists]
        assert (d_got, k_got) == (d_want, k_want) and d_got > 0 and k_got == {"rs_dec"}


def test_rs_reconstruct_error_cases_match_host(tbe, pbe):
    codec, ref_codec = RSCodec(3, 2), RefRSCodec(3, 2)
    enc = codec.encode(b"hello world!")
    few = [None, None, None, enc[3], enc[4]]  # too few present shards
    for be, c in ((pbe, codec), (tbe, ref_codec)):
        with pytest.raises(ValueError, match="need 3 shards"):
            be.rs_reconstruct_batch(c, [list(enc), few])
        with pytest.raises(ValueError, match="expected 5 shard slots"):
            be.rs_reconstruct_batch(c, [enc[:4]])
    # ragged present shards: the host stack raises on both planes
    ragged = [enc[0], enc[1] + b"x", enc[2], None, enc[4]]
    with pytest.raises(ValueError):
        pbe.rs_reconstruct_batch(codec, [ragged])
    with pytest.raises(ValueError):
        tbe.rs_reconstruct_batch(ref_codec, [ragged])


def test_rs_encode_without_parity_is_the_host_default(tbe, pbe):
    codec, ref_codec = RSCodec(3, 0), RefRSCodec(3, 0)
    got, d, kinds = _billing(pbe, lambda: pbe.rs_encode_batch(codec, [b"abcdef", b"x"]))
    assert got == tbe.rs_encode_batch(ref_codec, [b"abcdef", b"x"]) and (d, kinds) == (0, set())


# ---------------------------------------------------------------------------
# The plane: Merkle build and verify
# ---------------------------------------------------------------------------


def _shard_lists(rng, trees, n, leaf_len):
    return [[bytes(rng.randrange(256) for _ in range(leaf_len)) for _ in range(n)]
            for _ in range(trees)]


@pytest.mark.parametrize("n", [8, 6])
def test_merkle_build_and_verify_parity(tbe, pbe, n):
    """A power of two and a padded tree: the device levels equal the host
    tree's and the reference plane's; the proof walk agrees with both on
    every row, one tree's roots corrupted."""
    rng = random.Random(5 + n)
    sls = _shard_lists(rng, trees=3, n=n, leaf_len=13)
    dev, ref = _both(tbe, pbe, "merkle_build_batch", sls)
    for sl, d, r in zip(sls, dev, ref):
        assert d.levels == r.levels == MerkleTree(list(sl)).levels
        assert d.leaves == list(sl)
    packed = PackedProofs.from_trees(dev, n, device=True)
    ref_packed = RefPacked.from_trees(ref, n, device=True)
    for name in ("leaves", "paths", "indices", "roots"):
        assert np.array_equal(getattr(packed, name), getattr(ref_packed, name))
    got, want = _both(tbe, pbe, "merkle_verify_batch", packed, reps=2)
    assert got == want == packed.validate(1) == [True] * 3 * n
    bad_roots = np.array(packed.roots, copy=True)
    bad_roots[n : 2 * n] ^= 1
    bad = PackedProofs(packed.leaves, packed.paths, packed.indices, bad_roots, n)
    ref_bad = RefPacked(packed.leaves, packed.paths, packed.indices, bad_roots, n)
    got = pbe.merkle_verify_batch(bad)
    assert got == tbe.merkle_verify_batch(ref_bad) == bad.validate(1)
    assert got == [True] * n + [False] * n + [True] * n


def test_merkle_verify_bills_one_dispatch_a_repetition(tbe, pbe):
    rng = random.Random(2)
    trees = [MerkleTree(sl) for sl in _shard_lists(rng, trees=2, n=4, leaf_len=9)]
    packed = PackedProofs.from_trees(trees, 4, device=True)
    for reps in (1, 3):
        _, d, kinds = _billing(pbe, lambda: pbe.merkle_verify_batch(packed, reps=reps))
        _, d_ref, k_ref = _billing(tbe, lambda: tbe.merkle_verify_batch(packed, reps=reps))
        assert (d, kinds) == (d_ref, k_ref) == (reps, {"merkle"})


def test_merkle_build_falls_back_on_ragged_batches(tbe, pbe):
    """Trees of different shapes build in one device dispatch a (leaf
    count, leaf length), where the reference plane takes the host loop for
    the whole batch; only a tree whose own leaves differ in length, or an
    empty one, takes the host loop.  The trees are the reference's and the
    host's either way."""
    cases = (
        ([[b"aa", b"bb", b"cc"], [b"dd", b"ee"], [b"fff", b"ggg"], [b"hh", b"ii"]], 3),
        ([[b"aa", b"b"], [b"cc", b"dd"]], 1),
    )
    for sls, dispatches in cases:
        dev, d, kinds = _billing(pbe, lambda: pbe.merkle_build_batch(sls))
        ref, d_ref, _ = _billing(tbe, lambda: tbe.merkle_build_batch(sls))
        assert (d, kinds, d_ref) == (dispatches, {"merkle"}, 0)
        assert [t.levels for t in dev] == [t.levels for t in ref] == [
            MerkleTree(sl).levels for sl in sls]
    for be in (pbe, tbe):
        with pytest.raises(ValueError, match="empty tree"):
            be.merkle_build_batch([[b"aa"], []])


def test_from_trees_device_flag_skips_native_gates():
    """device=True packs shapes the native kernel refuses (leaf + tag >
    4,096 bytes); ragged trees are still refused."""
    leaves = [bytes(range(256)) * 20] * 4  # 5,120-byte leaves
    trees = [MerkleTree(leaves)] * 2
    assert PackedProofs.from_trees(trees, 4, device=False) is None
    packed = PackedProofs.from_trees(trees, 4, device=True)
    assert packed is not None and len(packed) == 8
    ref = RefPacked.from_trees([RefTree(leaves)] * 2, 4, device=True)
    assert np.array_equal(packed.paths, ref.paths) and np.array_equal(packed.leaves, ref.leaves)
    assert PackedProofs.from_trees([], 4, device=True) is None
    ragged = [MerkleTree([b"ab", b"cd"]), MerkleTree([b"ab", b"c"])]
    assert PackedProofs.from_trees(ragged, 2, device=True) is None


# ---------------------------------------------------------------------------
# Kill switch: HBBFT_TPU_NO_DEVICE_RS=1 is the host path, bit for bit
# ---------------------------------------------------------------------------


def test_kill_switch_restores_host_path(pbe, monkeypatch):
    monkeypatch.setenv("HBBFT_TPU_NO_DEVICE_RS", "1")
    rng = random.Random(3)
    codec = RSCodec(3, 2)
    datas = [bytes(rng.randrange(256) for _ in range(20)) for _ in range(4)]
    sls = _shard_lists(rng, trees=2, n=4, leaf_len=9)
    before = pbe.counters.snapshot()
    enc = pbe.rs_encode_batch(codec, datas)
    holes = [list(e) for e in enc]
    holes[1][0] = None
    rec = pbe.rs_reconstruct_batch(codec, holes)
    trees = pbe.merkle_build_batch(sls)
    packed = PackedProofs.from_trees([MerkleTree(list(sl)) for sl in sls], 4, device=True)
    verdicts = pbe.merkle_verify_batch(packed, reps=2)
    after = pbe.counters.snapshot()
    assert after["device_dispatches"] == before["device_dispatches"], (
        "the kill switch must route every plane op to the host codec")
    for k in _KINDS:
        assert after[f"device_seconds_{k}"] == before[f"device_seconds_{k}"]
    assert enc == [codec.encode(d) for d in datas]
    assert rec == [codec.reconstruct(list(h)) for h in holes]
    assert [t.levels for t in trees] == [MerkleTree(list(sl)).levels for sl in sls]
    assert verdicts == [True] * len(packed)


# ---------------------------------------------------------------------------
# SHA-256: the plain version, the entry points, the kernel's node block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 9, 54, 55, 64, 118, 119, 200])
def test_plain_sha256_equals_hashlib(length):
    """Around the block-count steps: tag + 54 data bytes + 9 pad bytes fill
    one block, 55 need two; 118 two, 119 three."""
    rs = np.random.default_rng(length)
    msgs = rs.integers(0, 256, size=(3, length), dtype=np.uint8)
    for tag in (0, 1):
        got = S.sha256_tagged(torch.as_tensor(msgs), tag)
        assert [bytes(g) for g in got.numpy()] == [
            hashlib.sha256(bytes([tag]) + m.tobytes()).digest() for m in msgs]
    assert S.compressions(length) == len(ref_sha._pad_tagged(
        np.zeros((1, length), np.uint8), 0)[0])
    assert S.EMPTY_LEAF == hashlib.sha256(b"\x00").digest()


def test_entry_points_equal_the_reference():
    rs = np.random.default_rng(11)
    leaves = rs.integers(0, 256, size=(2, 6, 13), dtype=np.uint8)
    got = S.tree_levels(torch.as_tensor(leaves))
    want = ref_sha.tree_levels(leaves)
    assert [tuple(g.shape) for g in got] == [(2, 8, 32), (2, 4, 32), (2, 2, 32), (2, 1, 32)]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    flat = torch.as_tensor(leaves.reshape(12, 13))
    assert np.array_equal(S.leaf_hashes(flat).numpy(), got[0][:, :6].reshape(12, 32).numpy())
    left, right = got[0][:, 0::2].reshape(8, 32), got[0][:, 1::2].reshape(8, 32)
    assert np.array_equal(S.node_hashes(left, right).numpy(), got[1].reshape(8, 32).numpy())


def test_plain_proof_walk_equals_the_reference():
    rng = random.Random(4)
    trees = [MerkleTree(sl) for sl in _shard_lists(rng, trees=2, n=5, leaf_len=9)]
    p = PackedProofs.from_trees(trees, 5, device=True)
    roots = np.array(p.roots, copy=True)
    roots[3, 7] ^= 0x40
    leaves = np.array(p.leaves, copy=True)
    leaves[8, 0] ^= 1
    args = (leaves, p.paths, p.indices, roots)
    got = S.verify_proofs(*(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.bool
    assert got.tolist() == np.asarray(ref_sha.verify_proofs(*args)).tolist() == [
        i not in (3, 8) for i in range(10)]


def test_kernel_node_block_layout():
    """csrc/sha256.cu hashes a node from digest words, not bytes: block 1
    is the tag byte and the 64 bytes of L ‖ R shifted right by one byte,
    block 2 the last byte, 0x80 and the 520-bit length.  The same words,
    fed to the plain compression, give hashlib's node hash."""
    rs = np.random.default_rng(6)
    L, R = (rs.integers(0, 256, size=32, dtype=np.uint8).tobytes() for _ in range(2))
    a = [int.from_bytes((L + R)[4 * j : 4 * j + 4], "big") for j in range(16)]
    w1 = [0x01000000 | (a[0] >> 8)] + [((a[j - 1] << 24) | (a[j] >> 8)) & 0xFFFFFFFF
                                       for j in range(1, 16)]
    w2 = [((a[15] << 24) | 0x00800000) & 0xFFFFFFFF] + [0] * 14 + [65 * 8]
    state = torch.tensor([S._H0], dtype=torch.int64)
    for w in (w1, w2):
        state = S._compress(state, torch.tensor([w], dtype=torch.int64))
    assert bytes(S._digest_bytes(state)[0].numpy()) == hashlib.sha256(b"\x01" + L + R).digest()


def test_sha256_wrappers_refuse_bad_operands():
    with pytest.raises(ValueError):
        S.sha256_tagged(torch.zeros((2, 3), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        S.sha256_tagged(torch.zeros((2, 3), dtype=torch.uint8), 256)
    z = torch.zeros
    with pytest.raises(ValueError):  # paths are not (P, depth, 32)
        S.sha256_proofs(z((2, 4), dtype=torch.uint8), z((2, 3, 31), dtype=torch.uint8),
                        z(2, dtype=torch.int32), z((2, 32), dtype=torch.uint8))
