"""The tensor-core Montgomery body of the card, emulated on the CPU.

``fq_rns_mul`` and ``miller_dbl`` run their base extensions as int8
``mma.sync.m16n8k32`` products (``mul_warp`` in
``hbbft_tpu_torch/csrc/fq_rns_core.cuh``).  The card alone runs that code,
so these tests pin what it relies on:

* the int8 constant planes the wrapper packs (``_pack_tc_planes``) are
  the extension matrices' 6-bit/5-bit planes, every value in [0, 63],
  in the B-fragment order the kernel reads;
* an int64 emulation of the kernel's plane products — the per-warp tile
  bytes (WARP_M rows), the A fragments as ``load_afrag`` reads them, the
  B fragments as ``ext_tile`` reads them, the m16n8k32 fragment layout of
  the PTX ISA —
  gives the very ll, mid and hh that ``_split_dot``'s float partials
  hold, for random operands, 0, p−1 and planes all at their maximum;
* a float32 emulation of the whole warp body (stage by stage, in the
  tile layout) equals the plain version ``mul_plain`` bit for bit.

Tolerance 0: every stage is exact integer arithmetic.  The plain version
is held against the JAX package's Pallas kernel by test_torch_field.py.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K

torch.set_num_threads(1)

NB, NL, NE = R.N_B, R.NLIMBS, 40
CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
PLANES = {"e1": (R._E1_LO, R._E1_HI), "e2": (R._E2_LO, R._E2_HI)}
#: tasks of one warp pass (rows of its tile): m-tiles of 16
M = int(re.search(r"#define WARP_M (\d+)", (CSRC / "fq_rns_core.cuh").read_text()).group(1))


def test_tc_planes_are_the_extension_planes():
    """Unpacked by the fragment rule written out here (lane = 4g + t
    holds column 8·nt + g and rows 32·ks + 16·reg + 4t + byte), the packed
    bytes are E_lo and E_hi of both extensions, zero in the K padding."""
    packed = K._KPLANES.reshape(4, K.TC_NT, K.TC_KS, K.TC_REGS, 32, 4).astype(np.int64)
    assert packed.min() >= 0 and packed.max() <= 63
    want = [R._E1_LO, R._E1_HI, R._E2_LO, R._E2_HI]
    for q, plane in enumerate(want):
        got = np.zeros((64, NE), dtype=np.int64)
        for nt in range(K.TC_NT):
            for ks in range(K.TC_KS):
                for reg in range(K.TC_REGS):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        for byte in range(4):
                            got[32 * ks + 16 * reg + 4 * t + byte, 8 * nt + g] = \
                                packed[q, nt, ks, reg, lane, byte]
        assert np.array_equal(got[:NB], plane.astype(np.int64))
        assert not got[NB:].any()
    # E = E_lo + 64·E_hi: the planes recombine to the extension matrices
    assert np.array_equal(R._E1_LO + 64 * R._E1_HI, R._E1.astype(np.float32))


def test_tc_layout_matches_the_kernel_source():
    """The header's tiling constants are the wrapper's, and both CUDA
    sources that run the body check the plane count at load."""
    src = (CSRC / "fq_rns_core.cuh").read_text()
    defs = dict(re.findall(r"#define (TC_\w+) \(?(\d+)\)?", src))
    assert int(defs["TC_NT"]) == K.TC_NT and int(defs["TC_KS"]) == K.TC_KS
    tc_words = 2 * 2 * K.TC_NT * K.TC_KS * K.TC_REGS * 32
    assert "#define TC_WORDS (2 * 2 * TC_NT * TC_KS * 2 * 32)" in src
    assert tc_words * 4 == K._KPLANES.size
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert M in (16, 32)  # whole m-tiles, at most one row per lane
    for cu in ("fq_rns.cu", "tower_fused.cu"):
        assert "TC_BYTES" in (CSRC / cu).read_text()


# -- the emulation ------------------------------------------------------------


def _words(tile_bytes: np.ndarray) -> np.ndarray:
    """An (M, 79·4) uint8 tile as its (M, 79) little-endian 32-bit words."""
    return tile_bytes.reshape(M, NL, 4).astype(np.int64) @ (256 ** np.arange(4))


def _bytes_of(word: int) -> list:
    return [(int(word) >> (8 * i)) & 0xFF for i in range(4)]


def _s8(v: int) -> int:
    return v - 256 if v > 127 else v


def _mma(a_regs, b_regs):
    """mma.sync.m16n8k32.row.col s8·s8 → s32 for one warp, by the PTX ISA
    fragment layout: a_regs[lane] four words, b_regs[lane] two; returns
    d[lane] four s32 (row g + 8·(c // 2), column 2t + c % 2)."""
    A = np.zeros((16, 32), dtype=np.int64)
    B = np.zeros((32, 8), dtype=np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q in range(4):
            for i, v in enumerate(_bytes_of(a_regs[lane][q])):
                A[g + 8 * (q & 1), 4 * t + i + 16 * (q >> 1)] = _s8(v)
        for q in range(2):
            for i, v in enumerate(_bytes_of(b_regs[lane][q])):
                B[4 * t + i + 16 * q, g] = _s8(v)
    D = A @ B
    return [[D[lane // 4 + 8 * (c >> 1), 2 * (lane % 4) + (c & 1)] for c in range(4)]
            for lane in range(32)]


def _plane_words(ext: int) -> np.ndarray:
    """One extension's plane words [plane][nt][ks][reg][lane], as the
    kernel's shared copy holds them."""
    w = K._KPLANES.view(np.uint8).reshape(2, -1, 4).astype(np.int64) @ (256 ** np.arange(4))
    return w[ext].reshape(2, K.TC_NT, K.TC_KS, K.TC_REGS, 32)


def _ext_partials(tile_bytes: np.ndarray, ext: int):
    """ll, mid and hh (M rows × 40 outputs) as the kernel computes them:
    load_afrag's word reads of the tile, ext_tile's B words, four mma
    products per k-step."""
    W = _words(tile_bytes)
    PW = _plane_words(ext)
    out = {k: np.zeros((M, NE), dtype=np.int64) for k in ("ll", "mid", "hh")}
    for mt in range(M // 16):
        afr = {}
        for lane in range(32):
            g, t = divmod(lane, 4)
            r0, r1 = W[mt * 16 + g], W[mt * 16 + g + 8]
            for ks in range(K.TC_KS):
                w = ks * 8 + t
                afr[lane, ks] = ([r0[w], r1[w], r0[w + 4], r1[w + 4]],
                                 [r0[w + 16], r1[w + 16], r0[w + 20], r1[w + 20]])
        for nt in range(K.TC_NT):
            acc = {k: [[0] * 4 for _ in range(32)] for k in out}
            for ks in range(K.TC_KS):
                lo = [[PW[0, nt, ks, 0, ln], PW[0, nt, ks, 1, ln]] for ln in range(32)]
                hi = [[PW[1, nt, ks, 0, ln], PW[1, nt, ks, 1, ln]] for ln in range(32)]
                a_lo = [afr[ln, ks][0] for ln in range(32)]
                a_hi = [afr[ln, ks][1] for ln in range(32)]
                for name, pairs in (("ll", [(a_lo, lo)]), ("mid", [(a_hi, lo), (a_lo, hi)]),
                                    ("hh", [(a_hi, hi)])):
                    for a_regs, b_regs in pairs:
                        d = _mma(a_regs, b_regs)
                        for ln in range(32):
                            for c in range(4):
                                acc[name][ln][c] += d[ln][c]
            for ln in range(32):
                g, t = divmod(ln, 4)
                for c in range(4):
                    row, j = mt * 16 + g + 8 * (c >> 1), nt * 8 + 2 * t + (c & 1)
                    for name in out:
                        out[name][row, j] = acc[name][ln][c]
    return out["ll"], out["mid"], out["hh"]


def _put_planes(tile_bytes: np.ndarray, v: np.ndarray) -> None:
    """put_planes for every (row, k < 39): lo at byte k, hi at 64 + k."""
    iv = v.astype(np.int64)
    tile_bytes[:, :NB] = iv & 63
    tile_bytes[:, 64 : 64 + NB] = iv >> 6


def _partials_case(case: str, ext: int) -> np.ndarray:
    rng = np.random.default_rng(7 + ext)
    p = np.asarray(R.B1 if ext == 0 else R.B2, dtype=np.int64)
    if case == "random":
        return rng.integers(0, p, size=(M, NB))
    if case == "zero":
        return np.zeros((M, NB), dtype=np.int64)
    if case == "p-1":
        return np.broadcast_to(p - 1, (M, NB)).copy()
    return np.full((M, NB), 63 + 64 * 31, dtype=np.int64)  # both planes at their maximum


@pytest.mark.parametrize("case", ["random", "zero", "p-1", "planes-max"])
@pytest.mark.parametrize("ext", [0, 1])
def test_fragment_products_equal_the_float_partials(case, ext):
    """ll, mid and hh from the emulated int8 fragments equal the plain
    version's float32 partials (``_plane_partials``, the sums _split_dot
    reduces) as integers."""
    v = _partials_case(case, ext)
    tile = np.zeros((M, NL * 4), dtype=np.uint8)
    tile[:, 4 * NB :] = 0xAB  # words 39..78 hold other data in the kernel
    _put_planes(tile, v)
    got = _ext_partials(tile, ext)
    lo, hi = (torch.as_tensor(m) for m in PLANES["e1" if ext == 0 else "e2"])
    want = K._plane_partials(torch.as_tensor(v.astype(np.float32)), lo, hi)
    for g, w in zip(got, want):
        assert w.abs().max() < 2**19
        assert np.array_equal(g, w.numpy().astype(np.int64))


def _f32(x):
    return np.float32(x)


def _loose(x, p, ip):
    x, p, ip = (np.asarray(v, dtype=np.float32) for v in (x, p, ip))
    return (x - np.floor((x * ip).astype(np.float32)) * p).astype(np.float32)


def _lanes(x, p, ip):
    p = np.asarray(p, dtype=np.float32)
    x = _loose(x, p, ip)
    x = (x - p * (x >= p)).astype(np.float32)
    return (x + p * (x < 0)).astype(np.float32)


def emulate_mul_warp(a: np.ndarray, b: np.ndarray, reduced: bool) -> np.ndarray:
    """mul_warp for M tasks (rows of a and b), stage by stage in the tile
    layout of csrc/fq_rns_core.cuh, in float32."""
    c = K._PLAIN
    P, IP = c["p"], c["ip"]
    tile = np.zeros((M, NL * 4), dtype=np.uint8)
    fl = tile.view(np.float32)  # (M, 79) words as floats
    # staging
    if not reduced:
        a, b = _loose(a, P, IP), _loose(b, P, IP)
    x = (_loose((a * b).astype(np.float32), P, IP) + c["xoff"]).astype(np.float32)
    _put_planes(tile, _lanes((x[:, :NB] * c["sigc"]).astype(np.float32), P[:NB], IP[:NB]))
    fl[:, NB:] = x[:, NB:]
    # extension 1, canonical q-hat, r2r in place
    ll, mid, hh = _ext_partials(tile, 0)
    p2, ip2 = P[NB:], IP[NB:]
    rec = (ll.astype(np.float32) + _f32(64) * _loose(mid.astype(np.float32), p2, ip2)
           + _f32(4096) * _lanes(hh.astype(np.float32), p2, ip2)).astype(np.float32)
    qh = _lanes(rec, p2, ip2)
    fl[:, NB:] = _loose((fl[:, NB:] * c["m1inv"] + qh * c["qm1inv"]).astype(np.float32),
                        p2, ip2)
    # xi planes (bytes 0..38 / 64..102; the padding stays zero)
    xi = _lanes((fl[:, NB : 2 * NB] * c["w2inv"]).astype(np.float32), p2[:NB], ip2[:NB])
    _put_planes(tile, xi)
    # extension 2, loose raw, delta from column 39, r1 in place
    ll, mid, hh = _ext_partials(tile, 1)
    pb, ipb = c["pb1r"], c["ipb1r"]
    rec = (ll.astype(np.float32) + _f32(64) * _loose(mid.astype(np.float32), pb, ipb)
           + _f32(4096) * _lanes(hh.astype(np.float32), pb, ipb)).astype(np.float32)
    raw = _loose(rec, pb, ipb)
    delta = _lanes(((raw[:, NB] - fl[:, NL - 1]) * np.float32(K._M2INV_R)).astype(np.float32),
                   256.0, 1.0 / 256.0)
    fl[:, :NB] = _loose((raw[:, :NB] - delta[:, None] * c["m2b1"]).astype(np.float32),
                        P[:NB], IP[:NB])
    return fl.copy()


def _lazy_rows(seed: int, n: int):
    rng = random.Random(seed)
    xs = [rng.randrange(Q) for _ in range(n)]
    xs[:2] = [0, Q - 1]
    base = R.from_ints(xs)
    h = n // 2
    rows = np.concatenate([base[:h], base[:h] - base[h : 2 * h], -base[:1] * 8191,
                           base[h : n - 1] + base[:1]])[:n]
    return rows.astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_emulated_warp_body_equals_the_plain_version(reduced):
    a, b = _lazy_rows(3, M), _lazy_rows(4, M)
    if reduced:  # reduced operands are products
        a = K.mul_plain(torch.as_tensor(a), torch.as_tensor(a)).numpy()
        b = K.mul_plain(torch.as_tensor(b), torch.as_tensor(b)).numpy()
    got = emulate_mul_warp(a, b, reduced)
    want = K.mul_plain(torch.as_tensor(a), torch.as_tensor(b), reduced=reduced).numpy()
    assert np.array_equal(got, want)
    assert R.to_ints(torch.as_tensor(got[:4])) == R.to_ints(
        K.mul_plain(torch.as_tensor(a[:4]), torch.as_tensor(b[:4]), reduced=reduced))


def test_one_row_operands_take_lane_stride_zero():
    """``mul`` reads a (79,) or (1, 79) operand in place (stride 0) and
    expands any other broadcast (stride 79)."""
    rows = torch.zeros((5, NL))
    one = torch.zeros(NL)
    assert K._lane_operand(one, rows.shape)[1] == 0
    assert K._lane_operand(one[None], rows.shape)[1] == 0
    assert K._lane_operand(rows, rows.shape)[1] == NL
    t, s = K._lane_operand(torch.zeros((1, 2, NL)), (3, 2, NL))
    assert s == NL and t.shape == (3, 2, NL) and t.is_contiguous()
