"""The limb kernels' team body, emulated on the CPU.

``fq_limb_mul`` and ``fq_limb_pow`` run one body in
``hbbft_tpu_torch/csrc/fq_limb.cu``: a team of four threads a product,
the convolution's columns dealt in ranges, carries handed on by shuffles,
fold 1 as ``mma.sync.m16n8k32`` s8 x u8 products of signed 8-bit planes.
The multiply runs it as ``limb_team`` (8 lanes a warp); the power gives
each lane a warp, deals the convolution's chunks over its 8 teams
(``conv_warp``) and runs the rest (``limb_tail``) in every team alike.
The card alone runs that code, so these tests pin what it relies on, with
the layout constants read from the source:

* the columns dealt to each thread and the chunk schedule cover every
  product a_i·b_j exactly once, in column i + j, inside the padded rows;
  the power's warp runs each thread's chunks once, one a thread;
  the carry handoffs (ranges and the fold layout) equal ``carry3``;
* the int8 plane split of the fold inputs and the u8 weight fragments in
  the m16n8k32 layout; an int64 emulation of the fold products (columns
  48..97; the top column takes the float32 pipe) equals the float fold of
  ``mul_plain``;
* the derived bounds on the fold inputs: columns 48..97 in [-1, 257]
  whatever the operands, the top column at extreme lazy inputs, and the
  s32 / float32-exact envelopes that rest on them;
* a float32 emulation of the whole team body, warp by warp, equals
  ``mul_plain`` / ``pow_plain`` bit for bit, at a few lanes plus padding
  lanes.

Tolerance 0: every stage is exact integer arithmetic.  The plain versions
are held against the JAX package's Pallas kernels by test_torch_fq_limb.py.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq_limb as L, fq_limb_cuda as LK

torch.set_num_threads(1)

SRC = (Path(LK.__file__).resolve().parent.parent / "csrc" / "fq_limb.cu").read_text()
D = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\b", SRC)}
NLB, NCV, FF, NF = D["NLB"], D["NCV"], D["FF"], D["NF"]
TEAM, LPW, CW, NCH, HSHIFT, TOP_M = (D[k] for k in ("TEAM", "LPW", "CW", "NCH", "HSHIFT",
                                                     "TOP_M"))
NTL, KSL, APAD = D["NTL"], D["KSL"], D["APAD"]
A_OFF, B_OFF, B_LEN, C_OFF, X_OFF, P_OFF = (D[k] for k in ("A_OFF", "B_OFF", "B_LEN", "C_OFF",
                                                          "X_OFF", "P_OFF"))
NS = 2 * NTL
A_LEN = B_OFF - A_OFF  # a's padded row: indices [-APAD, A_LEN - APAD)
FOLD_T = L.FOLD_ROWS.T.astype(np.float32)  # (50, 51): the kernel's FOLD_T
F32 = np.float32


def _src_has(*lines):
    flat = " ".join(SRC.split())
    for line in lines:
        assert " ".join(line.split()) in flat, line


def test_layout_constants_match_the_source_and_the_wrapper():
    assert (NLB, NCV, FF, NF) == (L.NLIMBS, L.CONV, L.FOLD_FROM, L.CONV - L.FOLD_FROM)
    assert LPW == LK.LANES_PER_WARP and D["MAX_WARPS"] == LK.MAX_WARPS
    assert TEAM * LPW == 32  # a warp is 8 teams: the A tile's rows 0-7
    assert 2 * TEAM * CW >= NCV and NTL * 8 >= NLB and KSL * 32 >= NF
    assert TOP_M == NCV - 1 - CW * (2 * TEAM - 1)
    # the regions: a, b, the convolution and the power's base do not overlap
    assert A_OFF + A_LEN <= B_OFF and B_OFF + B_LEN <= C_OFF
    assert C_OFF + 2 * TEAM * CW <= X_OFF and X_OFF + B_LEN <= P_OFF
    assert P_OFF + NCH * TEAM * CW <= D["POW_RS"]
    assert C_OFF + 2 * TEAM * CW <= D["MUL_RS"]
    assert D["MUL_RS"] % 32 == 4  # the multiply's 8 regions a warp (conv_team's banks)
    assert NCH <= LPW  # the power's warp: one chunk a thread, in teams 0..NCH-1
    _src_has(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32",
        "const int k0 = first ? CW * t : CW * (t + TEAM);",
        "const int j0 = first ? CW * c : CW * c - HSHIFT;",
        "const float* w = A + APAD + k0 - j0 - (CW - 1);",
        "acc[m] = fmaf(win[CW - 1 + m - d], bj, acc[m]);",
        "if (t == TEAM - 1) hh[TOP_M] = 0.f;",
        "const float cl = t ? rl : 0.f;",
        "const float ch = t ? rh : rl;",
        "if (t == 0) h[NS - 1] = 0.f;",
        "const float cin = t ? r[nt] : (nt ? r[nt - 1] : 0.f);",
        "const int f = 32 * ks + 16 * reg + 4 * t + q;",
        "const float v = f < NF - 1 ? C[FF + f] : 0.f;",
        "o[2 * nt + i] = fmaf(top, wt, i2f_w(128 * H[i] + L[i])) + (k < FF ? C[k] : 0.f);",
        "const int src = team_lane(lane, (t + TEAM - 1) & (TEAM - 1));",
        "conv_chunk(A, B, t, g, acc);",
        "for (int m = 0; m < CW; ++m) P[(g * TEAM + t) * CW + m] = acc[m];",
        "const float v = P[(c * TEAM + t) * CW + m];",
        "if (c <= t) lo[m] += v; else hi[m] += v;",
        "conv_warp(R + A_OFF, R + (square ? B_OFF : X_OFF), R + P_OFF, t, g, lo, hi);",
        "const long l0 = (long)blockIdx.x * (blockDim.x >> 5) + warp;",
    )


# -- the dealing of the convolution ------------------------------------------------


def _chunks(t):
    """(k0, j0) of thread t's chunks, as conv_team computes them."""
    out = []
    for c in range(NCH):
        first = c <= t
        out.append((CW * t if first else CW * (t + TEAM), CW * c if first else CW * c - HSHIFT))
    return out


def test_columns_dealt_cover_every_product_once():
    """Every (i, j) of the 50x50 convolution is met exactly once, by the
    thread that owns column i + j, in the range the chunk accumulates into;
    every read stays inside the padded rows."""
    seen = {}
    for t in range(TEAM):
        for c, (k0, j0) in enumerate(_chunks(t)):
            base = APAD + k0 - j0 - (CW - 1)
            assert 0 <= base and base + 2 * CW - 1 <= A_LEN  # the window
            assert 0 <= j0 and j0 + CW <= B_LEN  # b's reads
            rng = t if c <= t else t + TEAM
            for d in range(CW):
                for m in range(CW):
                    j = j0 + d
                    i = k0 + m - j
                    if 0 <= i < NLB and 0 <= j < NLB:
                        assert (i, j) not in seen
                        seen[(i, j)] = (t, rng, m)
    assert len(seen) == NLB * NLB
    for (i, j), (t, rng, m) in seen.items():
        assert CW * rng + m == i + j
        assert rng in (t, t + TEAM)
    # the work is balanced: every thread runs the same NCH chunks
    useful = [sum(1 for v in seen.values() if v[0] == t) for t in range(TEAM)]
    assert max(useful) - min(useful) <= 30 and sum(useful) == 2500


def test_the_power_warp_runs_each_chunk_once():
    """conv_warp deals chunk g of thread t to thread 4 g + t of the warp:
    the 32 threads run each (t, chunk) pair of the team's schedule once,
    no thread runs two, and each partial sum lands in the range conv_team
    would add it to."""
    runs = {}
    for ln in range(32):
        g, t = divmod(ln, TEAM)
        if g < NCH:
            runs[(t, g)] = ln
    assert sorted(runs) == [(t, c) for t in range(TEAM) for c in range(NCH)]
    assert len(set(runs.values())) == len(runs)
    rng = np.random.default_rng(3)
    A, B = padded(L.carry3(torch.from_numpy(_lazy(rng, 3))).numpy())  # carried rows
    for got, want in zip(conv_warp(A, B), conv_team(A, B)):
        assert np.array_equal(got, want)


# -- the emulation -------------------------------------------------------------------


def floor_div(x, inv):
    """floor_div: floor(x · inv) for a power of two inv, |x · inv| < 2^22,
    as one rounded-down FMA and an add (exact)."""
    y = x * inv
    assert np.all(np.abs(y) < 2.0**22)
    return np.floor(y).astype(F32)


def conv_chunk(A, B, t, c, acc):
    """conv_chunk: chunk c of thread t added into acc (lanes, CW)."""
    k0, j0 = _chunks(t)[c]
    base = APAD + k0 - j0 - (CW - 1)
    win = A[:, base:base + 2 * CW - 1]
    for d in range(CW):
        bj = B[:, j0 + d]
        for m in range(CW):
            acc[:, m] = acc[:, m] + win[:, CW - 1 + m - d] * bj
    return acc


def conv_team(A, B):
    """lo, hi (TEAM, lanes, CW): the multiply's chunk loop over padded rows
    A (lanes, A_LEN) and B (lanes, B_LEN)."""
    lanes = A.shape[0]
    lo = np.zeros((TEAM, lanes, CW), F32)
    hi = np.zeros((TEAM, lanes, CW), F32)
    for t in range(TEAM):
        acc = np.zeros((lanes, CW), F32)
        for c in range(NCH):
            acc = conv_chunk(A, B, t, c, acc)
            if c == t:
                lo[t], acc = acc, np.zeros_like(acc)
        hi[t] = acc
    return lo, hi


def conv_warp(A, B):
    """lo, hi as conv_warp gives them to every team: thread 4 g + t (g <
    NCH) writes chunk g of thread t to P, each team sums P in chunk order,
    chunks 0..t into lo and the rest into hi."""
    lanes = A.shape[0]
    P = np.zeros((NCH, TEAM, lanes, CW), F32)
    for g in range(LPW):
        for t in range(TEAM):
            if g < NCH:
                P[g, t] = conv_chunk(A, B, t, g, np.zeros((lanes, CW), F32))
    lo = np.zeros((TEAM, lanes, CW), F32)
    hi = np.zeros((TEAM, lanes, CW), F32)
    for t in range(TEAM):
        for c in range(NCH):
            if c <= t:
                lo[t] = lo[t] + P[c, t]
            else:
                hi[t] = hi[t] + P[c, t]
    return lo, hi


def carry_cols(lo, hi):
    """One pass of carry_cols for the whole team."""
    hl = floor_div(lo, F32(1 / 256))
    hh = floor_div(hi, F32(1 / 256))
    hh[TEAM - 1][:, TOP_M] = 0
    lo2, hi2 = np.empty_like(lo), np.empty_like(hi)
    for t in range(TEAM):
        rl, rh = hl[(t - 1) % TEAM][:, CW - 1], hh[(t - 1) % TEAM][:, CW - 1]  # shfl from t-1
        cl = rl if t else np.zeros_like(rl)
        ch = rh if t else rl
        for m in range(CW):
            lo2[t][:, m] = (lo[t][:, m] - F32(256) * hl[t][:, m]) + (hl[t][:, m - 1] if m else cl)
            hi2[t][:, m] = (hi[t][:, m] - F32(256) * hh[t][:, m]) + (hh[t][:, m - 1] if m else ch)
    return lo2, hi2


def p_limb(s, t):
    return 8 * (s >> 1) + 2 * t + (s & 1)


def carry_p(x):
    """One pass of carry_p: x (TEAM, lanes, NS) in the fold layout."""
    h = floor_div(x, F32(1 / 256))
    h[0][:, NS - 1] = 0
    out = np.empty_like(x)
    for t in range(TEAM):
        r = h[(t - 1) % TEAM][:, 1::2]  # shfl of each pair's top carry from t-1
        for nt in range(NTL):
            cin = r[:, nt] if t else (r[:, nt - 1] if nt else np.zeros_like(r[:, 0]))
            out[t][:, 2 * nt + 1] = (x[t][:, 2 * nt + 1] - F32(256) * h[t][:, 2 * nt + 1]
                                     + h[t][:, 2 * nt])
            out[t][:, 2 * nt] = (x[t][:, 2 * nt] - F32(256) * h[t][:, 2 * nt]) + cin
    return out


def carry3_p(x):
    return carry_p(carry_p(carry_p(x)))


def read_p(rows):
    """(lanes, 50) rows → (TEAM, lanes, NS) slots (zero past limb 49)."""
    out = np.zeros((TEAM, rows.shape[0], NS), F32)
    for t in range(TEAM):
        for s in range(NS):
            if p_limb(s, t) < NLB:
                out[t][:, s] = rows[:, p_limb(s, t)]
    return out


def write_p(x):
    rows = np.zeros((x.shape[1], NLB), F32)
    for t in range(TEAM):
        for s in range(NS):
            if p_limb(s, t) < NLB:
                rows[:, p_limb(s, t)] = x[t][:, s]
    return rows


def pw_words():
    """load_tables' fold-1 B fragments, word w = [nt][ks][reg][lane]."""
    words = np.zeros(NTL * KSL * 2 * 32, dtype=np.int64)
    for w in range(words.size):
        ln, reg, ks, nt = w & 31, (w >> 5) & 1, (w >> 6) % KSL, w // (64 * KSL)
        k = 8 * nt + (ln >> 2)
        word = 0
        for q in range(4):
            f = 32 * ks + 16 * reg + 4 * (ln & 3) + q
            v = int(FOLD_T[k][f]) if (f < NF - 1 and k < NLB) else 0
            assert 0 <= v <= 255
            word |= v << (8 * q)
        words[w] = word
    return words


def fw_table():
    """load_tables' float weights: fold rows 0, 1 and NF − 1 per slot."""
    fw = np.zeros((TEAM, NS, 4), F32)
    for t in range(TEAM):
        for s in range(NS):
            k = p_limb(s, t)
            if k < NLB:
                fw[t, s, :3] = FOLD_T[k][0], FOLD_T[k][1], FOLD_T[k][NF - 1]
    return fw


def split_planes(v):
    """The kernel's split: h = floor(v / 128), l = v − 128 h."""
    h = floor_div(v, F32(1 / 128))
    return v - F32(128) * h, h


def a_frags(C):
    """al, ah[t][ks][reg]: per thread (lanes,) words of packed s8 bytes."""
    lanes = C.shape[0]
    al = np.zeros((TEAM, KSL, 2, lanes), np.int64)
    ah = np.zeros_like(al)
    for t in range(TEAM):
        for ks in range(KSL):
            for reg in range(2):
                for q in range(4):
                    f = 32 * ks + 16 * reg + 4 * t + q
                    v = C[:, FF + f] if f < NF - 1 else np.zeros(lanes, F32)
                    lo, hi = split_planes(v)
                    assert np.all((0 <= lo) & (lo <= 127)) and np.all(np.abs(hi) <= 127)
                    al[t, ks, reg] |= (lo.astype(np.int64) & 0xFF) << (8 * q)
                    ah[t, ks, reg] |= (hi.astype(np.int64) & 0xFF) << (8 * q)
    return al, ah


def _bytes(word, signed):
    b = [(int(word) >> (8 * i)) & 0xFF for i in range(4)]
    return [x - 256 if signed and x > 127 else x for x in b]


def mma_s8u8(a_regs, b_regs):
    """mma.sync.m16n8k32.row.col s8·u8 → s32 for one warp, by the PTX ISA
    fragment layout: a_regs[lane] = (a0, a1, a2, a3), b_regs[lane] =
    (b0, b1); returns d[lane] (row g + 8·(c // 2), column 2t + c % 2)."""
    A = np.zeros((16, 32), dtype=np.int64)
    B = np.zeros((32, 8), dtype=np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q in range(4):
            for i, v in enumerate(_bytes(a_regs[lane][q], True)):
                A[g + 8 * (q & 1), 4 * t + i + 16 * (q >> 1)] = v
        for q in range(2):
            for i, v in enumerate(_bytes(b_regs[lane][q], False)):
                B[4 * t + i + 16 * q, g] = v
    Dm = A @ B
    return [[Dm[lane // 4 + 8 * (c >> 1), 2 * (lane % 4) + (c & 1)] for c in range(4)]
            for lane in range(32)]


def fold1_int(C):
    """(L, H) (TEAM, LPW, NS) int64 as the kernel's mma products give them,
    for one warp's 8 lanes (C: (LPW, 112) carried convolution rows)."""
    al, ah = a_frags(C)
    pw = pw_words()
    Lv = np.zeros((TEAM, LPW, NS), np.int64)
    Hv = np.zeros_like(Lv)
    for nt in range(NTL):
        accL = [[0] * 4 for _ in range(32)]
        accH = [[0] * 4 for _ in range(32)]
        for ks in range(KSL):
            b = [(pw[((nt * KSL + ks) * 2) * 32 + ln], pw[((nt * KSL + ks) * 2 + 1) * 32 + ln])
                 for ln in range(32)]
            for planes, acc in ((al, accL), (ah, accH)):
                a = [(planes[ln % 4, ks, 0, ln // 4], 0, planes[ln % 4, ks, 1, ln // 4], 0)
                     for ln in range(32)]
                d = mma_s8u8(a, b)
                for ln in range(32):
                    for c in range(4):
                        acc[ln][c] += d[ln][c]
        for ln in range(32):
            g, t = divmod(ln, 4)
            assert accL[ln][2] == accL[ln][3] == accH[ln][2] == accH[ln][3] == 0  # rows 8-15
            for i in range(2):
                Lv[t, g, 2 * nt + i] = accL[ln][i]
                Hv[t, g, 2 * nt + i] = accH[ln][i]
    return Lv, Hv


def i2f_w(v):
    assert np.all(np.abs(v) < 2**22)
    return v.astype(F32)


def limb_team(A, B, conv=conv_team):
    """The team body (``conv`` then limb_tail): padded rows in, (lanes,
    50) out."""
    lo, hi = conv(A, B)
    for _ in range(3):
        lo, hi = carry_cols(lo, hi)
    C = np.zeros((A.shape[0], 2 * TEAM * CW + 8), F32)  # cols past 103 never read
    for t in range(TEAM):
        C[:, CW * t:CW * t + CW] = lo[t]
        C[:, CW * (t + TEAM):CW * (t + TEAM) + CW] = hi[t]
    Lv, Hv = fold1_int(C)
    fw = fw_table()
    top = C[:, NCV - 1]
    o = np.zeros((TEAM, A.shape[0], NS), F32)
    for t in range(TEAM):
        for s in range(NS):
            k = p_limb(s, t)
            tc = i2f_w(128 * Hv[t, :, s] + Lv[t, :, s])
            o[t][:, s] = (top * fw[t, s, 2] + tc) + (C[:, k] if k < FF else F32(0))
    o = carry3_p(o)
    f2 = fw_table()
    h0, h1 = o[0][:, NS - 2].copy(), o[0][:, NS - 1].copy()  # shfl from thread 0
    for t in range(TEAM):
        for s in range(NS):
            base = o[t][:, s] if p_limb(s, t) < FF else F32(0)
            o[t][:, s] = h1 * f2[t, s, 1] + (h0 * f2[t, s, 0] + base)
    return write_p(carry3_p(o))


def padded(rows):
    """(lanes, 50) carried rows → a's and b's padded rows."""
    A = np.zeros((rows.shape[0], A_LEN), F32)
    A[:, APAD:APAD + NLB] = rows
    B = np.zeros((rows.shape[0], B_LEN), F32)
    B[:, :NLB] = rows
    return A, B


def emu_mul(a, b):
    """fq_limb_mul_kernel for one warp: operands carried in the fold layout."""
    a = write_p(carry3_p(read_p(a)))
    b = write_p(carry3_p(read_p(b)))
    return limb_team(padded(a)[0], padded(b)[1])


def emu_pow(x, bits):
    """fq_limb_pow_kernel, each lane a warp (the lanes side by side: the
    warps share nothing)."""
    acc = base = write_p(carry3_p(read_p(x)))
    i, square = 1, True
    while i < len(bits):
        acc = limb_team(padded(acc)[0], padded(acc if square else base)[1], conv_warp)
        if square and bits[i]:
            square = False
        else:
            square, i = True, i + 1
    return acc


def _lazy(rng, n, lo=-300, hi=3000):
    """Lazy rows inside the value bound: limbs 0..48 in [lo, hi), the top
    limb in [-4, 12] (|value| < 2^396)."""
    rows = rng.integers(lo, hi, size=(n, NLB)).astype(F32)
    rows[:, -1] = rng.integers(-4, 13, size=n)
    return rows


def _warp(rows, n):
    """n real lanes, the rest of the warp zero rows (the kernel's padding)."""
    out = np.zeros((LPW, NLB), F32)
    out[:n] = rows[:n]
    return out


# -- the tests on the emulation ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_carry_handoffs_equal_carry3(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 20), 1 << 20, size=(6, 2 * TEAM * CW)).astype(F32)
    x[:, NCV:] = 0
    lo = np.stack([x[:, CW * t:CW * t + CW] for t in range(TEAM)])
    hi = np.stack([x[:, CW * (t + TEAM):CW * (t + TEAM) + CW] for t in range(TEAM)])
    for _ in range(3):
        lo, hi = carry_cols(lo, hi)
    got = np.zeros_like(x)
    for t in range(TEAM):
        got[:, CW * t:CW * t + CW] = lo[t]
        got[:, CW * (t + TEAM):CW * (t + TEAM) + CW] = hi[t]
    want = L.carry3(torch.from_numpy(x[:, :NCV])).numpy()
    assert np.array_equal(got[:, :NCV], want) and not got[:, NCV:].any()
    y = rng.integers(-(1 << 20), 1 << 20, size=(6, NLB)).astype(F32)
    assert np.array_equal(write_p(carry3_p(read_p(y))), L.carry3(torch.from_numpy(y)).numpy())


def test_fold_planes_and_fragments_equal_the_float_fold():
    """The int64 emulation of the plane products (A fragments from the
    split, B fragments as load_tables builds them) gives, as 128 H + L,
    the float fold's sums, for carried convolutions of random and extreme
    operands."""
    rng = np.random.default_rng(7)
    words = pw_words()
    for a, b in ((_lazy(rng, LPW), _lazy(rng, LPW)), _extremes()[:2]):
        a = L.carry3(torch.from_numpy(a))
        b = L.carry3(torch.from_numpy(b))
        c = torch.zeros((LPW, NCV))
        for i in range(NLB):
            c[:, i:i + NLB] += a[:, i:i + 1] * b
        c = L.carry3(c).numpy()
        C = np.zeros((LPW, 2 * TEAM * CW + 8), F32)
        C[:, :NCV] = c
        Lv, Hv = fold1_int(C)
        rows = L.FOLD_ROWS.astype(np.int64)
        want = c[:, FF:NCV - 1].astype(np.int64) @ rows[:NF - 1]  # (LPW, 50)
        got = np.zeros_like(want)
        for t in range(TEAM):
            for s in range(NS):
                if p_limb(s, t) < NLB:
                    got[:, p_limb(s, t)] = 128 * Hv[t, :, s] + Lv[t, :, s]
        assert np.array_equal(got, want)
        got += c[:, NCV - 1:].astype(np.int64) * rows[NF - 1]  # the top column's float FMA
        fl = L.fold(torch.from_numpy(c)).numpy()
        assert np.array_equal(fl[:, :FF], (got[:, :FF] + c[:, :FF]).astype(F32))
        assert np.array_equal(fl[:, FF:], got[:, FF:].astype(F32))


# -- the bound on the fold inputs ------------------------------------------------------

#: the limb field's lazy bound on an operand's value (fq_limb's docstring)
VALUE_BOUND = 1 << 396


def derived_bounds():
    """(top operand limb, top convolution column) magnitude bounds for
    operands below VALUE_BOUND: a carried operand's limbs 0..48 lie in
    [-1, 257], so its top limb a49 = (v − Σ a_i 2^(8i)) / 2^392 is within
    VALUE_BOUND / 2^392 + 2; column 98 = a49·b49 plus the three passes'
    carries out of column 97 (|conv97| ≤ 2·257·18, then ≤ 1029 after one
    pass, then ≤ 257 + 1)."""
    top = VALUE_BOUND // (1 << 392) + 2
    c97 = 2 * 257 * top
    carries = (c97 // 256 + 1) + (1029 // 256 + 1) + 2
    return top, top * top + carries


def _extremes():
    """Operands at the lazy bound: values ±(2^396 − 1) with limbs spread
    to their extremes (all 255 below a top of 15, or negative)."""
    out = []
    for sign in (1, -1):
        for spread in (True, False):
            v = sign * (VALUE_BOUND - 1)
            if spread:
                limbs = np.full(NLB, 255.0 * sign, F32)
                limbs[-1] = sign * 15.0  # 15·2^392 + Σ 255·2^(8i) = 2^396 − 1
            else:
                limbs = np.zeros(NLB, F32)
                limbs[-1] = sign * 16.0  # 2^396 exactly, the edge
            rows = np.tile(limbs, (LPW, 1))
            out.append(rows)
    assert L.to_int(out[0][0]) == (VALUE_BOUND - 1) % Q
    return out


def test_fold_input_bound_at_extreme_lazy_inputs():
    """The derived bounds hold for extreme operands: the top column is the
    only fold input outside [-1, 257] (so the tensor cores take columns
    48..97, the float32 pipe the top one), the planes fit s8, the s32 fold
    sums stay below 2^22 (i2f_w's range) and every float sum below 2^24."""
    top, col98 = derived_bounds()
    assert (top, col98) == (18, 368)
    rows = _extremes()
    rng = np.random.default_rng(11)
    # a dozen chained lazy adds and subtractions of canonical elements
    pyr = random.Random(11)
    signs = rng.choice([-1, 1], size=(12, 1, 1)).astype(F32)
    rows += [(signs * np.stack([L.from_ints([pyr.randrange(Q) for _ in range(LPW)])
                                for _ in range(12)])).sum(0)]
    worst = 0
    for a in rows:
        for b in rows:
            ca, cb = L.carry3(torch.from_numpy(a)), L.carry3(torch.from_numpy(b))
            assert ca[:, -1].abs().max() <= top and cb[:, -1].abs().max() <= top
            assert ca[:, :-1].min() >= -1 and ca[:, :-1].max() <= 257
            c = torch.zeros((LPW, NCV))
            for i in range(NLB):
                c[:, i:i + NLB] += ca[:, i:i + 1] * cb
            assert c.abs().max() < 2**24
            c = L.carry3(c).numpy()
            assert c[:, :-1].min() >= -1 and c[:, :-1].max() <= 257
            worst = max(worst, float(np.abs(c[:, -1]).max()))
            rows_w = L.FOLD_ROWS.astype(np.int64)
            tc = np.abs(c[:, FF:NCV - 1]).astype(np.int64) @ rows_w[:NF - 1]
            assert tc.max() < 2**22
            assert (tc + np.abs(c[:, NCV - 1:]).astype(np.int64) * rows_w[NF - 1]).max() < 2**24
            _, h = split_planes(c[:, FF:NCV - 1])
            assert h.min() >= -1 and h.max() <= 2
    assert worst <= col98
    # the envelopes the kernel relies on, from the bounds alone
    assert (NF - 1) * 257 * 255 < 2**22  # the s32 sums, through i2f_w
    assert (NF - 1) * 257 * 255 + col98 * 255 + 257 < 2**24  # the float32 adds


def test_carried_columns_stay_in_range_for_any_operands():
    """Whatever the operands (here at the float32-exact limit of the
    convolution, far past the lazy bound), three carry passes leave
    columns 0..97 in [-1, 257]: the tensor cores' inputs need no bound on
    the operands, only the top column does (and takes the float pipe)."""
    rng = np.random.default_rng(5)
    c = rng.integers(-(1 << 23), 1 << 23, size=(64, NCV)).astype(F32)
    c = L.carry3(torch.from_numpy(c)).numpy()
    assert c[:, :-1].min() >= -1 and c[:, :-1].max() <= 257


# -- the whole team body -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, LPW])
def test_team_body_mul_equals_mul_plain(n):
    rng = np.random.default_rng(100 + n)
    a, b = _warp(_lazy(rng, LPW), n), _warp(_lazy(rng, LPW), n)
    got = emu_mul(a, b)
    want = LK.mul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got[:n], want[:n])
    assert not got[n:].any()  # padding lanes compute zeros
    ints = [random.Random(n).randrange(Q) for _ in range(n)]
    x = _warp(L.from_ints(ints), n)
    assert L.to_ints(emu_mul(x, x)[:n]) == [v * v % Q for v in ints]


def test_team_body_mul_at_extreme_inputs():
    ex = _extremes()
    for a in ex:
        for b in ex[:2]:
            got = emu_mul(a, b)
            want = LK.mul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            assert np.array_equal(got, want)


@pytest.mark.parametrize("exponent", [1, 2, 0b1011010111])
def test_team_body_pow_equals_pow_plain(exponent):
    rng = np.random.default_rng(exponent)
    x = _warp(_lazy(rng, LPW), 6)
    bits = [int(c) for c in bin(exponent)[2:]]
    got = emu_pow(x, bits)
    want = LK.pow_plain(torch.from_numpy(x), exponent).numpy()
    assert np.array_equal(got, want)
