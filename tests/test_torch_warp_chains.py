"""The chained kernels on the warp-wide tensor-core body, checked on the CPU.

``hard_exp`` (csrc/tower_fused.cu) and ``fq_rns_pow`` (csrc/fq_rns.cu)
run every product on ``mul_warp`` (csrc/fq_rns_core.cuh).  Only the card
runs that code, so these tests pin what the kernels rely on:

* how ``mul_pass_warp`` deals a round's np·nl tasks (task = p·nl + l) to
  a block's four warps in groups of 16: each product of each lane exactly
  once, padding tasks storing nothing, for ``hard_exp``'s rounds (12, 18
  and 54 products) at 1 to 8 lanes per block;
* how ``fq_rns_pow_kernel`` maps warps to groups of 16 lanes, padding
  lanes re-reading a real row;
* the one sizing policy of the warp-body kernels (``fit_per_block``):
  the smallest power of two whose grid fits the card at once;
* the pow kernel's schedule (the implicit MSB, a square per later bit and
  a multiply per set bit, one call site) run on the CPU emulation of the
  warp body over a 16-lane group with padding lanes: bit-equal to
  ``pow_plain`` (tolerance 0: exact integer float32 arithmetic).  Short
  exponents only: one emulated product takes ~40 ms, so Q−2's 608 are
  left to the card test (tests/test_torch_cuda.py);
* in the sources, that neither kernel reaches the per-thread body
  ``mul_core`` or its pass ``mul_pass``, and that ``tower_op`` and
  ``fq_rns_chain`` still do.

The models mirror the source lines they are pinned to by
``test_models_match_the_source``.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K, tower_fused_cuda as TK
from test_torch_tc_body import M, emulate_mul_warp

torch.set_num_threads(1)

NL = R.NLIMBS
CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
WARPS = 4  # warps of a tower block (TPB = 128)
#: the card's SMs and hard_exp's resident blocks on it (4 per SM, by
#: registers: the occupancy the H100 reports, PERF.md)
SMS = 132
RESIDENT = 4 * SMS


# -- the source ----------------------------------------------------------------


def _source(*names: str) -> str:
    """The named sources concatenated, without comments, preprocessor
    lines and the extern "C" braces (their functions are top-level)."""
    src = "\n".join((CSRC / n).read_text() for n in names)
    src = re.sub(r'extern "C" \{|\}\s*// extern "C"', "", src)
    src = re.sub(r"//[^\n]*", "", src)
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    return "\n".join(ln for ln in src.splitlines() if not ln.lstrip().startswith("#"))


def _definitions(src: str) -> dict:
    """{name: body} of the top-level functions and structs of ``src``."""
    defs, depth, head_start, body_start = {}, 0, 0, 0
    for i, ch in enumerate(src):
        if ch == "{":
            if depth == 0:
                head, body_start = src[head_start:i], i
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                struct = re.search(r"\bstruct\s+(\w+)\s*$", head)
                calls = re.findall(r"(\w+)\(", head)
                name = struct.group(1) if struct else calls[-1] if calls else None
                if name:
                    defs[name] = src[body_start : i + 1]
                head_start = i + 1
        elif ch == ";" and depth == 0:
            head_start = i + 1
    return defs


def _reaches(defs: dict, root: str) -> set:
    """Every definition reachable from ``root`` through the identifiers
    its body names."""
    seen, todo = set(), [root]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo.extend(w for w in set(re.findall(r"\w+", defs[name])) if w in defs)
    return seen


@pytest.mark.parametrize("kernel,source,body", [
    ("hard_exp_kernel", "tower_fused.cu", "mul_warp"),
    ("miller_dbl_kernel", "tower_fused.cu", "mul_warp"),
    ("tower_op_kernel", "tower_fused.cu", "mul_core"),
    ("fq_rns_pow_kernel", "fq_rns.cu", "mul_warp"),
    ("fq_rns_mul_kernel", "fq_rns.cu", "mul_warp"),
    ("fq_rns_chain_kernel", "fq_rns.cu", "mul_core"),
])
def test_each_kernel_reaches_one_montgomery_body(kernel, source, body):
    """hard_exp and fq_rns_pow reach mul_warp and neither mul_core nor
    mul_pass; tower_op and fq_rns_chain keep mul_core alone."""
    defs = _definitions(_source("fq_rns_core.cuh", source))
    got = _reaches(defs, kernel)
    other = "mul_core" if body == "mul_warp" else "mul_warp"
    assert body in got and other not in got
    if body == "mul_warp":
        assert "mul_pass" not in got


# -- models of the kernels' dealing ------------------------------------------------


def deal_pass(n_products: int, nl: int, warps: int = WARPS):
    """mul_pass_warp: per warp, the passes it runs, each a list of the 32
    lanes' (task, valid); task = p·nl + l."""
    ntask = n_products * nl
    passes = {w: [] for w in range(warps)}
    for w in range(warps):
        g0 = w * M
        while g0 < ntask:
            lanes = []
            for lane in range(32):
                valid = lane < M and g0 + lane < ntask
                lanes.append((g0 + lane if valid else 0, valid))
            passes[w].append(lanes)
            g0 += warps * M
    return passes


def test_models_match_the_source():
    """The lines the models above and below mirror."""
    src = _source("fq_rns_core.cuh", "tower_fused.cu", "fq_rns.cu")
    defs = _definitions(src)
    flat = {k: " ".join(v.split()) for k, v in defs.items()}
    for line in (
        "for (int g0 = (threadIdx.x >> 5) * WARP_M; g0 < ntask; "
        "g0 += (blockDim.x >> 5) * WARP_M)",
        "const bool valid = lane < WARP_M && g0 + lane < ntask;",
        "const int task = valid ? g0 + lane : 0;",
        "const int p = task / b.nl;",
        "const long off = p * b.ss + (long)(task - p * b.nl) * NL;",
        "mul_warp(b.T, b.K, A + off, B + off, O + off, valid, false, lane);",
    ):
        assert line in flat["mul_pass_warp"], line
    for line in (
        "const long l0 = ((long)blockIdx.x * (blockDim.x >> 5) + warp) * WARP_M;",
        "if (l0 >= n) return;",
        "const int cnt = (int)min((long)WARP_M, (long)n - l0);",
        "const bool valid = lane < cnt;",
        "const long lr = (l0 + (valid ? lane : cnt - 1)) * NL;",
        "mul_warp(T, smem, acc, square ? acc : bs, acc, valid, true, lane);",
        "if (square && __ldg(bits + i)) { square = false; } else { square = true; ++i; }",
    ):
        assert line in flat["fq_rns_pow_kernel"], line
    assert "const long groups = ((long)n + WARP_M - 1) / WARP_M;" in flat["fq_rns_pow"]
    assert "const unsigned grid = (unsigned)((groups + warps - 1) / warps);" in flat["fq_rns_pow"]
    assert re.search(r"#define WARP_M 16\b", (CSRC / "fq_rns_core.cuh").read_text())
    assert M == 16 == K.WARP_M


@pytest.mark.parametrize("nl", range(1, TK.MAX_LB + 1))
@pytest.mark.parametrize("n_products", [12, 18, 54])
def test_pass_deals_every_product_once(n_products, nl):
    """Each (product, lane) of a round is one valid task, stored once;
    padding tasks re-read task 0's rows (in the slot) and store nothing;
    lanes past WARP_M carry no task."""
    stored = []
    for lanes_of in deal_pass(n_products, nl).values():
        for lanes in lanes_of:
            for lane, (task, valid) in enumerate(lanes):
                p, l = divmod(task, nl)
                assert p < n_products and l < nl
                assert valid or task == 0
                assert not (valid and lane >= M)
                if valid:
                    stored.append((p, l))
    assert sorted(stored) == [(p, l) for p in range(n_products) for l in range(nl)]


@pytest.mark.parametrize("nl,cyclo,mul12", [(1, (1, 1), 1), (2, (1, 1), 2), (4, (2, 1), 4),
                                           (8, (3, 2), 7)])
def test_hard_exp_rounds_in_serial_passes(nl, cyclo, mul12):
    """The serial warp passes of a cyclotomic square (18 then 12
    products) and of an fq12 multiply (54) at nl lanes per block: at the
    path's LB = 2, 1 + 1 and 2."""
    def serial(n_products):
        return max(len(v) for v in deal_pass(n_products, nl).values())

    assert (serial(18), serial(12)) == cyclo
    assert serial(54) == mul12


def pow_lanes(n: int, sms: int = SMS):
    """fq_rns_pow_kernel's lanes: per launched warp, the rows its 16 task
    lanes read and whether each stores."""
    warps = K.pow_warps_per_block(n, sms)
    groups = -(-n // M)
    grid = -(-groups // warps)
    out = []
    for blk in range(grid):
        for warp in range(warps):
            l0 = (blk * warps + warp) * M
            if l0 >= n:
                continue
            cnt = min(M, n - l0)
            out.append([(l0 + (lane if lane < cnt else cnt - 1), lane < cnt)
                        for lane in range(M)])
    return out, grid, warps


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 2047, 2112, 4095, 8448, 8449, 65536])
def test_pow_maps_each_lane_to_one_warp(n):
    """Every lane is one valid task of one warp; padding lanes re-read the
    group's last real row; the blocks hold 1, 2 or 4 warps, the fewest
    whose grid fits on the SMs (or 4)."""
    warps_of, grid, warps = pow_lanes(n)
    groups = -(-n // M)
    rows = [r for lanes in warps_of for r, ok in lanes if ok]
    assert sorted(rows) == list(range(n))
    assert all(r < n for lanes in warps_of for r, _ in lanes)
    assert len(warps_of) == groups
    assert warps in (1, 2, 4)
    assert grid <= SMS or warps == K.POW_MAX_WARPS
    assert warps == 1 or -(-groups // (warps // 2)) > SMS


# -- the sizing policy ------------------------------------------------------------


@pytest.mark.parametrize("resident", [RESIDENT, 3 * SMS, SMS, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 37, 796, 1593, "R", "R+1", "2R", "2R+1", "8R+1"])
def test_lanes_per_block_grid_fits_at_once(n, resident):
    """The smallest power of two, at most MAX_LB, whose grid fits the
    resident blocks; at the policy's steps it steps."""
    if isinstance(n, str):
        times, _, plus = n.partition("R")
        n = int(times or 1) * resident + int(plus or 0)
    lb = TK.lanes_per_block(n, resident)
    assert lb in (1, 2, 4, 8)
    assert -(-n // lb) <= resident or lb == TK.MAX_LB
    assert lb == 1 or -(-n // (lb // 2)) > resident
    assert K.fit_per_block(n, resident, TK.MAX_LB) == lb


def test_policy_at_the_paths_widths():
    """On the H100 (528 resident blocks of hard_exp and miller_dbl, 132
    SMs): hard_exp's 796 lanes take LB = 2 (398 blocks), miller_dbl's
    1,593 LB = 4; fq_rns_pow's 4,095 lanes 2 warps a block (128 blocks),
    one lane one warp."""
    assert TK.lanes_per_block(796, RESIDENT) == 2
    assert TK.lanes_per_block(1593, RESIDENT) == 4
    assert K.pow_warps_per_block(4095, SMS) == 2
    assert K.pow_warps_per_block(1, SMS) == 1
    assert TK.lanes_per_block(RESIDENT, RESIDENT) == 1
    assert TK.lanes_per_block(RESIDENT + 1, RESIDENT) == 2


# -- the pow schedule on the emulated warp body ---------------------------------


def emulate_pow_group(x: np.ndarray, exponent: int):
    """fq_rns_pow_kernel for one group of n <= 16 lanes, its products on
    ``emulate_mul_warp``: base = acc = loose(x); then the kernel's loop
    over the bit schedule.  Returns the accumulator rows and the count of
    products."""
    n = len(x)
    c = K._consts("cpu")
    base = K._mod_loose(torch.as_tensor(x), c["p"], c["ip"]).numpy()
    acc = base.copy()
    rows = [lane if lane < n else n - 1 for lane in range(M)]
    bits = K._exp_bits(exponent)
    i, square, products = 1, True, 0
    while i < len(bits):
        got = emulate_mul_warp(acc[rows], acc[rows] if square else base[rows], True)
        acc = got[:n].copy()  # padding lanes store nothing
        products += 1
        if square and bits[i]:
            square = False
        else:
            square = True
            i += 1
    return acc, products


@pytest.mark.parametrize("exponent", [1, 2, 0b1011010111])
def test_emulated_pow_chain_equals_the_plain_version(exponent):
    """A group of 11 lanes (5 padding lanes) of lazy rows: bit-equal to
    pow_plain, and to Python-int powers."""
    rng = random.Random(31)
    xs = [rng.randrange(Q) for _ in range(11)]
    xs[:2] = [0, Q - 1]
    base = R.from_ints(xs)
    x = np.concatenate([base[:4], base[4:8] - base[:4], -base[8:] * 7]).astype(np.float32)
    vals = xs[:4] + [(b - a) % Q for a, b in zip(xs[:4], xs[4:8])] + [-7 * v % Q
                                                                      for v in xs[8:]]
    got, products = emulate_pow_group(x, exponent)
    want = K.pow_plain(torch.as_tensor(x), exponent).numpy()
    assert products == (exponent.bit_length() - 1) + (bin(exponent).count("1") - 1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert R.to_ints(torch.as_tensor(got)) == [pow(v, exponent, Q) for v in vals]
