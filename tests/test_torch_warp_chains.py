"""The kernels on the warp-wide tensor-core body, checked on the CPU.

Every RNS kernel — ``fq_rns_mul``, ``fq_rns_pow`` and ``fq_rns_chain``
(csrc/fq_rns.cu), ``tower_op``, ``miller_dbl`` and ``hard_exp``
(csrc/tower_fused.cu) — runs every product on ``mul_warp``
(csrc/fq_rns_core.cuh).  Only the card runs that code, so these tests pin
what the kernels rely on:

* how ``mul_pass_warp`` deals a round's np·nl tasks (task = p·nl + l) to
  a block's four warps in groups of 16: each product of each lane exactly
  once, padding tasks storing nothing, for ``hard_exp``'s rounds (12, 18
  and 54 products) at 1 to 8 lanes per block, and for every ``tower_op``
  kind's rounds (3, 2, 18, 18, 54, 36, and 18 then 12 products, counted
  again on the plain version) over whole launches of 1 to 796 lanes;
* how ``fq_rns_pow_kernel`` and ``fq_rns_chain_kernel`` map warps to
  groups of 16 lanes, padding lanes re-reading a real row;
* the one sizing policy of the warp-body kernels (``fit_per_block``):
  the smallest power of two whose grid fits the card at once, which
  ``tower_op`` takes with its own occupancy query like the other tower
  kernels;
* the pow kernel's schedule (the implicit MSB, a square per later bit and
  a multiply per set bit, one call site) and the chain kernel's (n
  products x ← x·b) run on the CPU emulation of the warp body over
  16-lane groups with padding lanes: bit-equal to ``pow_plain`` and
  ``mul_chain_plain`` (tolerance 0: exact integer float32 arithmetic).
  Short schedules only: one emulated product takes ~40 ms, so Q−2's 608
  and the bench's 200 are left to the card tests (tests/test_torch_cuda.py);
* in the sources, that every kernel reaches ``mul_warp`` and that the
  per-thread body, its pass, its constant copy and its float2 extension
  matrices are gone.

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
from hbbft_tpu_torch.ops import fq_rns as R, fq_rns_cuda as K
from hbbft_tpu_torch.ops import tower_fused as TF, tower_fused_cuda as TK
from test_torch_tc_body import M, emulate_mul_warp

torch.set_num_threads(1)

NL = R.NLIMBS
CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
WARPS = 4  # warps of a tower block (TPB = 128)
#: the card's SMs and hard_exp's resident blocks on it (4 per SM, by
#: registers: the occupancy the H100 reports, PERF.md)
SMS = 132
RESIDENT = 4 * SMS
#: each tower_op kind's product rounds (Fq products a lane)
OP_PRODUCTS = {"fq2_mul": (3,), "fq2_sqr": (2,), "fq6_mul": (18,), "fq6_sqr": (18,),
               "fq12_mul": (54,), "fq12_sqr": (36,), "fq12_cyclo_sqr": (18, 12)}


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
    ("tower_op_kernel", "tower_fused.cu", "mul_warp"),
    ("fq_rns_pow_kernel", "fq_rns.cu", "mul_warp"),
    ("fq_rns_mul_kernel", "fq_rns.cu", "mul_warp"),
    ("fq_rns_chain_kernel", "fq_rns.cu", "mul_warp"),
])
def test_each_kernel_reaches_one_montgomery_body(kernel, source, body):
    """Every RNS kernel reaches the one body, mul_warp, and no per-thread
    body or pass."""
    defs = _definitions(_source("fq_rns_core.cuh", source))
    got = _reaches(defs, kernel)
    assert body in got
    assert not got & {"mul_core", "mul_pass", "load_consts"}


@pytest.mark.parametrize("name", ["mul_core", "mul_pass", "load_consts", "OFF_E1", "OFF_E2"])
def test_the_per_thread_body_is_gone(name):
    """The per-thread body, its pass, its block-wide constant copy and the
    float2 extension matrices it read appear nowhere under csrc/, not even
    in a comment: one body is left."""
    for path in sorted(CSRC.iterdir()):
        assert not re.search(rf"(?<!\w){name}(?!\w)", path.read_text()), path.name


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
    for line in (
        "const long l0 = ((long)blockIdx.x * (blockDim.x >> 5) + warp) * WARP_M;",
        "if (l0 >= n) return;",
        "const int cnt = (int)min((long)WARP_M, (long)n - l0);",
        "loose_row(out + row, a + row, smem, lane);",
        "loose_row(bs + row, b + row, smem, lane);",
        "const bool valid = lane < cnt;",
        "const long lr = (l0 + (valid ? lane : cnt - 1)) * NL;",
        "for (int i = 0; i < nmul; ++i) mul_warp(T, smem, acc, bs + lr, acc, valid, true, lane);",
    ):
        assert line in flat["fq_rns_chain_kernel"], line
    for launcher in ("fq_rns_pow", "fq_rns_chain"):
        assert "const long groups = ((long)n + WARP_M - 1) / WARP_M;" in flat[launcher]
        assert "const unsigned grid = (unsigned)((groups + warps - 1) / warps);" in flat[launcher]
    # tower_op's rounds: its own (kinds 0, 1, 2, 3, 5), blk_mul12's (kind 4)
    # and blk_cyclo's two (kind 6)
    op = flat["tower_op_kernel"]
    for line in ("if (kind == 6) { blk_cyclo(b, x, o); return; }",
                 "if (kind == 4) { blk_mul12(b, x, y, o); return; }",
                 "const int np = kind == 0 ? 3 : kind == 1 ? 2 : kind == 5 ? 36 : 18;",
                 "mul_pass_warp(b, np);"):
        assert line in op, line
    assert re.findall(r"mul_pass_warp\(b, (\d+)\)", flat["blk_mul12"]) == ["54"]
    assert re.findall(r"mul_pass_warp\(b, (\d+)\)", flat["blk_cyclo"]) == ["18", "12"]
    assert list(OP_PRODUCTS) == list(TF.OP_KINDS)
    assert [TF._OP_BODY[k][0] for k in OP_PRODUCTS] == list(range(7))
    assert re.search(r"#define WARP_M 16\b", (CSRC / "fq_rns_core.cuh").read_text())
    assert M == 16 == K.WARP_M
    assert re.search(rf"#define GROUP_MAX_WARPS {K.MAX_WARPS}\b", (CSRC / "fq_rns.cu").read_text())


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


def group_lanes(n: int, warps: int):
    """fq_rns_pow_kernel's and fq_rns_chain_kernel's lanes at ``warps`` a
    block: per launched warp, the rows its 16 task lanes read and whether
    each stores; and the grid."""
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
    return out, grid


def pow_lanes(n: int, sms: int = SMS):
    """fq_rns_pow_kernel's lanes (group_lanes), grid and warps a block."""
    warps = K.group_warps_per_block(n, sms)
    return (*group_lanes(n, warps), warps)


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
    assert grid <= SMS or warps == K.MAX_WARPS
    assert warps == 1 or -(-groups // (warps // 2)) > SMS


@pytest.mark.parametrize("resident", [6 * SMS, SMS])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 4097, 16385, 87040, 262144])
def test_chain_maps_each_lane_to_one_warp(n, resident):
    """The chain kernel deals lanes as the power does; its blocks hold 1, 2
    or 4 warps, the fewest whose grid fits the resident blocks (or 4)."""
    warps = K.group_warps_per_block(n, resident)
    warps_of, grid = group_lanes(n, warps)
    groups = -(-n // M)
    rows = [r for lanes in warps_of for r, ok in lanes if ok]
    assert sorted(rows) == list(range(n))
    assert all(r < n for lanes in warps_of for r, _ in lanes)
    assert len(warps_of) == groups
    assert warps in (1, 2, 4)
    assert grid <= resident or warps == K.MAX_WARPS
    assert warps == 1 or -(-groups // (warps // 2)) > resident


def op_launch(n_products: int, n: int, resident: int = RESIDENT):
    """One tower_op round over a launch of n lanes: blocks of
    ``lanes_per_block`` lanes, each dealing its nl·np tasks by
    ``deal_pass``; returns the (lane, product) of every storing task."""
    lb = TK.lanes_per_block(n, resident)
    stored = []
    for blk in range(-(-n // lb)):
        lane0 = blk * lb
        nl = min(lb, n - lane0)
        for lanes_of in deal_pass(n_products, nl).values():
            for lanes in lanes_of:
                for lane, (task, valid) in enumerate(lanes):
                    assert valid or task == 0
                    assert not (valid and lane >= M)
                    if valid:
                        p, l = divmod(task, nl)
                        assert p < n_products and l < nl
                        stored.append((lane0 + l, p))
    return stored


@pytest.mark.parametrize("n", [1, 15, 16, 17, 796])
@pytest.mark.parametrize("kind", list(OP_PRODUCTS))
def test_op_rounds_deal_every_product_once(kind, n):
    """Every round of every tower_op kind, over a whole launch: each
    (lane, product) is one storing task, once; padding tasks (most of a
    pass for the 2- and 3-product kinds at narrow widths) store nothing."""
    for n_products in OP_PRODUCTS[kind]:
        stored = op_launch(n_products, n)
        assert sorted(stored) == [(l, p) for l in range(n) for p in range(n_products)]


@pytest.mark.parametrize("kind", list(OP_PRODUCTS))
def test_op_product_rounds_match_the_plain_version(kind, monkeypatch):
    """The product rounds the model deals are the plain version's: one
    mul_plain pass of that many Fq products per round."""
    seen = []
    real = TF.mul_plain

    def counting(a, b, reduced=False):
        seen.append(a.shape[0])
        return real(a, b, reduced)

    monkeypatch.setattr(TF, "mul_plain", counting)
    x = torch.zeros((TF._OP_BODY[kind][1], 1, NL))
    TF.op_plain(kind, x, x)
    assert tuple(seen) == OP_PRODUCTS[kind]


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


def test_tower_op_takes_the_shared_policy():
    """tower_op is sized like miller_dbl and hard_exp: lanes_per_block
    against its own occupancy query (so the policy test above covers
    it); the first design's fixed rule is gone."""
    import inspect

    assert TK._BLOCKS_PER_SM["tower_op"] == "tower_fused_op_blocks_per_sm"
    assert 'lanes_per_block(n, resident_blocks(a.device, "tower_op"))' in inspect.getsource(
        TK.tower_op)
    assert not hasattr(TK, "_lanes_per_block")
    flat = {k: " ".join(v.split()) for k, v in _definitions(_source("tower_fused.cu")).items()}
    assert "launch_setup(g_op, tower_op_kernel, TPB, WARP_SMEM)" in flat["op_setup"]
    assert "op_setup()" in flat["tower_fused_op_blocks_per_sm"]
    assert "tower_op_kernel<<<grid, TPB, WARP_SMEM," in flat["tower_op"]


def test_policy_at_the_paths_widths():
    """On the H100 (528 resident blocks of each tower kernel, 132 SMs):
    hard_exp's and tower_op's 796 lanes take LB = 2 (398 blocks),
    miller_dbl's 1,593 LB = 4; fq_rns_pow's 4,095 lanes 2 warps a block
    (128 blocks), one lane one warp; the chain (6 blocks an SM) 1 warp a
    block at the bench's 4,096 lanes, 2 at 16,385 (1,025 groups: more
    than the 792 resident blocks, 513 blocks of two) and 4 at its 87,040."""
    assert TK.lanes_per_block(796, RESIDENT) == 2
    assert TK.lanes_per_block(1593, RESIDENT) == 4
    assert K.group_warps_per_block(4095, SMS) == 2
    assert K.group_warps_per_block(1, SMS) == 1
    assert TK.lanes_per_block(RESIDENT, RESIDENT) == 1
    assert TK.lanes_per_block(RESIDENT + 1, RESIDENT) == 2
    assert K.group_warps_per_block(4096, 6 * SMS) == 1
    assert K.group_warps_per_block(16385, 6 * SMS) == 2
    assert K.group_warps_per_block(87040, 6 * SMS) == 4


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


# -- the chain's schedule on the emulated warp body -------------------------------


def emulate_chain(a: np.ndarray, b: np.ndarray, nmul: int) -> np.ndarray:
    """fq_rns_chain_kernel over n lanes, its products on
    ``emulate_mul_warp``: out = loose(a), bs = loose(b); then per group of
    16 lanes (padding lanes re-reading the group's last row) nmul products
    acc ← acc·b, the padding lanes storing nothing."""
    n = len(a)
    c = K._consts("cpu")
    out = K._mod_loose(torch.as_tensor(a), c["p"], c["ip"]).numpy().copy()
    bs = K._mod_loose(torch.as_tensor(b), c["p"], c["ip"]).numpy()
    for warp_lanes in group_lanes(n, 1)[0]:
        rows = [r for r, _ in warp_lanes]
        stores = [r for r, ok in warp_lanes if ok]
        for _ in range(nmul):
            got = emulate_mul_warp(out[rows], bs[rows], True)
            out[stores] = got[: len(stores)]
    return out


@pytest.mark.parametrize("nmul", [0, 1, 3])
def test_emulated_chain_equals_the_plain_version(nmul):
    """17 lanes of lazy rows (a full group and one of 1 lane and 15
    padding lanes): bit-equal to mul_chain_plain, and to Python ints."""
    rng = random.Random(41)
    xs = [rng.randrange(Q) for _ in range(17)]
    ys = [rng.randrange(Q) for _ in range(17)]
    xs[:2], ys[-1] = [0, Q - 1], Q - 1
    ra, rb = R.from_ints(xs), R.from_ints(ys)
    a = np.concatenate([ra[:8], -ra[8:] * 5]).astype(np.float32)
    b = np.concatenate([rb[:9] + rb[8:], rb[9:] - rb[:8]]).astype(np.float32)
    va = xs[:8] + [-5 * v % Q for v in xs[8:]]
    vb = [(u + v) % Q for u, v in zip(ys[:9], ys[8:])] + [(v - u) % Q for u, v in zip(ys[:8],
                                                                                       ys[9:])]
    got = emulate_chain(a, b, nmul)
    want = K.mul_chain_plain(torch.as_tensor(a), torch.as_tensor(b), nmul).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert R.to_ints(torch.as_tensor(got)) == [x * pow(y, nmul, Q) % Q for x, y in zip(va, vb)]


def test_kernel_bench_launches_the_chain():
    """``--launch``'s chain calls ``mul_chain`` with the bench's products
    per launch (its plain version on the CPU), at the bench's mean width
    and one wave by default."""
    from hbbft_tpu_torch.tools import kernel_bench

    cpu = torch.device("cpu")
    got = kernel_bench._launch_fn("fq_rns_chain", 3, np.random.default_rng(5), cpu)()
    rng = np.random.default_rng(5)
    a, b = kernel_bench._rows(rng, 3, NL, cpu), kernel_bench._rows(rng, 3, NL, cpu)
    assert torch.equal(got, K.mul_chain_plain(a, b, kernel_bench.CHAIN))
    assert kernel_bench.LAUNCH_LANES["fq_rns_chain"] == (87040, 4096)
