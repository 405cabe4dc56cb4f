"""The RNS Montgomery multiply, fixed-exponent power and product chain as
CUDA kernels.

The port of the JAX package's ``ops/fq_rns_pallas.py``.  Three kernels,
written by hand for Hopper in ``csrc/fq_rns.cu`` (the design note there
says what bounds them and why they are laid out as they are), all on one
warp-wide body that runs the base extensions as int8 tensor-core
products, fed by the constant planes ``_pack_tc_planes`` packs:

* ``fq_rns_mul``  replaces ``_mul_kernel`` / ``_mul_core`` — one full-RNS
  Montgomery product a·b·M1⁻¹ (mod Q) per lane, with the ``reduced``
  flag of ``_mul_core`` (skip the input renormalization);
* ``fq_rns_pow``  replaces ``_pow_kernel`` — the whole square-and-multiply
  chain over a fixed exponent in one launch (its reason to exist is the
  380-bit Fermat inverse Q−2), each warp chaining the products of one
  group of 16 lanes;
* ``fq_rns_chain`` replaces ``_chain_kernel`` — n chained products
  x ← x·b in one launch (the kernel bench's ceiling probe: both operands
  renormalized once, then ``reduced`` products), each warp chaining one
  group of 16 lanes as the power does.

Beside each kernel sits its plain PyTorch version (``mul_plain``,
``pow_plain``, ``mul_chain_plain``), stage for stage the TPU kernel's
arithmetic — including its loose reductions, so kernel and plain version
agree bit for bit.  The wrappers ``mul``, ``pow_fixed`` and ``mul_chain``
run the plain version on CPU tensors and launch the kernel on CUDA
tensors; there is no fallback from one to the other.  Each wrapper
counts its launches in ``.launches``.

Layout: the public ``(..., 79)`` float32 rows, read row by row (the
warps stage and reduce in place), so there is no separate layout pass.
A one-row operand of ``mul`` is read in place with
lane stride 0 (counted in ``mul.broadcast_launches``); other broadcasts
are expanded first.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict

import numpy as np
import torch

from hbbft_tpu_torch.ops import fq_rns as R
from hbbft_tpu_torch.utils import cuda_build

NL = R.NLIMBS  # 79
_NB = R.N_B  # 39
_SRC = "fq_rns"

# -- constants (module load; host numpy) --------------------------------------
#
# Computed as the TPU kernel computes them: 1/p is a float32 division of
# the float32 modulus (fq_rns_pallas.py:95).

_P = np.asarray(R.B1 + R.B2 + [R.M_R], dtype=np.float32)
_IP = (1.0 / _P).astype(np.float32)
_XOFF = np.asarray([R._X_OFFSET_INT % int(p) for p in _P], dtype=np.float32)
_PB1R = np.asarray(R.B1 + [R.M_R], dtype=np.float32)
_IPB1R = (1.0 / _PB1R).astype(np.float32)
_M2INV_R = float(R._M2INV_R)


def _pack_kernel_consts() -> np.ndarray:
    """The float vectors the kernels copy into shared memory; the layout
    (offsets OFF_* in csrc/fq_rns_core.cuh) is checked against each
    library's own count at load.  The extension matrices travel as the
    int8 planes of ``_pack_tc_planes``."""
    parts = [
        _P, _IP, _XOFF, R._SIGMA_C_B1, R._M1INV_B2R, R._QM1INV_B2R, R._W2INV_B2,
        _PB1R, _IPB1R, R._M2_B1, np.asarray([_M2INV_R, 0.0]),
    ]
    return np.concatenate([np.asarray(p, dtype=np.float32) for p in parts])


_KCONSTS = _pack_kernel_consts()

#: the tensor-core tiling of the extensions (csrc/fq_rns_core.cuh): n-tiles
#: of 8 outputs, k-steps of 32 residues, B-fragment registers, warp lanes
TC_NT, TC_KS, TC_REGS, TC_LANES = 5, 2, 2, 32
TC_K = TC_KS * 32  # the 39 input residues padded to 64


def _tc_fragment_index():
    """(k, n) of each byte of one plane in mma.sync m16n8k32 B-fragment
    order [nt][ks][reg][lane][byte]: lane = 4g + t holds column
    n = 8·nt + g and rows k = 32·ks + 16·reg + 4t + byte."""
    nt, ks, reg, lane, byte = np.meshgrid(
        np.arange(TC_NT), np.arange(TC_KS), np.arange(TC_REGS), np.arange(TC_LANES),
        np.arange(4), indexing="ij")
    k = 32 * ks + 16 * reg + 4 * (lane & 3) + byte
    n = 8 * nt + (lane >> 2)
    return k.reshape(-1), n.reshape(-1)


def _pack_tc_planes() -> np.ndarray:
    """The int8 extension planes for the warp-wide tensor-core body
    (``mul_warp``): [extension][plane][nt][ks][reg][lane][byte], the two
    extensions' E_lo and E_hi with K = 39 padded by zeros to 64, each byte
    the value a thread feeds its B fragment (every value in [0, 63])."""
    k, n = _tc_fragment_index()
    out = []
    for plane in (R._E1_LO, R._E1_HI, R._E2_LO, R._E2_HI):
        padded = np.zeros((TC_K, plane.shape[1]), dtype=np.int64)
        padded[: plane.shape[0]] = plane
        out.append(padded[k, n])
    return np.concatenate(out).astype(np.int8)


_KPLANES = _pack_tc_planes()

_PLAIN = {
    "p": _P, "ip": _IP, "xoff": _XOFF, "sigc": R._SIGMA_C_B1,
    "e1_lo": R._E1_LO, "e1_hi": R._E1_HI, "e2_lo": R._E2_LO, "e2_hi": R._E2_HI,
    "m1inv": R._M1INV_B2R, "qm1inv": R._QM1INV_B2R, "w2inv": R._W2INV_B2,
    "pb1r": _PB1R, "ipb1r": _IPB1R, "m2b1": R._M2_B1,
}
_DEV: Dict[torch.device, dict] = {}


def _consts(device) -> dict:
    key = torch.device(device)
    c = _DEV.get(key)
    if c is None:
        c = {k: torch.as_tensor(v, device=key) for k, v in _PLAIN.items()}
        c["kernel"] = torch.as_tensor(_KCONSTS, device=key)
        c["planes"] = torch.as_tensor(_KPLANES, device=key)
        _DEV[key] = c
    return c


# -- plain versions (the TPU kernel's arithmetic, stage for stage) -----------


def _mod_loose(x, p, ip):
    return x - torch.floor(x * ip) * p


def _mod_lanes(x, p, ip):
    x = x - torch.floor(x * ip) * p
    x = x - p * (x >= p)
    x = x + p * (x < 0)
    return x


def _plane_partials(v, lo, hi):
    """The three partial sums of Σ_i v_i·E[i, j] over the 6-bit/5-bit
    planes of v and E: (ll, lh + hl, hh), each an exact float32 integer
    below 2^19."""
    v_hi = torch.floor(v * (1.0 / 64.0))
    v_lo = v - 64.0 * v_hi
    return v_lo @ lo, v_hi @ lo + v_lo @ hi, v_hi @ hi


def _split_dot(v, lo, hi, p, ip, exact: bool):
    """mod-p Σ_i v_i·E[i, j] as the TPU kernel's four 6-bit/5-bit plane
    products: ll + 64·loose(lh + hl) + 4096·canonical(hh)."""
    ll, mid, hh = _plane_partials(v, lo, hi)
    out = ll + 64.0 * _mod_loose(mid, p, ip) + 4096.0 * _mod_lanes(hh, p, ip)
    return _mod_lanes(out, p, ip) if exact else _mod_loose(out, p, ip)


def mul_plain(a: torch.Tensor, b: torch.Tensor, reduced: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``fq_rns_mul`` (``_mul_core``)."""
    c = _consts(a.device)
    p, ip = c["p"], c["ip"]
    if not reduced:
        a = _mod_loose(a, p, ip)
        b = _mod_loose(b, p, ip)
    x = _mod_loose(a * b, p, ip) + c["xoff"]  # (−p, 3p)
    p1, ip1 = p[:_NB], ip[:_NB]
    p2r, ip2r = p[_NB:], ip[_NB:]
    sigma = _mod_lanes(x[..., :_NB] * c["sigc"], p1, ip1)
    qhat = _split_dot(sigma, c["e1_lo"], c["e1_hi"], p2r, ip2r, exact=True)
    r2r = _mod_loose(x[..., _NB:] * c["m1inv"] + qhat * c["qm1inv"], p2r, ip2r)
    xi = _mod_lanes(r2r[..., :_NB] * c["w2inv"], p2r[:_NB], ip2r[:_NB])
    raw = _split_dot(xi, c["e2_lo"], c["e2_hi"], c["pb1r"], c["ipb1r"], exact=False)
    delta = _mod_lanes(
        (raw[..., _NB:] - r2r[..., _NB:]) * _M2INV_R, float(R.M_R), 1.0 / R.M_R
    )  # δ ≤ 39 < m_r — exact
    r1 = _mod_loose(raw[..., :_NB] - delta * c["m2b1"], p1, ip1)
    return torch.cat([r1, r2r], dim=-1)


def _exp_bits(exponent: int) -> list:
    if exponent < 1:
        raise ValueError("pow_fixed kernel requires exponent >= 1")
    return [int(ch) for ch in bin(exponent)[2:]]


def pow_plain(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """Plain PyTorch version of ``fq_rns_pow`` (``_pow_kernel``): the MSB
    is implicit (the accumulator starts at the renormalized base)."""
    bits = _exp_bits(exponent)
    c = _consts(x.device)
    x = _mod_loose(x.to(torch.float32), c["p"], c["ip"])
    acc = x
    for bit in bits[1:]:
        acc = mul_plain(acc, acc, reduced=True)
        if bit:
            acc = mul_plain(acc, x, reduced=True)
    return acc


def mul_chain_plain(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of ``fq_rns_chain`` (``_chain_kernel``): both
    operands renormalized once, then n products x ← x·b."""
    c = _consts(a.device)
    x = _mod_loose(a, c["p"], c["ip"])
    b = _mod_loose(b, c["p"], c["ip"])
    for _ in range(n):
        x = mul_plain(x, b, reduced=True)
    return x


# -- the kernels --------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.fq_rns_mul.argtypes = [ptr, i, ptr, i, ptr, i, i, ptr, ptr, ptr]
        lib.fq_rns_mul.restype = i
        lib.fq_rns_pow.argtypes = [ptr, ptr, i, ptr, ptr, i, i, ptr, ptr, ptr]
        lib.fq_rns_pow.restype = i
        lib.fq_rns_chain.argtypes = [ptr, ptr, ptr, ptr, i, i, i, ptr, ptr, ptr]
        lib.fq_rns_chain.restype = i
        lib.fq_rns_const_floats.restype = i
        lib.fq_rns_tc_bytes.restype = i
        lib.fq_rns_mul_blocks_per_sm.restype = i
        lib.fq_rns_pow_blocks_per_sm.restype = i
        lib.fq_rns_chain_blocks_per_sm.restype = i
        lib.fq_rns_error_string.argtypes = [i]
        lib.fq_rns_error_string.restype = ctypes.c_char_p
        if lib.fq_rns_const_floats() != _KCONSTS.size:
            raise RuntimeError(
                f"fq_rns.cu expects {lib.fq_rns_const_floats()} constants, "
                f"the wrapper packs {_KCONSTS.size}"
            )
        if lib.fq_rns_tc_bytes() != _KPLANES.size:
            raise RuntimeError(
                f"fq_rns.cu expects {lib.fq_rns_tc_bytes()} plane bytes, "
                f"the wrapper packs {_KPLANES.size}"
            )
        lib._hbbft_ready = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fq_rns_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _check_rows(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.shape[-1] != NL:
            raise ValueError(
                f"expected float32 (..., {NL}) residue rows, got "
                f"{t.dtype} {tuple(t.shape)}"
            )


def _lane_operand(t: torch.Tensor, shape, width: int = NL) -> tuple:
    """(rows, lane stride) of one ``mul`` operand of rows ``width`` wide: a
    single row is read in place by every lane (stride 0); any other
    operand is expanded to the broadcast shape and read row by row
    (stride ``width``)."""
    if t.numel() == width:
        return t.contiguous(), 0
    return t.expand(shape).contiguous(), width


def mul(a: torch.Tensor, b: torch.Tensor, reduced: bool = False) -> torch.Tensor:
    """Montgomery product of (..., 79) residue rows (broadcasting).

    CPU tensors: the plain version.  CUDA tensors: the ``fq_rns_mul``
    kernel, launched on the current stream."""
    _check_rows(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(a, b, reduced)
    if not (a.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    n = out.numel() // NL
    if n == 0:
        return out
    a, sa = _lane_operand(a, shape)
    b, sb = _lane_operand(b, shape)
    lib = _lib()
    c = _consts(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fq_rns_mul(
            a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), n, int(bool(reduced)),
            c["kernel"].data_ptr(), c["planes"].data_ptr(), stream,
        )
    _check(lib, rc, "fq_rns_mul")
    mul.launches += 1
    mul.lanes += n
    mul.widths[n.bit_length()] += 1
    mul.widest = max(mul.widest, n)
    if n > 1 and not (sa and sb):
        mul.broadcast_launches += 1
    return out


_PER_SM: dict = {}  # (device, kernel) → the kernel's occupancy query's answer


def _blocks_per_sm(device, query, kernel: str) -> int:
    """``query``, the CUDA runtime's occupancy query for ``kernel``'s
    launch configuration, asked once per device (a launch may size by it)."""
    device = torch.device(device)
    got = _PER_SM.get((device, kernel))
    if got is None:
        with torch.cuda.device(device):
            got = query()
        if got <= 0:
            raise RuntimeError(f"{kernel} occupancy query failed ({-got})")
        _PER_SM[device, kernel] = got
    return got


def mul_blocks_per_sm(device) -> int:
    """Blocks of ``fq_rns_mul`` resident on one SM of the card (the
    occupancy query of the CUDA runtime for its launch configuration)."""
    return _blocks_per_sm(device, _lib().fq_rns_mul_blocks_per_sm, "fq_rns_mul")


def pow_blocks_per_sm(device) -> int:
    """Blocks of ``fq_rns_pow`` (at its widest, four warps) resident on one
    SM of the card."""
    return _blocks_per_sm(device, _lib().fq_rns_pow_blocks_per_sm, "fq_rns_pow")


def chain_blocks_per_sm(device) -> int:
    """Blocks of ``fq_rns_chain`` (at its widest, four warps) resident on
    one SM of the card."""
    return _blocks_per_sm(device, _lib().fq_rns_chain_blocks_per_sm, "fq_rns_chain")


def fit_per_block(n: int, resident: int, most: int) -> int:
    """The sizing policy of the warp-body kernels: the smallest power of
    two k, at most ``most``, for which the grid of ceil(n / k) blocks
    (each taking k of the n items: lanes, or lane groups) fits the
    ``resident`` blocks the card holds at once."""
    k = 1
    while k < most and -(-n // k) > resident:
        k *= 2
    return k


mul.launches = 0
mul.broadcast_launches = 0  # launches with a one-row operand read at lane stride 0
mul.lanes = 0  # lanes over all launches (lanes / launches = mean launch width)
mul.widths = Counter()  # launches by width class: key b holds widths in [2^(b-1), 2^b)
mul.widest = 0  # the widest launch's lanes


#: most warps (lane groups of 16) per block of fq_rns_pow and fq_rns_chain
MAX_WARPS = 4
WARP_M = 16  # lanes of one warp pass (csrc/fq_rns_core.cuh)


def group_warps_per_block(n: int, resident: int) -> int:
    """fq_rns_pow's and fq_rns_chain's warps per block for n lanes: one
    warp per group of 16 lanes, the fewest per block (1, 2 or 4) whose grid
    fits ``resident`` blocks at once.  The power passes the SM count, so a
    narrow launch spreads an SM a block; the chain the blocks the card
    holds."""
    return fit_per_block(-(-n // WARP_M), resident, MAX_WARPS)


_SMS: dict = {}  # device → SMs of the card


def _sms(device) -> int:
    """The card's SM count, asked once per device (every launch sizes by it)."""
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def pow_fixed(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent (Python int ≥ 1) over (..., 79) rows: one launch of
    ``fq_rns_pow`` on CUDA tensors, the plain chain on CPU tensors."""
    _check_rows(x)
    if x.device.type == "cpu":
        return pow_plain(x, exponent)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    bits = _exp_bits(exponent)
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel() // NL
    if n == 0:
        return out
    lib = _lib()
    c = _consts(x.device)
    base = torch.empty_like(x)  # the renormalized base, written by the kernel
    warps = group_warps_per_block(n, _sms(x.device))
    key = (exponent, x.device)
    bits_t = _BITS.get(key)
    if bits_t is None:
        bits_t = _BITS[key] = torch.tensor(bits, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fq_rns_pow(
            x.data_ptr(), bits_t.data_ptr(), len(bits), out.data_ptr(), base.data_ptr(), n,
            warps, c["kernel"].data_ptr(), c["planes"].data_ptr(), stream,
        )
    _check(lib, rc, "fq_rns_pow")
    pow_fixed.launches += 1
    pow_fixed.lanes += n
    pow_fixed.widths[n.bit_length()] += 1
    pow_fixed.widest = max(pow_fixed.widest, n)
    return out


pow_fixed.launches = 0
pow_fixed.lanes = 0
pow_fixed.widths = Counter()
pow_fixed.widest = 0  # the widest launch's lanes
_BITS: dict = {}  # (exponent, device) → int32 bit schedule on the device


def mul_chain(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """n chained Montgomery products x ← x·b over (..., 79) rows
    (broadcasting): one launch of ``fq_rns_chain`` on CUDA tensors, the
    plain chain on CPU tensors."""
    _check_rows(a, b)
    if n < 0:
        raise ValueError("the chain length must be >= 0")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_chain_plain(a, b, n)
    if not (a.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).contiguous()
    b = b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    lanes = out.numel() // NL
    if lanes == 0:
        return out
    lib = _lib()
    c = _consts(a.device)
    bs = torch.empty_like(b)  # loose(b), written by the kernel
    warps = group_warps_per_block(lanes, chain_blocks_per_sm(a.device) * _sms(a.device))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fq_rns_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bs.data_ptr(), lanes, n, warps,
            c["kernel"].data_ptr(), c["planes"].data_ptr(), stream,
        )
    _check(lib, rc, "fq_rns_chain")
    mul_chain.launches += 1
    mul_chain.lanes += lanes
    mul_chain.widths[lanes.bit_length()] += 1
    return out


mul_chain.launches = 0
mul_chain.lanes = 0
mul_chain.widths = Counter()


def reset_launches() -> None:
    for fn in (mul, pow_fixed, mul_chain):
        fn.launches = 0
        fn.lanes = 0
        fn.widths.clear()
    mul.broadcast_launches = 0
    mul.widest = 0
    pow_fixed.widest = 0


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernels' library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs
