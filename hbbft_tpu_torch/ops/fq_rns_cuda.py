"""The RNS Montgomery multiply and fixed-exponent power as CUDA kernels.

The port of the JAX package's ``ops/fq_rns_pallas.py``.  Two kernels,
written by hand for Hopper in ``csrc/fq_rns.cu`` (the design note there
says what bounds them and why they are laid out as they are):

* ``fq_rns_mul``  replaces ``_mul_kernel`` / ``_mul_core`` — one full-RNS
  Montgomery product a·b·M1⁻¹ (mod Q) per lane, with the ``reduced``
  flag of ``_mul_core`` (skip the input renormalization);
* ``fq_rns_pow``  replaces ``_pow_kernel`` — the whole square-and-multiply
  chain over a fixed exponent in one launch (its reason to exist is the
  380-bit Fermat inverse Q−2).

Beside each kernel sits its plain PyTorch version (``mul_plain``,
``pow_plain``), stage for stage the TPU kernel's arithmetic — including
its loose reductions, so kernel and plain version agree bit for bit.
The wrappers ``mul`` and ``pow_fixed`` run the plain version on CPU
tensors and launch the kernel on CUDA tensors; there is no fallback from
one to the other.  Each wrapper counts its launches in ``.launches``.

Layout: the public ``(..., 79)`` float32 rows.  The kernel transposes
its tile in shared memory, so there is no separate layout pass.
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
    """The constant buffer the kernel copies into shared memory; the
    layout (offsets OFF_* in csrc/fq_rns.cu) is checked against the
    library's own count at load."""
    e1 = np.stack([R._E1_LO.T, R._E1_HI.T], axis=-1)  # (40, 39, 2): [j][i]
    e2 = np.stack([R._E2_LO.T, R._E2_HI.T], axis=-1)
    parts = [
        e1.reshape(-1), e2.reshape(-1), _P, _IP, _XOFF, R._SIGMA_C_B1,
        R._M1INV_B2R, R._QM1INV_B2R, R._W2INV_B2, _PB1R, _IPB1R, R._M2_B1,
        np.asarray([_M2INV_R, 0.0]),
    ]
    return np.concatenate([np.asarray(p, dtype=np.float32) for p in parts])


_KCONSTS = _pack_kernel_consts()

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


def _split_dot(v, lo, hi, p, ip, exact: bool):
    """mod-p Σ_i v_i·E[i, j] as the TPU kernel's four 6-bit/5-bit plane
    products: ll + 64·loose(lh + hl) + 4096·canonical(hh), each partial
    an exact float32 integer sum below 2^18."""
    v_hi = torch.floor(v * (1.0 / 64.0))
    v_lo = v - 64.0 * v_hi
    ll = v_lo @ lo
    mid = _mod_loose(v_hi @ lo + v_lo @ hi, p, ip)
    hh = _mod_lanes(v_hi @ hi, p, ip)
    out = ll + 64.0 * mid + 4096.0 * hh
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


# -- the kernels --------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.fq_rns_mul.argtypes = [ptr, ptr, ptr, i, i, ptr, ptr]
        lib.fq_rns_mul.restype = i
        lib.fq_rns_pow.argtypes = [ptr, ptr, i, ptr, i, ptr, ptr]
        lib.fq_rns_pow.restype = i
        lib.fq_rns_const_floats.restype = i
        lib.fq_rns_error_string.argtypes = [i]
        lib.fq_rns_error_string.restype = ctypes.c_char_p
        if lib.fq_rns_const_floats() != _KCONSTS.size:
            raise RuntimeError(
                f"fq_rns.cu expects {lib.fq_rns_const_floats()} constants, "
                f"the wrapper packs {_KCONSTS.size}"
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
    a = a.expand(shape).contiguous()
    b = b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    n = out.numel() // NL
    if n == 0:
        return out
    lib = _lib()
    kc = _consts(a.device)["kernel"]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fq_rns_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(bool(reduced)),
            kc.data_ptr(), stream,
        )
    _check(lib, rc, "fq_rns_mul")
    mul.launches += 1
    mul.lanes += n
    mul.widths[n.bit_length()] += 1
    return out


mul.launches = 0
mul.lanes = 0  # lanes over all launches (lanes / launches = mean launch width)
mul.widths = Counter()  # launches by width class: key b holds widths in [2^(b-1), 2^b)


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
    kc = _consts(x.device)["kernel"]
    key = (exponent, x.device)
    bits_t = _BITS.get(key)
    if bits_t is None:
        bits_t = _BITS[key] = torch.tensor(bits, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fq_rns_pow(
            x.data_ptr(), bits_t.data_ptr(), len(bits), out.data_ptr(), n,
            kc.data_ptr(), stream,
        )
    _check(lib, rc, "fq_rns_pow")
    pow_fixed.launches += 1
    pow_fixed.lanes += n
    pow_fixed.widths[n.bit_length()] += 1
    return out


pow_fixed.launches = 0
pow_fixed.lanes = 0
pow_fixed.widths = Counter()
_BITS: dict = {}  # (exponent, device) → int32 bit schedule on the device


def reset_launches() -> None:
    for fn in (mul, pow_fixed):
        fn.launches = 0
        fn.lanes = 0
        fn.widths.clear()


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernels' library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs
