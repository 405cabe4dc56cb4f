"""The limb-field multiply and fixed-exponent power as CUDA kernels.

The port of the JAX package's ``ops/fq_pallas.py``.  Two kernels, written
by hand for Hopper in ``csrc/fq_limb.cu`` on one team body (four threads
a product, fold 1 as int8 tensor-core products; the power gives each lane
a warp and deals its convolution over the warp; the design note there says
what bounds them and how they are laid out):

* ``fq_limb_mul`` replaces ``_mul_kernel`` / ``_mul_core`` — both
  operands carried, the 50×50 limb convolution, carry, fold 1 through the
  (50, 51) fold matrix, carry, fold 2 through its first two columns,
  carry;
* ``fq_limb_pow`` replaces ``_pow_kernel`` — the whole square-and-multiply
  chain over a fixed exponent in one launch: the accumulator starts at the
  carried base (MSB implicit) and is never re-carried between products.

Beside each kernel sits its plain PyTorch version (``mul_plain``,
``pow_plain``), the Pallas kernel's stage order with the convolution as a
shifted multiply-add loop in float32 (a bf16 product would return bf16,
and carried limbs up to 257 are not all bf16-exact).  Every value is an
exact float32 integer, so kernel and plain version agree bit for bit.
The wrappers ``mul`` and ``pow_fixed`` run the plain version on CPU
tensors and launch the kernel on CUDA tensors; nothing falls back from
one to the other.  Each wrapper counts its launches in ``.launches``;
``mul`` reads a one-row operand in place (lane stride 0) and counts such
launches in ``.broadcast_launches``.

The Pallas kernel's convolution layouts (``HBBFT_TPU_CONV_MODE``: concat,
scratch, grouped) are TPU VMEM strategies that compute identical values;
the CUDA kernel has one layout of its own.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict

import numpy as np
import torch

from hbbft_tpu_torch.ops import fq_limb as L
from hbbft_tpu_torch.ops.fq_rns_cuda import (
    _blocks_per_sm,
    _exp_bits,
    _lane_operand,
    _sms,
    fit_per_block,
)
from hbbft_tpu_torch.utils import cuda_build

NL = L.NLIMBS  # 50
_SRC = "fq_limb"
LANES_PER_WARP = 8  # the multiply's lanes per warp, a team of 4 threads each (csrc/fq_limb.cu LPW)
MAX_WARPS = 4  # warps per block at most (csrc/fq_limb.cu MAX_WARPS)


# -- plain versions (the Pallas kernels' stage order) -------------------------


def _core(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_mul_core``: carried operands in, carried product out."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    c = a.new_zeros(shape[:-1] + (L.CONV,))
    for i in range(NL):
        c[..., i : i + NL] += a[..., i : i + 1] * b
    return L.carry3(L.fold(L.carry3(L.fold(L.carry3(c)))))


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fq_limb_mul`` (``_mul_kernel``)."""
    return _core(L.carry3(a), L.carry3(b))


def pow_plain(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """Plain PyTorch version of ``fq_limb_pow`` (``_pow_kernel``)."""
    bits = _exp_bits(exponent)
    x = L.carry3(x)
    acc = x
    for bit in bits[1:]:
        acc = _core(acc, acc)
        if bit:
            acc = _core(acc, x)
    return acc


# -- the kernels ----------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.fq_limb_mul.argtypes = [ptr, i, ptr, i, ptr, i, i, ptr]
        lib.fq_limb_mul.restype = i
        lib.fq_limb_pow.argtypes = [ptr, ptr, i, ptr, i, i, ptr]
        lib.fq_limb_pow.restype = i
        for name in ("fq_limb_mul_blocks_per_sm", "fq_limb_pow_blocks_per_sm"):
            getattr(lib, name).restype = i
        lib.fq_limb_fold_floats.restype = i
        lib.fq_limb_read_fold.argtypes = [ptr]
        lib.fq_limb_read_fold.restype = i
        lib.fq_limb_error_string.argtypes = [i]
        lib.fq_limb_error_string.restype = ctypes.c_char_p
        want = np.ascontiguousarray(L.FOLD_ROWS.T, dtype=np.float32)
        if lib.fq_limb_fold_floats() != want.size:
            raise RuntimeError(
                f"fq_limb.cu holds {lib.fq_limb_fold_floats()} fold weights, "
                f"the limb field has {want.size}"
            )
        got = np.empty_like(want)
        _check(lib, lib.fq_limb_read_fold(got.ctypes.data), "fq_limb_read_fold")
        if not np.array_equal(got, want):
            raise RuntimeError("fq_limb.cu's fold table differs from fq_limb.FOLD_ROWS")
        lib._hbbft_ready = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fq_limb_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _check_rows(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.shape[-1] != NL:
            raise ValueError(
                f"expected float32 (..., {NL}) limb rows, got {t.dtype} {tuple(t.shape)}"
            )


def _count(fn, n: int) -> None:
    fn.launches += 1
    fn.lanes += n
    fn.widths[n.bit_length()] += 1


def warps_per_block(n: int, sms: int, lanes_per_warp: int = LANES_PER_WARP) -> int:
    """Warps per block for n lanes: one warp per ``lanes_per_warp`` lanes
    (8 for the multiply, 1 for the power), the fewest per block (1, 2 or
    4) whose grid fits on the SMs at once, so a narrow launch spreads its
    warps over the card's SMs (the sizing policy of the RNS kernels,
    ``fq_rns_cuda.fit_per_block``)."""
    return fit_per_block(-(-n // lanes_per_warp), sms, MAX_WARPS)


def mul_blocks_per_sm(device) -> int:
    """Blocks of ``fq_limb_mul`` (4 warps) resident on one SM of the card."""
    return _blocks_per_sm(device, _lib().fq_limb_mul_blocks_per_sm, "fq_limb_mul")


def pow_blocks_per_sm(device) -> int:
    """Blocks of ``fq_limb_pow`` (4 warps) resident on one SM of the card."""
    return _blocks_per_sm(device, _lib().fq_limb_pow_blocks_per_sm, "fq_limb_pow")


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod Q over (..., 50) limb rows (broadcasting).

    CPU tensors: the plain version.  CUDA tensors: the ``fq_limb_mul``
    kernel, launched on the current stream."""
    _check_rows(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(a, b)
    if not (a.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    n = out.numel() // NL
    if n == 0:
        return out
    a, sa = _lane_operand(a, shape, NL)
    b, sb = _lane_operand(b, shape, NL)
    lib = _lib()
    warps = warps_per_block(n, _sms(a.device))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fq_limb_mul(a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), n, warps,
                             stream)
    _check(lib, rc, "fq_limb_mul")
    _count(mul, n)
    if n > 1 and not (sa and sb):
        mul.broadcast_launches += 1
    return out


def pow_fixed(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent (Python int ≥ 1) over (..., 50) rows: one launch of
    ``fq_limb_pow`` on CUDA tensors, the plain chain on CPU tensors."""
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
    key = (exponent, x.device)
    bits_t = _BITS.get(key)
    if bits_t is None:
        bits_t = _BITS[key] = torch.tensor(bits, dtype=torch.int32, device=x.device)
    warps = warps_per_block(n, _sms(x.device), 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fq_limb_pow(x.data_ptr(), bits_t.data_ptr(), len(bits), out.data_ptr(), n,
                             warps, stream)
    _check(lib, rc, "fq_limb_pow")
    _count(pow_fixed, n)
    return out


_BITS: dict = {}  # (exponent, device) → int32 bit schedule on the device

KERNELS = (mul, pow_fixed)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.lanes = 0  # lanes over all launches (lanes / launches = mean launch width)
    _fn.widths = Counter()  # launches by width class: key b holds [2^(b-1), 2^b)
mul.broadcast_launches = 0  # launches with a one-row operand read at lane stride 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.lanes = 0
        fn.widths.clear()
    mul.broadcast_launches = 0


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernels' library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs
