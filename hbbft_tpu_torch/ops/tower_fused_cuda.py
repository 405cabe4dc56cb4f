"""The fused tower kernels of ``csrc/tower_fused.cu``, bound with ctypes.

Three kernels, every product of each on the warp-wide tensor-core body
of ``csrc/fq_rns_core.cuh`` (the design note in the source says what
bounds them):

* ``tower_op``   replaces ``tower_fused._op_kernel`` — one fq2/fq6/fq12
  multiply or square, or a cyclotomic square;
* ``miller_dbl`` replaces ``_dbl_kernel`` — one Miller doubling;
* ``hard_exp``   replaces ``_hard_kernel`` — the whole final-exponentiation
  hard part.

All three are sized by one policy, ``lanes_per_block``, against the
blocks of each the card holds at once (``resident_blocks``).

Their plain PyTorch versions are ``op_plain``, ``dbl_plain`` and
``hard_plain`` in ``ops/tower_fused.py``, whose public wrappers call these
functions for CUDA tensors only.  Each function here checks its operands,
allocates the outputs and the per-block scratch, launches on the current
stream, raises if the launch is refused, and counts its launches in
``.launches`` (the lanes they covered in ``.lanes``, the widest in ``.widest``).

Operands are packed (C, lanes, 79) float32 tensors, C the element's Fq
coefficient count.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from hbbft_tpu_torch.ops import fq_rns_cuda
from hbbft_tpu_torch.ops import tower_fused as TF
from hbbft_tpu_torch.utils import cuda_build

NL = TF.NL
_SRC = "tower_fused"

#: most lanes per block of the tower kernels (see lanes_per_block)
MAX_LB = 8

#: coefficient count of each op kind's element (kind index = position)
_OP_COEFFS = {i: n for i, (_, n, _) in enumerate(TF._OP_BODY.values())}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.tower_op.argtypes = [i, ptr, ptr, ptr, i, i, ptr, ptr, ptr, ptr, ptr]
        lib.miller_dbl.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, ptr, ptr, ptr, ptr]
        lib.hard_exp.argtypes = [ptr, i, ptr, ptr, i, i, ptr, ptr, ptr, ptr, ptr]
        for fn in (lib.tower_op, lib.miller_dbl, lib.hard_exp):
            fn.restype = i
        for name in ("tower_fused_const_floats", "tower_fused_op_slots",
                     "tower_fused_dbl_slots", "tower_fused_hard_slots",
                     "tower_fused_tc_bytes", "tower_fused_op_blocks_per_sm",
                     "tower_fused_dbl_blocks_per_sm", "tower_fused_hard_blocks_per_sm"):
            getattr(lib, name).restype = i
        lib.tower_fused_error_string.argtypes = [i]
        lib.tower_fused_error_string.restype = ctypes.c_char_p
        if lib.tower_fused_const_floats() != fq_rns_cuda._KCONSTS.size:
            raise RuntimeError(
                f"tower_fused.cu expects {lib.tower_fused_const_floats()} constants, "
                f"the wrapper packs {fq_rns_cuda._KCONSTS.size}"
            )
        if lib.tower_fused_tc_bytes() != fq_rns_cuda._KPLANES.size:
            raise RuntimeError(
                f"tower_fused.cu expects {lib.tower_fused_tc_bytes()} plane bytes, "
                f"the wrapper packs {fq_rns_cuda._KPLANES.size}"
            )
        lib._hbbft_ready = True
    return lib


def lanes_per_block(n: int, resident: int) -> int:
    """A tower kernel's lanes per block for n lanes on a card that holds
    ``resident`` of the kernel's blocks at once (blocks per SM x SMs): the
    smallest power of two, at most MAX_LB, whose grid fits at once."""
    return fq_rns_cuda.fit_per_block(n, resident, MAX_LB)


#: the kernels and their occupancy queries
_BLOCKS_PER_SM = {"tower_op": "tower_fused_op_blocks_per_sm",
                  "miller_dbl": "tower_fused_dbl_blocks_per_sm",
                  "hard_exp": "tower_fused_hard_blocks_per_sm"}
_RESIDENT: Dict[tuple, int] = {}


def resident_blocks(device, kernel: str) -> int:
    """Blocks of ``kernel`` (tower_op, miller_dbl or hard_exp) the card
    holds at once: the occupancy query's blocks per SM times the SM count
    (cached per device)."""
    device = torch.device(device)
    got = _RESIDENT.get((device, kernel))
    if got is None:
        with torch.cuda.device(device):
            per_sm = getattr(_lib(), _BLOCKS_PER_SM[kernel])()
        if per_sm <= 0:
            raise RuntimeError(f"{kernel} occupancy query failed ({-per_sm})")
        got = _RESIDENT[device, kernel] = per_sm * torch.cuda.get_device_properties(
            device).multi_processor_count
    return got


def _check(t: torch.Tensor, coeffs: int, n: int, what: str) -> None:
    if (t.dtype != torch.float32 or t.dim() != 3 or t.shape[0] != coeffs
            or t.shape[2] != NL or t.shape[1] != n or not t.is_cuda
            or not t.is_contiguous()):
        raise ValueError(
            f"{what}: expected a contiguous CUDA float32 ({coeffs}, {n}, {NL}) "
            f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tower_fused_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _scratch(slots: int, n: int, lb: int, device) -> torch.Tensor:
    blocks = -(-n // lb)
    return torch.empty(blocks * slots * lb * NL, dtype=torch.float32, device=device)


def _count(fn, n: int) -> None:
    fn.launches += 1
    fn.lanes += n
    fn.widest = max(fn.widest, n)


def tower_op(kind: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tower operation of ``kind`` (index into ``TF.OP_KINDS``)."""
    coeffs = _OP_COEFFS[kind]
    n = a.shape[1]
    _check(a, coeffs, n, "tower_op a")
    _check(b, coeffs, n, "tower_op b")
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _lib()
    lb = lanes_per_block(n, resident_blocks(a.device, "tower_op"))
    scratch = _scratch(lib.tower_fused_op_slots(), n, lb, a.device)
    c = fq_rns_cuda._consts(a.device)
    tc = TF.tower_consts(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tower_op(kind, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, lb,
                          scratch.data_ptr(), c["kernel"].data_ptr(), c["planes"].data_ptr(),
                          tc.data_ptr(), stream)
    _launch(lib, rc, "tower_op")
    _count(tower_op, n)
    return out


def miller_dbl(f: torch.Tensor, r: torch.Tensor, p: torch.Tensor):
    """One Miller doubling: (f', r') from f (12, n, 79), r (6, n, 79) and
    p (2, n, 79)."""
    n = f.shape[1]
    _check(f, 12, n, "miller_dbl f")
    _check(r, 6, n, "miller_dbl r")
    _check(p, 2, n, "miller_dbl p")
    f_out = torch.empty_like(f)
    r_out = torch.empty_like(r)
    if n == 0:
        return f_out, r_out
    lib = _lib()
    lb = lanes_per_block(n, resident_blocks(f.device, "miller_dbl"))
    scratch = _scratch(lib.tower_fused_dbl_slots(), n, lb, f.device)
    c = fq_rns_cuda._consts(f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = lib.miller_dbl(f.data_ptr(), r.data_ptr(), p.data_ptr(), f_out.data_ptr(),
                            r_out.data_ptr(), n, lb, scratch.data_ptr(),
                            c["kernel"].data_ptr(), c["planes"].data_ptr(), stream)
    _launch(lib, rc, "miller_dbl")
    _count(miller_dbl, n)
    return f_out, r_out


_BITS: Dict[torch.device, torch.Tensor] = {}


def hard_exp(m: torch.Tensor, lb: Optional[int] = None) -> torch.Tensor:
    """The final-exponentiation hard part of a packed m (12, n, 79).
    ``lb``: lanes per block (default: ``lanes_per_block``'s choice; the
    kernel bench sweeps it)."""
    n = m.shape[1]
    _check(m, 12, n, "hard_exp m")
    out = torch.empty_like(m)
    if n == 0:
        return out
    lib = _lib()
    if lb is None:
        lb = lanes_per_block(n, resident_blocks(m.device, "hard_exp"))
    elif not 1 <= lb <= MAX_LB:
        raise ValueError(f"hard_exp: lanes per block {lb} outside 1..{MAX_LB}")
    scratch = _scratch(lib.tower_fused_hard_slots(), n, lb, m.device)
    c = fq_rns_cuda._consts(m.device)
    tc = TF.tower_consts(m.device)
    bits = _BITS.get(m.device)
    if bits is None:
        bits = _BITS[m.device] = torch.as_tensor(
            TF._X_CHAIN_BITS, dtype=torch.int32, device=m.device
        )
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.hard_exp(bits.data_ptr(), bits.numel(), m.data_ptr(), out.data_ptr(), n,
                          lb, scratch.data_ptr(), c["kernel"].data_ptr(),
                          c["planes"].data_ptr(), tc.data_ptr(), stream)
    _launch(lib, rc, "hard_exp")
    _count(hard_exp, n)
    return out


KERNELS = (tower_op, miller_dbl, hard_exp)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.lanes = 0  # lanes over all launches (lanes / launches = mean launch width)
    _fn.widest = 0  # the widest launch's lanes


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.lanes = 0
        fn.widest = 0


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernels' library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs
