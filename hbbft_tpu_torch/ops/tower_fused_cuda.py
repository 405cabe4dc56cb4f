"""The fused tower kernels of ``csrc/tower_fused.cu``, bound with ctypes.

Three kernels (the design note in the source says what bounds them):

* ``tower_op``   replaces ``tower_fused._op_kernel`` — one fq2/fq6/fq12
  multiply or square, or a cyclotomic square;
* ``miller_dbl`` replaces ``_dbl_kernel`` — one Miller doubling;
* ``hard_exp``   replaces ``_hard_kernel`` — the whole final-exponentiation
  hard part.

Their plain PyTorch versions are ``op_plain``, ``dbl_plain`` and
``hard_plain`` in ``ops/tower_fused.py``, whose public wrappers call these
functions for CUDA tensors only.  Each function here checks its operands,
allocates the outputs and the per-block scratch, launches on the current
stream, raises if the launch is refused, and counts its launches in
``.launches`` (and the lanes they covered in ``.lanes``).

Operands are packed (C, lanes, 79) float32 tensors, C the element's Fq
coefficient count.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from hbbft_tpu_torch.ops import fq_rns_cuda
from hbbft_tpu_torch.ops import tower_fused as TF
from hbbft_tpu_torch.utils import cuda_build

NL = TF.NL
_SRC = "tower_fused"

#: lanes per block: one at narrow widths (parallelism across blocks), up to
#: MAX_LB when a launch already fills the card's 132 SMs twice over
MAX_LB = 8
_SMS = 132

#: coefficient count of each op kind's element (kind index = position)
_OP_COEFFS = {i: n for i, (_, n, _) in enumerate(TF._OP_BODY.values())}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.tower_op.argtypes = [i, ptr, ptr, ptr, i, i, ptr, ptr, ptr, ptr]
        lib.miller_dbl.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, ptr, ptr, ptr]
        lib.hard_exp.argtypes = [ptr, i, ptr, ptr, i, i, ptr, ptr, ptr, ptr]
        for fn in (lib.tower_op, lib.miller_dbl, lib.hard_exp):
            fn.restype = i
        for name in ("tower_fused_const_floats", "tower_fused_op_slots",
                     "tower_fused_dbl_slots", "tower_fused_hard_slots"):
            getattr(lib, name).restype = i
        lib.tower_fused_error_string.argtypes = [i]
        lib.tower_fused_error_string.restype = ctypes.c_char_p
        if lib.tower_fused_const_floats() != fq_rns_cuda._KCONSTS.size:
            raise RuntimeError(
                f"tower_fused.cu expects {lib.tower_fused_const_floats()} constants, "
                f"the wrapper packs {fq_rns_cuda._KCONSTS.size}"
            )
        lib._hbbft_ready = True
    return lib


def _lanes_per_block(n: int) -> int:
    return max(1, min(MAX_LB, n // (2 * _SMS)))


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
    lb = _lanes_per_block(n)
    scratch = _scratch(lib.tower_fused_op_slots(), n, lb, a.device)
    kc = fq_rns_cuda._consts(a.device)["kernel"]
    tc = TF.tower_consts(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tower_op(kind, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, lb,
                          scratch.data_ptr(), kc.data_ptr(), tc.data_ptr(), stream)
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
    lb = _lanes_per_block(n)
    scratch = _scratch(lib.tower_fused_dbl_slots(), n, lb, f.device)
    kc = fq_rns_cuda._consts(f.device)["kernel"]
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = lib.miller_dbl(f.data_ptr(), r.data_ptr(), p.data_ptr(), f_out.data_ptr(),
                            r_out.data_ptr(), n, lb, scratch.data_ptr(), kc.data_ptr(),
                            stream)
    _launch(lib, rc, "miller_dbl")
    _count(miller_dbl, n)
    return f_out, r_out


_BITS: Dict[torch.device, torch.Tensor] = {}


def hard_exp(m: torch.Tensor) -> torch.Tensor:
    """The final-exponentiation hard part of a packed m (12, n, 79)."""
    n = m.shape[1]
    _check(m, 12, n, "hard_exp m")
    out = torch.empty_like(m)
    if n == 0:
        return out
    lib = _lib()
    lb = _lanes_per_block(n)
    scratch = _scratch(lib.tower_fused_hard_slots(), n, lb, m.device)
    kc = fq_rns_cuda._consts(m.device)["kernel"]
    tc = TF.tower_consts(m.device)
    bits = _BITS.get(m.device)
    if bits is None:
        bits = _BITS[m.device] = torch.as_tensor(
            TF._X_CHAIN_BITS, dtype=torch.int32, device=m.device
        )
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.hard_exp(bits.data_ptr(), bits.numel(), m.data_ptr(), out.data_ptr(), n,
                          lb, scratch.data_ptr(), kc.data_ptr(), tc.data_ptr(), stream)
    _launch(lib, rc, "hard_exp")
    _count(hard_exp, n)
    return out


KERNELS = (tower_op, miller_dbl, hard_exp)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.lanes = 0  # lanes over all launches (lanes / launches = mean launch width)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.lanes = 0


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernels' library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs
