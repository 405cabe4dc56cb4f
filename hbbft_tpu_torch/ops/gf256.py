"""GF(2⁸) Reed–Solomon as an F₂ bit product (the JAX package's
``ops/gf256.py``).

GF(2⁸) is an 8-dimensional vector space over F₂, and multiplication by a
constant c is an F₂-linear map: an 8×8 bit matrix whose column j is the bit
decomposition of c·α^j (α = 2).  A GF(2⁸) matrix product
``out[r,l] = ⊕_i gf_mul(M[r,i], x[i,l])`` is therefore a binary matrix
product over F₂:

    out_bits[(r,b), l] = ( Σ_(i,j) Mbits[(r,b),(i,j)] · xbits[(i,j), l] ) mod 2

Both the encode matrix (parity rows) and every decode matrix (Lagrange rows
for one erasure pattern) are constants per call site, so the bit expansion
happens once on the host, and so does the packing of each bit row into
⌈k/4⌉ little-endian 32-bit words (``pack_gf_matrix``): the operand that
``gf256_matmul`` takes.

``gf256_matmul`` runs the plain version (unpack the words into bit planes,
multiply them as float32 — exact: at most 8·256 terms that are 0 or 1, TF32
pinned off by ``utils/device.py`` — take the parity, pack) on a CPU tensor,
and launches ``csrc/gf256.cu`` (``gf256_matmul``: AND/XOR against the packed
rows, popcount parity and pack in one pass) on a CUDA tensor; it counts its launches in ``.launches``
and the columns it was given in ``.lanes``.  The reference's
``HBBFT_TPU_GF_DOT`` (an int8 or bf16 dot on the TPU's matrix unit, the same
bytes either way) has no counterpart here.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from hbbft_tpu_torch.crypto.erasure import RSCodec, gf256
from hbbft_tpu_torch.utils import cuda_build
from hbbft_tpu_torch.utils.device import resolve

_SRC = "gf256"
#: the kernel packs a matrix row into at most 64 words: k ≤ 256 input bytes
MAX_K = 256


def expand_gf_matrix(m: np.ndarray) -> np.ndarray:
    """Expand a GF(2⁸) matrix (r×k uint8) into its F₂ bit-matrix (8r×8k int8).

    Row-major bit layout: output bit-row ``8*r + b`` is bit ``b`` of output
    byte ``r``; input bit-column ``8*i + j`` is bit ``j`` of input byte ``i``.
    """
    gf = gf256()
    m = np.asarray(m, dtype=np.uint8)
    r, k = m.shape
    out = np.zeros((8 * r, 8 * k), dtype=np.int8)
    for j in range(8):
        # column block j: bits of m[r,i] * 2^j
        prod = gf.mul(m, np.uint8(1 << j))  # (r, k)
        for b in range(8):
            out[b::8, j::8] = (prod >> b) & 1
    return out


def pack_gf_matrix(m: np.ndarray) -> np.ndarray:
    """Pack the bit matrix of a GF(2⁸) matrix (r×k uint8) into words:
    (8r × ⌈k/4⌉) int32, bit t of word w of row q = ``expand_gf_matrix(m)[q,
    32·w + t]`` (zero past 8k).  A column's k input bytes read
    little-endian are its 8k bits in the same order, so the kernel ANDs a
    row's words with a column's words directly."""
    bits = expand_gf_matrix(m)
    kw = -(-bits.shape[1] // 32)
    padded = np.zeros((bits.shape[0], 32 * kw), dtype=np.uint8)
    padded[:, : bits.shape[1]] = bits
    packed = np.packbits(padded, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32).view(np.int32)


def unpack_gf_words(mwords: torch.Tensor, k: int) -> torch.Tensor:
    """The (8r × 8k) int32 0/1 bit matrix of ``pack_gf_matrix``'s words."""
    shifts = torch.arange(32, dtype=torch.int32, device=mwords.device)
    bits = (mwords.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(mwords.shape[0], 32 * mwords.shape[1])[:, : 8 * k]


def gf256_matmul_plain(mwords: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gf256_matmul``: the reference's form on
    the unpacked bit matrix."""
    k, L = x.shape
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    xbits = ((x.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1).reshape(8 * k, L)
    acc = unpack_gf_words(mwords, k).to(torch.float32) @ xbits.to(torch.float32)
    par = acc.to(torch.int32) & 1
    r = par.shape[0] // 8
    return (par.reshape(r, 8, L) << shifts[None, :, None]).sum(dim=1).to(torch.uint8)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        lib.gf256_matmul.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]
        lib.gf256_matmul.restype = ctypes.c_int
        lib.gf256_error_string.argtypes = [ctypes.c_int]
        lib.gf256_error_string.restype = ctypes.c_char_p
        lib._hbbft_ready = True
    return lib


def gf256_matmul(mwords: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """GF(2⁸) matrix product via the F₂ bit product.

    mwords: (8r, ⌈k/4⌉) int32 — ``pack_gf_matrix`` of the GF coefficient
            matrix.
    x:      (k, L) uint8 — shard matrix (byte columns).
    Returns (r, L) uint8: the ``gf256_matmul`` kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if mwords.dtype != torch.int32 or x.dtype != torch.uint8:
        raise ValueError(f"expected int32 words and uint8 bytes, got {mwords.dtype}, {x.dtype}")
    if mwords.dim() != 2 or x.dim() != 2 or mwords.shape[1] != -(-x.shape[0] // 4) \
            or mwords.shape[0] % 8:
        raise ValueError(f"shapes {tuple(mwords.shape)} and {tuple(x.shape)} do not chain")
    if mwords.device != x.device:
        raise ValueError(f"operands on {mwords.device} and {x.device}")
    if x.device.type == "cpu":
        return gf256_matmul_plain(mwords, x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    k, L = x.shape
    r = mwords.shape[0] // 8
    if k > MAX_K:
        raise ValueError(f"k = {k} input bytes, above {MAX_K}")
    mwords, x = mwords.contiguous(), x.contiguous()
    out = torch.empty((r, L), dtype=torch.uint8, device=x.device)
    if r == 0 or L == 0 or k == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gf256_matmul(mwords.data_ptr(), x.data_ptr(), out.data_ptr(), r, k, L, stream)
    if rc != 0:
        raise RuntimeError(f"gf256_matmul launch failed: {lib.gf256_error_string(rc).decode()} "
                           f"({rc})")
    gf256_matmul.launches += 1
    gf256_matmul.lanes += L
    return out


gf256_matmul.launches = 0
gf256_matmul.lanes = 0  # columns over all launches


def reset_launches() -> None:
    gf256_matmul.launches = 0
    gf256_matmul.lanes = 0


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernel's library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs


class DecodeMatrixCache:
    """Bounded LRU of packed GF(2⁸) decode bit matrices, keyed by
    erasure pattern, held as tensors on ``device``.

    A decode matrix depends only on ``(xs, missing)`` — the first-k
    present shard indices and the missing indices — so every epoch that
    sees the same erasure pattern reuses one device constant.  Distinct
    patterns are combinatorially many, hence the bound: at ``capacity``
    entries the least-recently-used pattern is evicted.  Used by both
    ``TorchRSCodec`` and the backend's batched plane (ops/backend.py)."""

    def __init__(self, capacity: int = 64, device=None) -> None:
        self.capacity = capacity
        self.device = resolve(device)
        self._cache: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._cache)

    def keys(self):
        return self._cache.keys()

    def get(self, xs, missing) -> torch.Tensor:
        """The (8·|missing| × 8·k) F₂ bit matrix mapping values at ``xs``
        to values at ``missing``, packed by ``pack_gf_matrix`` (device
        constant; built on miss)."""
        key = (tuple(xs), tuple(missing))
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        if len(self._cache) >= self.capacity:
            self._cache.popitem(last=False)
        mat = gf256().lagrange_matrix(list(xs), list(missing))
        words = torch.as_tensor(pack_gf_matrix(mat), device=self.device)
        self._cache[key] = words
        return words


class TorchRSCodec(RSCodec):
    """Systematic (k data, m parity) RS codec whose GF(2⁸) products run
    through ``gf256_matmul`` on ``device`` (the card unless the caller
    names another).

    Same field, evaluation points and API as the host
    :class:`~hbbft_tpu_torch.crypto.erasure.RSCodec` (shards
    interoperate); only the matrix products are overridden.  Decode
    matrices are packed lazily and kept in a ``DecodeMatrixCache``."""

    _DECODE_CACHE_MAX = 64

    def __init__(self, data_shards: int, parity_shards: int, device=None) -> None:
        super().__init__(data_shards, parity_shards)
        self.device = resolve(device)
        self._encode_words = torch.as_tensor(pack_gf_matrix(self.encode_matrix),
                                             device=self.device)
        self._decode_cache = DecodeMatrixCache(self._DECODE_CACHE_MAX, device=self.device)

    def _bytes(self, arr: np.ndarray) -> torch.Tensor:
        # writable: a read-only buffer (np.frombuffer) would be shared by a
        # CPU tensor that PyTorch may write
        return torch.as_tensor(np.require(arr, np.uint8, ("C", "W")), device=self.device)

    def _parity(self, mat: np.ndarray) -> np.ndarray:
        return gf256_matmul(self._encode_words, self._bytes(mat)).cpu().numpy()

    def _interpolate(self, xs, missing, stack: np.ndarray) -> np.ndarray:
        words = self._decode_cache.get(xs, missing)
        return gf256_matmul(words, self._bytes(stack)).cpu().numpy()
