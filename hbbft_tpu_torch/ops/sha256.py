"""Batched SHA-256 on the card: the hash half of the device erasure/hash
plane (the JAX package's ``ops/sha256.py``).

The RBC plane is O(N²) hashes per epoch — N proposers × N Merkle proofs
over RS shards — and ``crypto/merkle.py`` frames all of them with two
fixed-shape message forms:

* leaf hash:  ``sha256(b"\\x00" + data)`` — uniform ``leaf_len`` across a
  proposer batch (RS shards of one encode share a length);
* node hash:  ``sha256(b"\\x01" + left32 + right32)`` — always 65 bytes.

Entry points:

* :func:`leaf_hashes` / :func:`node_hashes` — tagged hashing primitives.
* :func:`tree_levels` — all T proposers' full Merkle levels (leaves padded
  to the power of two with ``_h_leaf(b"")``, matching
  ``MerkleTree.__init__`` bit for bit): one ``sha256_tagged`` launch a
  level.
* :func:`verify_proofs` — the batched proof walk over
  ``crypto/merkle.PackedProofs``-shaped tensors (leaves, paths, indices,
  roots → per-proof booleans) in one ``sha256_proofs`` launch.

The kernels are ``csrc/sha256.cu``'s; their wrappers ``sha256_tagged`` and
``sha256_proofs`` launch them on a CUDA tensor, run the plain versions
(``sha256_tagged_plain``, ``sha256_proofs_plain``: the reference's padding,
schedule and rounds on int64 words masked to 32 bits, since PyTorch's
uint32 support is partial) on a CPU tensor, and count their launches in
``.launches``, their messages (proofs) in ``.lanes`` and the widest
launch's in ``.widest``; the proof walk also keeps the leaf lengths it was
given in ``.leaf_lengths``.  Everything here
returns tensors on the input's device; fetching is the caller's job
(``ops/backend.py`` routes results through the dispatch seam).
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.utils import cuda_build

_SRC = "sha256"

# FIPS 180-4 constants.
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_M32 = 0xFFFFFFFF
#: ``merkle._h_leaf(b"")``, the pad leaf of a tree whose leaf count is not
#: a power of two
EMPTY_LEAF = hashlib.sha256(b"\x00").digest()


def compressions(msg_len: int) -> int:
    """SHA-256 blocks of a tagged message with ``msg_len`` data bytes."""
    return (msg_len + 1 + 9 + 63) // 64


# -- plain versions ----------------------------------------------------------


def _sigma(x: torch.Tensor, a: int, b: int, c: int, shift: bool = False) -> torch.Tensor:
    """rotr(x, a) ^ rotr(x, b) ^ rotr(x, c) (``shift``: x >> c for the
    last) on int64 holding 32-bit values.  A rotation's right shift and the
    low 32 bits of its left shift never overlap, so the three rotations are
    the XOR of the right shifts and of the masked left shifts."""
    lo = (x << (32 - a)) ^ (x << (32 - b))
    if not shift:
        lo = lo ^ (x << (32 - c))
    return (x >> a) ^ (x >> b) ^ (x >> c) ^ (lo & _M32)


def _schedule(words: torch.Tensor) -> torch.Tensor:
    """The message schedule of every block at once, with the round
    constants added: (B, nblocks, 16) words → (B, nblocks, 64) K[t] + W[t]
    (the schedule reads the message only, not the state)."""
    ws = list(words.unbind(-1))
    for t in range(16, 64):
        s0 = _sigma(ws[t - 15], 7, 18, 3, shift=True)
        s1 = _sigma(ws[t - 2], 17, 19, 10, shift=True)
        ws.append((ws[t - 16] + s0 + ws[t - 7] + s1) & _M32)
    return torch.stack(ws, dim=-1) + torch.tensor(_K, dtype=torch.int64, device=words.device)


def _compress(state: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One compression over a batch: ``state`` (B, 8) and the block's words
    ``w`` (B, 16), int64 holding 32-bit values → the new (B, 8) state."""
    return _rounds(state, _schedule(w[:, None])[:, 0])


def _rounds(state: torch.Tensor, kw: torch.Tensor) -> torch.Tensor:
    """The 64 rounds of a compression over a batch: ``state`` (B, 8) and
    the block's K[t] + W[t] ``kw`` (B, 64) → the new (B, 8) state."""
    kws = kw.unbind(1)
    a, b, c, d, e, f, g, h = state.unbind(1)
    for t in range(64):
        t1 = h + _sigma(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + kws[t]
        t2 = _sigma(a, 2, 13, 22) + ((a & b) | (c & (a | b)))
        a, b, c, d, e, f, g, h = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return (torch.stack([a, b, c, d, e, f, g, h], dim=1) + state) & _M32


def _pad_tagged(msgs: torch.Tensor, tag: int) -> torch.Tensor:
    """FIPS padding for ``tag_byte + msgs[i]``: (B, L) uint8 → (B, nblocks,
    16) big-endian words (int64)."""
    n_msgs, msg_len = msgs.shape
    total = msg_len + 1
    nblocks = compressions(msg_len)
    tail = np.zeros(nblocks * 64 - total, dtype=np.uint8)
    tail[0] = 0x80
    tail[-8:] = np.frombuffer((total * 8).to_bytes(8, "big"), dtype=np.uint8)
    dev = msgs.device
    buf = torch.cat([
        torch.full((n_msgs, 1), tag, dtype=torch.uint8, device=dev),
        msgs,
        torch.as_tensor(tail, device=dev).expand(n_msgs, -1),
    ], dim=1)
    quads = buf.reshape(n_msgs, nblocks, 16, 4).to(torch.int64)
    return (quads[..., 0] << 24) | (quads[..., 1] << 16) | (quads[..., 2] << 8) | quads[..., 3]


def _digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """(B, 8) words → (B, 32) uint8 big-endian digests."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=state.device)
    parts = (state[:, :, None] >> shifts) & 0xFF
    return parts.reshape(state.shape[0], 32).to(torch.uint8)


def sha256_tagged_plain(msgs: torch.Tensor, tag: int) -> torch.Tensor:
    """Plain PyTorch version of ``sha256_tagged``: sha256(bytes([tag]) + m)
    for every row m of ``msgs`` ((B, L) uint8 → (B, 32) uint8)."""
    kw = _schedule(_pad_tagged(msgs, tag))
    state = torch.tensor(_H0, dtype=torch.int64, device=msgs.device).expand(msgs.shape[0], 8)
    for blk in range(kw.shape[1]):
        state = _rounds(state, kw[:, blk])
    return _digest_bytes(state)


def sha256_proofs_plain(leaves, paths, indices, roots) -> torch.Tensor:
    """Plain PyTorch version of ``sha256_proofs``: at depth d the
    accumulator is the left operand iff bit d of the index is 0."""
    acc = sha256_tagged_plain(leaves, 0)
    idx = indices.to(torch.int64)
    for d in range(paths.shape[1]):
        sib = paths[:, d]
        is_left = (((idx >> d) & 1) == 0)[:, None]
        left = torch.where(is_left, acc, sib)
        right = torch.where(is_left, sib, acc)
        acc = sha256_tagged_plain(torch.cat([left, right], dim=1), 1)
    return (acc == roots).all(dim=1)


# -- kernel wrappers -----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SRC)
    if not getattr(lib, "_hbbft_ready", False):
        lib.sha256_tagged.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.sha256_tagged.restype = ctypes.c_int
        lib.sha256_proofs.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.sha256_proofs.restype = ctypes.c_int
        lib.sha256_error_string.argtypes = [ctypes.c_int]
        lib.sha256_error_string.restype = ctypes.c_char_p
        lib._hbbft_ready = True
    return lib


def _check(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.sha256_error_string(rc).decode()} ({rc})")


def sha256_tagged(msgs: torch.Tensor, tag: int) -> torch.Tensor:
    """sha256(bytes([tag]) + m) for every row m of ``msgs`` ((B, L) uint8 →
    (B, 32) uint8): the ``sha256_tagged`` kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if msgs.dtype != torch.uint8 or msgs.dim() != 2:
        raise ValueError(f"expected (B, L) uint8 messages, got {msgs.dtype} {tuple(msgs.shape)}")
    if not 0 <= tag <= 255:
        raise ValueError(f"tag {tag} is not a byte")
    if msgs.device.type == "cpu":
        return sha256_tagged_plain(msgs, tag)
    if not msgs.is_cuda:
        raise ValueError(f"unsupported device {msgs.device}")
    msgs = msgs.contiguous()
    n, length = msgs.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=msgs.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        rc = lib.sha256_tagged(msgs.data_ptr(), n, length, tag, out.data_ptr(), stream)
    _check(lib, rc, "sha256_tagged")
    sha256_tagged.launches += 1
    sha256_tagged.lanes += n
    sha256_tagged.widest = max(sha256_tagged.widest, n)
    return out


def sha256_proofs(leaves, paths, indices, roots) -> torch.Tensor:
    """The proof walk over ``leaves`` (P, leaf_len) uint8, ``paths`` (P,
    depth, 32) uint8, ``indices`` (P,) integer leaf positions and ``roots``
    (P, 32) uint8 → (P,) bool: the ``sha256_proofs`` kernel on CUDA tensors,
    the plain version on CPU tensors."""
    n = leaves.shape[0]
    if (leaves.dtype, paths.dtype, roots.dtype) != (torch.uint8,) * 3 or leaves.dim() != 2 \
            or paths.dim() != 3 or paths.shape[2] != 32 or tuple(roots.shape) != (n, 32) \
            or paths.shape[0] != n or tuple(indices.shape) != (n,):
        raise ValueError("expected PackedProofs-shaped uint8 leaves, paths, roots and indices")
    devs = {t.device for t in (leaves, paths, indices, roots)}
    if len(devs) != 1:
        raise ValueError(f"operands on {sorted(map(str, devs))}")
    dev = leaves.device
    if dev.type == "cpu":
        return sha256_proofs_plain(leaves, paths, indices, roots)
    if not leaves.is_cuda:
        raise ValueError(f"unsupported device {dev}")
    leaves, paths, roots = leaves.contiguous(), paths.contiguous(), roots.contiguous()
    idx = indices.to(torch.int32).contiguous()
    out = torch.empty((n,), dtype=torch.bool, device=dev)  # one byte, 0 or 1, a proof
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sha256_proofs(leaves.data_ptr(), leaves.shape[1], paths.data_ptr(),
                               paths.shape[1], idx.data_ptr(), roots.data_ptr(), n,
                               out.data_ptr(), stream)
    _check(lib, rc, "sha256_proofs")
    sha256_proofs.launches += 1
    sha256_proofs.lanes += n
    sha256_proofs.widest = max(sha256_proofs.widest, n)
    sha256_proofs.leaf_lengths.add(leaves.shape[1])
    return out


sha256_tagged.launches = 0
sha256_tagged.lanes = 0  # messages over all launches
sha256_tagged.widest = 0  # the widest launch's messages
sha256_proofs.launches = 0
sha256_proofs.lanes = 0  # proofs over all launches
sha256_proofs.widest = 0  # the widest launch's proofs
sha256_proofs.leaf_lengths = set()  # the leaf lengths its launches walked

#: the kernels' wrappers
KERNELS = (sha256_tagged, sha256_proofs)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.lanes = 0
        k.widest = 0
    sha256_proofs.leaf_lengths = set()


def build() -> Dict[str, float]:
    """Build (if needed) and load the kernels' library; build seconds."""
    secs = cuda_build.build([_SRC])
    _lib()
    return secs


# -- entry points --------------------------------------------------------------


def leaf_hashes(leaves: torch.Tensor) -> torch.Tensor:
    """Batched ``merkle._h_leaf``: (B, L) uint8 → (B, 32) uint8."""
    return sha256_tagged(leaves, 0)


def node_hashes(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched ``merkle._h_node``: two (B, 32) uint8 → (B, 32) uint8."""
    return sha256_tagged(torch.cat([left, right], dim=1), 1)


def tree_levels(leaves: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """All T proposers' Merkle levels.

    ``leaves``: (T, n, leaf_len) uint8 real leaves.  Returns the tuple of
    levels ((T, size, 32), (T, size/2, 32), …, (T, 1, 32)) with ``size``
    the next power of two ≥ n and missing leaves padded with
    ``_h_leaf(b"")`` — the construction of ``MerkleTree.__init__``, so a
    host tree built from these levels is bit-identical to one that hashed
    on the host.  A level's (T, 2h, 32) rows are its (T·h, 64) node pairs
    as they lie, so each level above the leaves is one launch on a view."""
    n_trees, n_leaves, leaf_len = leaves.shape
    size = 1
    while size < n_leaves:
        size *= 2
    level = sha256_tagged(leaves.reshape(n_trees * n_leaves, leaf_len), 0)
    level = level.reshape(n_trees, n_leaves, 32)
    if size > n_leaves:
        pad = torch.tensor(list(EMPTY_LEAF), dtype=torch.uint8, device=leaves.device)
        level = torch.cat([level, pad.expand(n_trees, size - n_leaves, 32)], dim=1)
    levels = [level]
    while level.shape[1] > 1:
        half = level.shape[1] // 2
        level = sha256_tagged(level.reshape(n_trees * half, 64), 1).reshape(n_trees, half, 32)
        levels.append(level)
    return tuple(levels)


#: Batched Merkle proof walk over PackedProofs-shaped tensors: (P,) bool,
#: one verdict per proof.  Same walk as ``merkle.Proof.validate``.
verify_proofs = sha256_proofs
