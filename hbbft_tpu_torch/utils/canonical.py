"""Canonical deterministic serialization (the `bincode` analogue).

The reference serializes every signed/encrypted structure with
`bincode`+serde (SURVEY.md §2.2), which is canonical and deterministic —
a requirement for signatures to verify across nodes.  Python's pickle is
neither, so this module defines a tiny self-describing tag-length-value
encoding over the primitive tree types protocols actually sign/encrypt:
``None, bool, int, bytes, str, list, tuple, dict``.

Dicts are serialized with keys sorted by their own encoding, making the
output independent of insertion order.  Ints are arbitrary-precision,
zig-zag-free (sign byte + magnitude).  The port's copy of the JAX
package's ``utils/canonical.py``.
"""

from __future__ import annotations

from typing import Any

_T_NONE = b"\x00"
_T_FALSE = b"\x01"
_T_TRUE = b"\x02"
_T_INT = b"\x03"
_T_BYTES = b"\x04"
_T_STR = b"\x05"
_T_LIST = b"\x06"
_T_TUPLE = b"\x07"
_T_DICT = b"\x08"


def _len_prefix(n: int) -> bytes:
    return n.to_bytes(4, "big")


def encode(obj: Any) -> bytes:
    """Canonically encode a primitive tree."""
    if obj is None:
        return _T_NONE
    if obj is False:
        return _T_FALSE
    if obj is True:
        return _T_TRUE
    if isinstance(obj, int):
        neg = obj < 0
        mag = (-obj if neg else obj).to_bytes((abs(obj).bit_length() + 7) // 8 or 1, "big")
        return _T_INT + (b"\x01" if neg else b"\x00") + _len_prefix(len(mag)) + mag
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        return _T_BYTES + _len_prefix(len(b)) + b
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _T_STR + _len_prefix(len(b)) + b
    if isinstance(obj, list):
        parts = [encode(x) for x in obj]
        return _T_LIST + _len_prefix(len(parts)) + b"".join(parts)
    if isinstance(obj, tuple):
        parts = [encode(x) for x in obj]
        return _T_TUPLE + _len_prefix(len(parts)) + b"".join(parts)
    if isinstance(obj, dict):
        items = sorted((encode(k), encode(v)) for k, v in obj.items())
        return _T_DICT + _len_prefix(len(items)) + b"".join(k + v for k, v in items)
    raise TypeError(f"cannot canonically encode {type(obj).__name__}")


def encode_batch(objs) -> list:
    """Canonical encodings of many trees at once.

    Byte-identical to ``[encode(o) for o in objs]``; the dominant leaf
    shape (a plain ``bytes`` payload — every contribution the array
    engine frames, N per epoch) is inlined so the batch pays one frame
    per item instead of the full recursive dispatch."""
    out = []
    append = out.append
    for obj in objs:
        if type(obj) is bytes:
            append(_T_BYTES + _len_prefix(len(obj)) + obj)
        else:
            append(encode(obj))
    return out


def decode(data: bytes) -> Any:
    obj, off = _decode(data, 0)
    if off != len(data):
        raise ValueError("trailing bytes")
    return obj


def decode_batch(blobs) -> list:
    """Canonical decodes of many blobs at once (inverse of
    :func:`encode_batch`): the bare-``bytes`` payload fast path slices
    the value straight out of the frame; anything else takes the full
    recursive decode.  Equals ``[decode(b) for b in blobs]``."""
    out = []
    append = out.append
    for data in blobs:
        if data[:1] == _T_BYTES:
            n = int.from_bytes(data[1:5], "big")
            if len(data) == 5 + n:
                append(data[5:])
                continue
        append(decode(data))
    return out


def _decode(data: bytes, off: int):
    tag = data[off : off + 1]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_INT:
        neg = data[off] == 1
        n = int.from_bytes(data[off + 1 : off + 5], "big")
        mag = int.from_bytes(data[off + 5 : off + 5 + n], "big")
        return (-mag if neg else mag), off + 5 + n
    if tag == _T_BYTES:
        n = int.from_bytes(data[off : off + 4], "big")
        return data[off + 4 : off + 4 + n], off + 4 + n
    if tag == _T_STR:
        n = int.from_bytes(data[off : off + 4], "big")
        return data[off + 4 : off + 4 + n].decode("utf-8"), off + 4 + n
    if tag in (_T_LIST, _T_TUPLE):
        n = int.from_bytes(data[off : off + 4], "big")
        off += 4
        out = []
        for _ in range(n):
            x, off = _decode(data, off)
            out.append(x)
        return (out if tag == _T_LIST else tuple(out)), off
    if tag == _T_DICT:
        n = int.from_bytes(data[off : off + 4], "big")
        off += 4
        out = {}
        for _ in range(n):
            k, off = _decode(data, off)
            v, off = _decode(data, off)
            out[k] = v
        return out, off
    raise ValueError(f"bad tag {tag!r} at {off - 1}")
