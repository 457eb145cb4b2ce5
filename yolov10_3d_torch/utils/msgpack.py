"""The port's own msgpack codec, for the subset that flax's
``serialization.msgpack_serialize`` and ``msgpack_restore`` use (the body of
a ``.ckpt`` file, ``utils/checkpoint.py``). The machines the port runs on
need neither msgpack nor flax.

Types: nil, bool, ints (fixint up to int64 and uint64), float64 (a float32
decodes too), str, bin, array and map of every width. Ext code 1 is an
ndarray: its payload is itself a packed ``(shape, dtype name, C-order
bytes)``; ext code 3 a numpy scalar, packed as a 0-d ndarray; ext code 2 a
complex. ``bfloat16`` leaves, which numpy lacks, decode to ``torch.bfloat16``
tensors, and torch tensors encode as the ndarray of their values.

``pack_segments(tree)`` gives the same bytes split at the arrays: the
bytes between two arrays, and each array's bytes. ``layout(tree)`` states
what the encoding holds apart from the arrays' bytes, so that a tree of a
known layout can be written into a known image (``utils/checkpoint.py``
``Snapshot``).

``packb(tree)`` gives the bytes of ``msgpack.packb(tree, default=flax's
ext pack, strict_types=True, use_bin_type=True)``: maps in their iteration
order, the smallest width for every int, length and ext. ``unpackb(data)``
gives what ``msgpack_restore`` gives: dicts, lists, numpy arrays (read-only
views of ``data``), numpy scalars.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class _Raw:
    """An array's bytes among the encoded parts (what a layout does not hold)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data


# ------------------------------------------------------------------ encode
def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(struct.pack("B", code) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit in uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(struct.pack("B", code) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit in int64")


def _pack_len(n: int, fix: Tuple[int, int], codes: Tuple[int, ...], out: List[bytes]) -> None:
    """A str/bin/array/map header: the fix form below ``fix[1]`` when there
    is one, else the 8-, 16- or 32-bit length form (``None`` where a type
    lacks one)."""
    if fix and n < fix[1]:
        out.append(struct.pack("B", fix[0] | n))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(struct.pack("B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is beyond msgpack's 32-bit limit")


def _pack_ext(code: int, parts: List[Any], n: int, out: List[Any]) -> None:
    """An ext of ``code`` whose payload is ``parts`` (``n`` bytes in all)."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    else:
        for head, fmt, top in ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                               (0xC9, ">I", 0xFFFFFFFF)):
            if n <= top:
                out.append(struct.pack("B", head) + struct.pack(fmt, n) + struct.pack("b", code))
                break
        else:
            raise ValueError(f"ext payload of {n} bytes is beyond msgpack's 32-bit limit")
    out.extend(parts)


def _array_parts(x) -> Tuple[tuple, str, Any]:
    """(shape, dtype name, C-order bytes) of an ndarray, numpy scalar or
    torch tensor (bfloat16 by its bit pattern); the bytes of a C-contiguous
    array are a view of its memory, not a copy."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.contiguous().view(torch.int16).numpy().tobytes()
        x = t.numpy()
    arr = np.asarray(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    raw = memoryview(arr).cast("B") if arr.flags.c_contiguous and arr.size else arr.tobytes("C")
    return tuple(int(s) for s in arr.shape), arr.dtype.name, raw


def _ndarray_payload(x) -> Tuple[List[Any], int]:
    """The ext payload, ``msgpack.packb((shape, dtype name, bytes))``, as
    parts and their total length."""
    shape, name, raw = _array_parts(x)
    out: List[Any] = []
    _pack_len(3, (0x90, 16), (None, 0xDC, 0xDD), out)
    _pack_len(len(shape), (0x90, 16), (None, 0xDC, 0xDD), out)
    for s in shape:
        _pack_int(s, out)
    _pack_str(name, out)
    _pack_len(len(raw), (), (0xC4, 0xC5, 0xC6), out)
    n = sum(len(p) for p in out) + len(raw)
    out.append(_Raw(raw))
    return out, n


def _pack_str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _pack(obj: Any, out: List[bytes]) -> None:
    kind = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif kind is int:
        _pack_int(obj, out)
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif kind is str:
        _pack_str(obj, out)
    elif kind is bytes:
        _pack_len(len(obj), (), (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif kind is list:
        _pack_len(len(obj), (0x90, 16), (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif kind is dict:
        _pack_len(len(obj), (0x80, 16), (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, *_ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, *_ndarray_payload(np.asarray(obj)), out)
    elif kind is complex:
        body = b"\x92\xcb" + struct.pack(">d", obj.real) + b"\xcb" + struct.pack(">d", obj.imag)
        _pack_ext(EXT_COMPLEX, [body], len(body), out)
    else:
        raise TypeError(f"can not serialize {kind.__name__!r} object")


def pack_parts(tree: Any) -> List[Any]:
    """The msgpack encoding of ``tree`` as consecutive parts (bytes, and
    views of the arrays' memory), for writing without joining them."""
    out: List[Any] = []
    _pack(tree, out)
    return [p.data if isinstance(p, _Raw) else p for p in out]


def layout(tree: Any, leaves: List[Any]) -> Any:
    """A hashable statement of what ``tree`` encodes to apart from its
    arrays' bytes (keys, shapes, dtypes, scalar values); the arrays (numpy
    scalars as 0-d arrays) appended to ``leaves`` in encoding order."""
    if isinstance(tree, dict):
        return ("d", tuple((k, layout(v, leaves)) for k, v in tree.items()))
    if type(tree) is list:
        return ("l", tuple(layout(v, leaves) for v in tree))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("t", tuple(tree.shape), str(tree.dtype))
    if isinstance(tree, np.ndarray):
        leaves.append(tree)
        return ("a", tree.shape, tree.dtype.str)
    if isinstance(tree, np.generic):
        leaves.append(np.asarray(tree))
        return ("s", tree.dtype.str)
    return ("v", type(tree), tree)


def pack_segments(tree: Any) -> Tuple[List[bytes], List[Any]]:
    """The encoding of ``tree`` split at its arrays: ``heads`` (one more than
    there are arrays) and the arrays' bytes, ``heads[0] + raws[0] + heads[1]
    + ... + heads[-1]``."""
    out: List[Any] = []
    _pack(tree, out)
    heads, raws, run = [], [], []
    for p in out:
        if isinstance(p, _Raw):
            heads.append(b"".join(run))
            raws.append(p.data)
            run = []
        else:
            run.append(p)
    heads.append(b"".join(run))
    return heads, raws


def packb(tree: Any) -> bytes:
    """``tree`` (dicts, lists, Python scalars, str, bytes, ndarrays, numpy
    scalars, torch tensors) -> msgpack bytes."""
    return b"".join(pack_parts(tree))


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (the ndarray payload's dtype name)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError("truncated msgpack data")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def items(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def read(self) -> Any:
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.items(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self.str_(n)
            if b in (0xDC, 0xDD):
                return self.items(n)
            if b in (0xDE, 0xDF):
                return self.mapping(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _ndarray_from(payload: memoryview):
    shape, name, raw = _Reader(payload, raw=True).read()
    if name == b"bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.int16) if len(raw) else \
            torch.zeros(0, dtype=torch.int16)
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _ext_unpack(code: int, payload: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray_from(payload)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    if code == EXT_COMPLEX:
        re_, im = _Reader(payload).read()
        return complex(re_, im)
    raise ValueError(f"unsupported msgpack ext code {code}")


def _refuse_chunked(tree: Any) -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise NotImplementedError(
                "a chunked array leaf (flax splits arrays above 2**30 bytes): the port's "
                "codec does not read it, and no model of this repository comes near that size")
        for v in tree.values():
            _refuse_chunked(v)
    elif isinstance(tree, list):
        for v in tree:
            _refuse_chunked(v)


def unpackb(data: bytes) -> Any:
    """msgpack bytes -> the tree ``flax.serialization.msgpack_restore`` gives."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError(f"{len(reader.view) - reader.pos} bytes of extra data after the tree")
    _refuse_chunked(tree)
    return tree
