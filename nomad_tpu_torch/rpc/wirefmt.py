"""The msgpack wire format, packed and unpacked with nothing but ``struct``.

The RPC transport's frames, the raft log's records and the wire-raft
snapshots all go through :mod:`.codec`, whose bytes are msgpack: the
reference packs them with the ``msgpack`` package
(``msgpack.packb(obj, use_bin_type=True)``) and reads them with
``msgpack.unpackb(data, raw=False, strict_map_key=False)``. The port
carries its own copy of that format instead of the dependency, so a host
without ``msgpack`` still speaks the wire, and a peer of either package
reads the other's bytes.

:func:`packb` gives the same bytes as ``msgpack.packb(obj,
use_bin_type=True)`` for every value it accepts: nil, bool, int over the
signed and unsigned 64-bit range in msgpack's smallest width, float as
float64, str (UTF-8) and bin (``bytes``, ``bytearray``, ``memoryview``)
at every length class, list and tuple as arrays, dict as maps (in
iteration order), and :class:`ExtType`. It raises what msgpack raises on
what msgpack refuses: ``OverflowError`` on an int outside
[-2**63, 2**64), ``TypeError`` on any other type (``numpy.int64``, a
set), ``UnicodeEncodeError`` on a lone surrogate, ``ValueError`` past
511 levels of nesting or on a str or bin longer than 2**32 - 1 bytes.

:func:`unpackb` returns what ``msgpack.unpackb(data, raw=False,
strict_map_key=False)`` returns: arrays as lists, maps as dicts in wire
order, str decoded as strict UTF-8, bin as ``bytes``, float32 widened to
float. It raises ``ValueError`` on incomplete input, :class:`ExtraData`
on trailing bytes, :class:`FormatError` on the reserved byte 0xc1,
:class:`StackError` past 1,024 nested non-empty containers,
``UnicodeDecodeError`` on bad UTF-8 and ``TypeError`` on an unhashable
map key. One difference: an ext value comes back as :class:`ExtType`
whatever its code, where msgpack turns code -1 into its own
``Timestamp``; nothing in the port packs an ext value.
"""
from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any

__all__ = ["ExtType", "ExtraData", "FormatError", "StackError", "packb", "unpackb"]

#: msgpack's default nesting limit of the packer (``DEFAULT_RECURSE_LIMIT``)
PACK_NEST_LIMIT = 511
#: depth of the unpacker's container stack (``MSGPACK_EMBED_STACK_SIZE``)
UNPACK_STACK_DEPTH = 1024

_U32 = 1 << 32


class ExtType(namedtuple("ExtType", "code data")):
    """An ext value: a type code in [-128, 127] and its payload bytes
    (equal to msgpack's ``ExtType`` with the same fields)."""

    def __new__(cls, code: int, data: bytes) -> "ExtType":
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not -128 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class FormatError(ValueError):
    """Invalid msgpack format (the reserved byte 0xc1)."""


class StackError(ValueError):
    """Containers nested deeper than the unpacker's stack."""


class ExtraData(ValueError):
    """The input held bytes past its first complete object."""

    def __init__(self, unpacked: Any, extra: bytes) -> None:
        self.unpacked = unpacked
        self.extra = extra

    def __str__(self) -> str:
        return "unpack(b) received extra data."


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

_pack_be = struct.pack
_FLOAT64 = struct.Struct(">Bd").pack


def _pack_int(out: bytearray, n: int) -> None:
    if n > 0:
        # msgpack packs every positive int as unsigned
        if n < 0x80:
            out.append(n)
        elif n < 0x100:
            out += _pack_be(">BB", 0xCC, n)
        elif n < 0x10000:
            out += _pack_be(">BH", 0xCD, n)
        elif n < _U32:
            out += _pack_be(">BI", 0xCE, n)
        elif n < 1 << 64:
            out += _pack_be(">BQ", 0xCF, n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(n & 0xFF)
    elif n >= -0x80:
        out += _pack_be(">Bb", 0xD0, n)
    elif n >= -0x8000:
        out += _pack_be(">Bh", 0xD1, n)
    elif n >= -(1 << 31):
        out += _pack_be(">Bi", 0xD2, n)
    elif n >= -(1 << 63):
        out += _pack_be(">Bq", 0xD3, n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_bin(out: bytearray, data) -> None:
    n = len(data)
    if n < 0x100:
        out += _pack_be(">BB", 0xC4, n)
    elif n < 0x10000:
        out += _pack_be(">BH", 0xC5, n)
    elif n < _U32:
        out += _pack_be(">BI", 0xC6, n)
    else:
        raise ValueError(f"{type(data).__name__} object is too large")
    out += data


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        out.append(0xA0 | n)
    elif n < 0x100:
        out += _pack_be(">BB", 0xD9, n)
    elif n < 0x10000:
        out += _pack_be(">BH", 0xDA, n)
    elif n < _U32:
        out += _pack_be(">BI", 0xDB, n)
    else:
        raise ValueError("unicode string is too large")
    out += b


def _pack_header(out: bytearray, n: int, fix: int, b16: int, b32: int, fix_max: int,
                 what: str) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif n < 0x10000:
        out += _pack_be(">BH", b16, n)
    elif n < _U32:
        out += _pack_be(">BI", b32, n)
    else:
        raise ValueError(f"{what} is too large")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(out: bytearray, ext: ExtType) -> None:
    n = len(ext.data)
    head = _FIXEXT.get(n)
    if head is not None:
        out += _pack_be(">Bb", head, ext.code)
    elif n < 0x100:
        out += _pack_be(">BBb", 0xC7, n, ext.code)
    elif n < 0x10000:
        out += _pack_be(">BHb", 0xC8, n, ext.code)
    elif n < _U32:
        out += _pack_be(">BIb", 0xC9, n, ext.code)
    else:
        raise ValueError("EXT data is too large")
    out += ext.data


# packed str heads and bytes of short strings (field names, statuses,
# ids): the same bytes _pack_str gives, looked up instead of re-encoded
_STR_CACHE: dict = {}
_STR_CACHE_MAX = 16384
_STR_CACHE_LEN = 64


def _str_bytes(s: str) -> bytes:
    b = _STR_CACHE.get(s)
    if b is None:
        out = bytearray()
        _pack_str(out, s)
        b = bytes(out)
        if len(s) <= _STR_CACHE_LEN:
            if len(_STR_CACHE) >= _STR_CACHE_MAX:
                _STR_CACHE.clear()
            _STR_CACHE[s] = b
    return b


def _pack(out: bytearray, obj: Any, limit: int) -> None:
    if limit < 0:
        raise ValueError("recursion limit exceeded.")
    t = type(obj)
    # exact builtin types first (the common case), then their subclasses
    # in msgpack's own order: nil, bool, int, float, bin, str, map, ext,
    # array, memoryview
    if t is str:
        out += _str_bytes(obj)
    elif obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        if 0 <= obj < 0x80:
            out.append(obj)
        else:
            _pack_int(out, obj)
    elif t is dict:
        _pack_header(out, len(obj), 0x80, 0xDE, 0xDF, 16, "dict")
        inner = limit - 1
        if inner < 0 and obj:
            raise ValueError("recursion limit exceeded.")
        for k, v in obj.items():
            if type(k) is str:
                out += _str_bytes(k)
            else:
                _pack(out, k, inner)
            tv = type(v)
            if tv is str:
                out += _str_bytes(v)
            elif v is None:
                out.append(0xC0)
            elif tv is bool:
                out.append(0xC3 if v else 0xC2)
            elif tv is int and 0 <= v < 0x80:
                out.append(v)
            else:
                _pack(out, v, inner)
    elif t is list:
        _pack_header(out, len(obj), 0x90, 0xDC, 0xDD, 16, "list")
        for v in obj:
            _pack(out, v, limit - 1)
    elif t is float:
        out += _FLOAT64(0xCB, obj)
    elif t is bytes:
        _pack_bin(out, obj)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out += _FLOAT64(0xCB, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(out, obj)
    elif isinstance(obj, str):
        _pack_str(out, str(obj))
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 0xDE, 0xDF, 16, "dict")
        for k, v in obj.items():
            _pack(out, k, limit - 1)
            _pack(out, v, limit - 1)
    elif isinstance(obj, ExtType):
        _pack_ext(out, obj)
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 0xDC, 0xDD, 16, "list")
        for v in obj:
            _pack(out, v, limit - 1)
    elif isinstance(obj, memoryview):
        _pack_bin(out, obj.tobytes())
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` in msgpack, as ``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(out, obj, PACK_NEST_LIMIT)
    return bytes(out)


# ---------------------------------------------------------------------------
# unpacking
# ---------------------------------------------------------------------------

_INCOMPLETE = "Unpack failed: incomplete input"

# fixed-width heads: byte -> (struct format, size)
_FIXED = {
    0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
    0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
    0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
    0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
    0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q"),
}
_LEN = {1: struct.Struct(">B"), 2: struct.Struct(">H"), 4: struct.Struct(">I")}
# variable heads: byte -> (kind, width of the length field)
_VAR = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SCHAR = struct.Struct(">b")


def _raise_incomplete():
    raise ValueError(_INCOMPLETE)


def unpackb(data) -> Any:
    """One msgpack object from ``data``, as ``msgpack.unpackb(data,
    raw=False, strict_map_key=False)``. Iterative: nesting costs no Python
    recursion, and the container stack is bounded as msgpack's is."""
    data = bytes(data)
    end = len(data)
    pos = 0
    # open containers: [container, items left, is_map, pending map key]
    stack: list = []
    while True:
        if pos >= end:
            _raise_incomplete()
        b = data[pos]
        pos += 1
        opened = None
        if b < 0x80:
            obj = b
        elif b >= 0xE0:
            obj = b - 0x100
        elif b >= 0xA0 and b <= 0xBF:
            n = b & 0x1F
            if pos + n > end:
                _raise_incomplete()
            obj = data[pos:pos + n].decode("utf-8")
            pos += n
        elif b >= 0x90 and b <= 0x9F:
            n = b & 0x0F
            if n:
                opened = ([], n, False)
            else:
                obj = []
        elif b <= 0x8F:
            n = b & 0x0F
            if n:
                opened = ({}, n, True)
            else:
                obj = {}
        elif b == 0xC0:
            obj = None
        elif b == 0xC2:
            obj = False
        elif b == 0xC3:
            obj = True
        else:
            st = _FIXED.get(b)
            if st is not None:
                q = pos + st.size
                if q > end:
                    _raise_incomplete()
                obj = st.unpack_from(data, pos)[0]
                pos = q
            else:
                var = _VAR.get(b)
                fixext = _FIXEXT_LEN.get(b)
                if var is not None:
                    kind, width = var
                    lst = _LEN[width]
                    if pos + width > end:
                        _raise_incomplete()
                    n = lst.unpack_from(data, pos)[0]
                    pos += width
                    if kind == "array" or kind == "map":
                        if n:
                            opened = ({} if kind == "map" else [], n, kind == "map")
                        else:
                            obj = {} if kind == "map" else []
                    else:
                        if kind == "ext":
                            if pos + 1 > end:
                                _raise_incomplete()
                            code = _SCHAR.unpack_from(data, pos)[0]
                            pos += 1
                        if pos + n > end:
                            _raise_incomplete()
                        raw = data[pos:pos + n]
                        pos += n
                        if kind == "str":
                            obj = raw.decode("utf-8")
                        elif kind == "bin":
                            obj = raw
                        else:
                            obj = ExtType(code, raw)
                elif fixext is not None:
                    if pos + 1 + fixext > end:
                        _raise_incomplete()
                    code = _SCHAR.unpack_from(data, pos)[0]
                    obj = ExtType(code, data[pos + 1:pos + 1 + fixext])
                    pos += 1 + fixext
                else:
                    raise FormatError(f"Unpack failed: reserved byte 0x{b:02x}")
        if opened is not None:
            if len(stack) >= UNPACK_STACK_DEPTH:
                raise StackError("Unpack failed: containers nested too deep")
            stack.append([opened[0], opened[1], opened[2], _NO_KEY])
            continue
        # hand the finished object to the innermost open container,
        # closing every container it completes
        while stack:
            top = stack[-1]
            if top[2]:
                if top[3] is _NO_KEY:
                    top[3] = obj
                    break
                top[0][top[3]] = obj
                top[3] = _NO_KEY
            else:
                top[0].append(obj)
            top[1] -= 1
            if top[1]:
                break
            stack.pop()
            obj = top[0]
        else:
            if pos != end:
                raise ExtraData(obj, data[pos:])
            return obj


_NO_KEY = object()
