"""ctypes binding for the C++ segmented log (native/nomadlog).

The durable raft-log store (reference raft-boltdb). Record payloads are
opaque bytes; the raft layer picks the codec (pickle in-proc, msgpack on
the wire).

Copied from ``nomad_tpu/native/log.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. It loads the port's own build of the
same unedited ``native/nomadlog/nomadlog.cpp``, so the file format is the
same: a log either package writes, the other reads. No change but the
docstring.
"""
from __future__ import annotations

import ctypes
from typing import Optional

from . import ensure_built

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built("libnomadlog.so")
    lib = ctypes.CDLL(path)
    lib.nomadlog_open.restype = ctypes.c_void_p
    lib.nomadlog_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.nomadlog_append.restype = ctypes.c_int
    lib.nomadlog_append.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.nomadlog_sync.restype = ctypes.c_int
    lib.nomadlog_sync.argtypes = [ctypes.c_void_p]
    lib.nomadlog_first_index.restype = ctypes.c_uint64
    lib.nomadlog_first_index.argtypes = [ctypes.c_void_p]
    lib.nomadlog_last_index.restype = ctypes.c_uint64
    lib.nomadlog_last_index.argtypes = [ctypes.c_void_p]
    lib.nomadlog_get.restype = ctypes.c_int
    lib.nomadlog_get.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.nomadlog_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.nomadlog_truncate_before.restype = ctypes.c_int
    lib.nomadlog_truncate_before.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.nomadlog_truncate_after.restype = ctypes.c_int
    lib.nomadlog_truncate_after.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.nomadlog_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeLog:
    """Durable append-only log over the C++ engine."""

    def __init__(self, directory: str, segment_bytes: int = 64 << 20) -> None:
        self._lib = _load()
        self._h = self._lib.nomadlog_open(directory.encode(), segment_bytes)
        if not self._h:
            raise OSError(f"nomadlog_open({directory}) failed")

    def append(self, index: int, data: bytes, sync: bool = False) -> None:
        rc = self._lib.nomadlog_append(self._h, index, data, len(data))
        if rc != 0:
            raise OSError(f"nomadlog_append({index}) failed")
        if sync:
            self.sync()

    def sync(self) -> None:
        if self._lib.nomadlog_sync(self._h) != 0:
            raise OSError("nomadlog_sync failed")

    @property
    def first_index(self) -> int:
        return self._lib.nomadlog_first_index(self._h)

    @property
    def last_index(self) -> int:
        return self._lib.nomadlog_last_index(self._h)

    def get(self, index: int) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint32()
        rc = self._lib.nomadlog_get(self._h, index, ctypes.byref(out), ctypes.byref(out_len))
        if rc != 0:
            return None
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.nomadlog_free(out)

    def truncate_before(self, upto: int) -> None:
        self._lib.nomadlog_truncate_before(self._h, upto)

    def truncate_after(self, from_index: int) -> None:
        self._lib.nomadlog_truncate_after(self._h, from_index)

    def close(self) -> None:
        if self._h:
            self._lib.nomadlog_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
