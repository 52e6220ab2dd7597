"""Persistent partitioned KV store (port of flashe_tpu/data/kvstore.py) —
binding for the native C++ storage node (csrc/kvstore.cpp, the port's copy
of native/kvstore.cpp; the eggroll storage-service-cxx analogue), built by
flashe_tpu_torch/native.py into build/flashe_tpu_torch/.

`open_store(dir, nparts)` returns a KVStore backed by the compiled
library when g++ is available, else by a pure-python implementation of
the SAME on-disk format (per-partition append-only logs with tombstones
and torn-tail truncation), so files written by either are readable by
both (pinned in tests/test_torch_kvstore.py), and by the JAX package's
store as well.

This is the storage layer under the persistent Session
(flashe_tpu_torch/data/table.py `init(..., storage_dir=...)`) — the stand-in
for FATE standalone work mode's local LMDB tables
(arch/api/transfer/standalone.py; eggroll v1.1.3 storage node).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterator, Optional, Tuple

__all__ = ["KVStore", "open_store"]

_TOMBSTONE = 0xFFFFFFFF


class _NativeLib:
    _lib = None
    _tried = False

    @classmethod
    def get(cls):
        if cls._tried:
            return cls._lib
        cls._tried = True
        try:
            from flashe_tpu_torch.native import build_lib

            lib = build_lib("kvstore.cpp", "libflashekv.so")
            if lib is None:
                return None
            lib.kv_open.restype = ctypes.c_void_p
            lib.kv_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.kv_close.argtypes = [ctypes.c_void_p]
            lib.kv_put.restype = ctypes.c_int
            lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_uint32,
                                   ctypes.c_char_p, ctypes.c_uint32]
            lib.kv_del.restype = ctypes.c_int
            lib.kv_del.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_uint32]
            lib.kv_get_len.restype = ctypes.c_int64
            lib.kv_get_len.argtypes = lib.kv_del.argtypes
            lib.kv_get.restype = ctypes.c_int
            lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_uint32,
                                   ctypes.c_char_p]
            lib.kv_count.restype = ctypes.c_int64
            lib.kv_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.kv_flush.argtypes = [ctypes.c_void_p]
            lib.kv_iter_open.restype = ctypes.c_void_p
            lib.kv_iter_open.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.kv_iter_close.argtypes = [ctypes.c_void_p]
            lib.kv_iter_next_lens.restype = ctypes.c_int
            lib.kv_iter_next_lens.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32)]
            lib.kv_iter_fill.restype = ctypes.c_int
            lib.kv_iter_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
            cls._lib = lib
        except Exception:
            cls._lib = None
        return cls._lib


class KVStore:
    """Partitioned bytes->bytes store; see module docstring."""

    def __init__(self, directory: str, nparts: int = 1,
                 force_python: bool = False):
        self.directory = directory
        self.nparts = nparts
        self._lib = None if force_python else _NativeLib.get()
        if self._lib is not None:
            self._h = self._lib.kv_open(directory.encode(), nparts)
            if not self._h:
                raise OSError(f"kv_open failed for {directory}")
        else:
            self._h = None
            self._py = _PyStore(directory, nparts)

    @property
    def native(self) -> bool:
        return self._h is not None

    def put(self, part: int, key: bytes, value: bytes):
        if self._h is not None:
            if self._lib.kv_put(self._h, part, key, len(key), value,
                                len(value)) != 0:
                raise OSError("kv_put failed")
        else:
            self._py.put(part, key, value)

    def get(self, part: int, key: bytes) -> Optional[bytes]:
        if self._h is not None:
            n = self._lib.kv_get_len(self._h, part, key, len(key))
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(int(n))
            if self._lib.kv_get(self._h, part, key, len(key), buf) != 0:
                raise OSError("kv_get failed")
            return buf.raw[: int(n)]
        return self._py.get(part, key)

    def delete(self, part: int, key: bytes) -> bool:
        if self._h is not None:
            return self._lib.kv_del(self._h, part, key, len(key)) == 0
        return self._py.delete(part, key)

    def count(self, part: int) -> int:
        if self._h is not None:
            return int(self._lib.kv_count(self._h, part))
        return self._py.count(part)

    def items(self, part: int) -> Iterator[Tuple[bytes, bytes]]:
        if self._h is None:
            yield from self._py.items(part)
            return
        it = self._lib.kv_iter_open(self._h, part)
        try:
            klen = ctypes.c_uint32()
            vlen = ctypes.c_uint32()
            while True:
                rc = self._lib.kv_iter_next_lens(
                    it, ctypes.byref(klen), ctypes.byref(vlen))
                if rc == 1:
                    break
                if rc != 0:
                    raise OSError("kv_iter failed")
                kbuf = ctypes.create_string_buffer(klen.value or 1)
                vbuf = ctypes.create_string_buffer(vlen.value or 1)
                if self._lib.kv_iter_fill(it, kbuf, vbuf) != 0:
                    raise OSError("kv_iter_fill failed")
                yield kbuf.raw[: klen.value], vbuf.raw[: vlen.value]
        finally:
            self._lib.kv_iter_close(it)

    def flush(self):
        if self._h is not None:
            self._lib.kv_flush(self._h)
        else:
            self._py.flush()

    def close(self):
        if self._h is not None:
            self._lib.kv_close(self._h)
            self._h = None
        elif hasattr(self, "_py"):
            self._py.close()


class _PyStore:
    """Pure-python reader/writer of the native log format."""

    def __init__(self, directory: str, nparts: int):
        os.makedirs(directory, exist_ok=True)
        self._files = []
        self._index = []  # list of dict key -> (off, len)
        for i in range(nparts):
            path = os.path.join(directory, f"p{i}.log")
            idx = {}
            end = 0
            if os.path.exists(path):
                size = os.path.getsize(path)
                with open(path, "rb") as fh:
                    while True:
                        hdr = fh.read(8)
                        if len(hdr) < 8:
                            break
                        klen, vfield = struct.unpack("<II", hdr)
                        vlen = 0 if vfield == _TOMBSTONE else vfield
                        key = fh.read(klen)
                        if len(key) < klen:
                            break
                        voff = end + 8 + klen
                        if voff + vlen > size:
                            break
                        fh.seek(vlen, 1)
                        if vfield == _TOMBSTONE:
                            idx.pop(key, None)
                        else:
                            idx[key] = (voff, vlen)
                        end = voff + vlen
                with open(path, "r+b") as fh:
                    fh.truncate(end)
            f = open(path, "a+b")
            self._files.append(f)
            self._index.append(idx)

    def put(self, part: int, key: bytes, value: bytes):
        f = self._files[part]
        f.seek(0, 2)
        off = f.tell()
        f.write(struct.pack("<II", len(key), len(value)) + key + value)
        self._index[part][key] = (off + 8 + len(key), len(value))

    def get(self, part: int, key: bytes) -> Optional[bytes]:
        loc = self._index[part].get(key)
        if loc is None:
            return None
        f = self._files[part]
        f.flush()
        f.seek(loc[0])
        return f.read(loc[1])

    def delete(self, part: int, key: bytes) -> bool:
        if key not in self._index[part]:
            return False
        f = self._files[part]
        f.seek(0, 2)
        f.write(struct.pack("<II", len(key), _TOMBSTONE) + key)
        del self._index[part][key]
        return True

    def count(self, part: int) -> int:
        return len(self._index[part])

    def items(self, part: int):
        for key in list(self._index[part]):
            val = self.get(part, key)
            if val is not None:
                yield key, val

    def flush(self):
        for f in self._files:
            f.flush()

    def close(self):
        for f in self._files:
            f.close()


def _pin_nparts(directory: str, nparts: int) -> int:
    """Persist the partition count at store creation; on reopen, the
    on-disk value wins.  Without this, reopening with a different
    `nparts` silently loses keys (fewer parts → higher p*.log files
    unread; more parts → crc32 routing no longer finds existing keys).
    """
    meta = os.path.join(directory, "META")
    if os.path.exists(meta):
        with open(meta, "r") as fh:
            for line in fh:
                if line.startswith("nparts="):
                    return int(line.split("=", 1)[1])
        return nparts
    os.makedirs(directory, exist_ok=True)
    tmp = meta + f".tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(f"nparts={nparts}\n")
    os.replace(tmp, meta)
    return nparts


def open_store(directory: str, nparts: int = 1,
               force_python: bool = False) -> KVStore:
    return KVStore(directory, _pin_nparts(directory, nparts),
                   force_python)
