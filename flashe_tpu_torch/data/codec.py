"""Key/value codec shared by persistent tables and egg processors (port
of flashe_tpu/data/codec.py: the same bytes and the same routing, so a
table either package writes routes alike in the other).

A persistent DTable's records are pickled on the way into the storage
node, and partition routing hashes the pickled key with crc32 so the
layout is stable across *processes* (python's builtin `hash` is
per-process salted).  The egg compute plane (data/egg.py) runs inside
the storage node's process tree and must route shuffle output with the
exact same rule the client uses, so the rule lives here, in one place.

Reference role: eggroll serializes DTable records the same way on both
the client and processor sides (arch/api/table/table.py:25-179 against
the eggroll cluster runtime).
"""

from __future__ import annotations

import pickle
import zlib

__all__ = ["enc", "dec", "part_of"]


def enc(obj) -> bytes:
    return pickle.dumps(obj, protocol=4)


def dec(b: bytes):
    return pickle.loads(b)


def part_of(key_bytes: bytes, nparts: int) -> int:
    return zlib.crc32(key_bytes) % nparts
