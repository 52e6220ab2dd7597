"""Builds the port's native C++ components (port of
flashe_tpu/native.py).

- csrc/packing.cpp: wire bit-packing, bound through ctypes
  (`pack_lanes`, `unpack_lanes`); flashe_tpu_torch/ops/pack.py keeps the
  numpy path as the plain version and the fallback;
- csrc/fedbroker.cpp: the federation exchange executable
  (`broker_binary`), spawned by flashe_tpu_torch/fed/tcp.py, which keeps a
  pure-Python broker as the fallback;
- csrc/kvstore.cpp: the persistent KV store, bound through ctypes by
  flashe_tpu_torch/data/kvstore.py (pure-python fallback there);
- csrc/kvserver.cpp: the networked storage node, spawned by
  flashe_tpu_torch/data/remote_kv.py (pure-python server fallback there).

Each builds with g++ on first use into build/flashe_tpu_torch/ at the
repository root (the directory the port's CUDA kernels build into, which
git ignores), never into the JAX package's native/.  Without a compiler
the callers keep their pure-python fallbacks.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from flashe_tpu_torch.ops._build import build_dir

__all__ = ["build_lib", "kvserver_binary", "broker_binary", "available",
           "pack_lanes", "unpack_lanes", "calls", "last_error"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

_lock = threading.Lock()
_errors: dict = {}


def _compile(src: str, out: str, flags: list[str]):
    """Compile to a per-process temp path, then os.replace() onto the
    target: several processes may build at once, and an atomic rename
    guarantees that none dlopen()s or execs a partially written file."""
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *flags, "-o", tmp, src],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stale(out: str, *srcs: str) -> bool:
    return not os.path.exists(out) or os.path.getmtime(out) < max(
        os.path.getmtime(s) for s in srcs)


def _note(name: str, err: BaseException):
    if isinstance(err, subprocess.CalledProcessError):
        detail = (err.stderr or b"").decode("utf-8", "replace")[-2000:]
        err = f"{err}: {detail}"
    _errors[name] = str(err)


def last_error(name: str) -> str | None:
    """Why the last build of `name` ("kvstore", "kvserver", "packing" or
    "fedbroker") failed in this process, or None."""
    return _errors.get(name)


def _build(src_name: str, out_name: str, flags: list[str],
           *deps: str) -> str:
    """Compile csrc/<src_name> (which includes csrc/<deps>) into
    build/flashe_tpu_torch/<out_name> unless it is newer than all of them;
    returns its path."""
    src = os.path.join(_CSRC, src_name)
    out = str(build_dir() / out_name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if _stale(out, src, *(os.path.join(_CSRC, d) for d in deps)):
        _compile(src, out, flags)
    return out


def build_lib(src_name: str, lib_name: str, opt: str = "-O2"):
    """Compile csrc/<src_name> into build/flashe_tpu_torch/<lib_name> on
    first use (again when the source is newer) and return its CDLL handle;
    None when it cannot be built (callers keep a pure-python fallback)."""
    with _lock:
        try:
            return ctypes.CDLL(_build(src_name, lib_name,
                                      [opt, "-shared", "-fPIC"]))
        except Exception as e:
            _note(os.path.splitext(src_name)[0], e)
            return None


_kvsrv_state = {"tried": False, "path": None}
_broker_state = {"tried": False, "path": None}
_pack_state = {"tried": False, "lib": None}


def _binary(state: dict, name: str, flags: list[str], *deps: str):
    """Builds csrc/<name>.cpp into an executable once a process (again
    when the source is newer); its path, or None when it cannot be
    built."""
    with _lock:
        if not state["tried"]:
            state["tried"] = True
            try:
                state["path"] = _build(f"{name}.cpp", name, flags, *deps)
            except Exception as e:
                _note(name, e)
        return state["path"]


def kvserver_binary() -> str | None:
    """Builds (if stale) and returns the storage-node executable
    (csrc/kvserver.cpp, which includes csrc/kvstore.cpp), or None when it
    cannot be built."""
    return _binary(_kvsrv_state, "kvserver", ["-O2", "-pthread", "-I", _CSRC],
                   "kvstore.cpp")


def broker_binary() -> str | None:
    """Builds (if stale) and returns the federation broker executable
    (csrc/fedbroker.cpp), or None when it cannot be built."""
    return _binary(_broker_state, "fedbroker", ["-O3", "-pthread"])


def _packer():
    """The CDLL of csrc/packing.cpp, built once a process; None when it
    cannot be built."""
    if not _pack_state["tried"]:
        lib = build_lib("packing.cpp", "libflashepack.so", opt="-O3")
        if lib is not None:
            for fn, data, out in (("pack_lanes_u32", ctypes.c_uint32,
                                   ctypes.c_uint8),
                                  ("unpack_lanes_u32", ctypes.c_uint8,
                                   ctypes.c_uint32)):
                f = getattr(lib, fn)
                f.argtypes = [ctypes.POINTER(data), ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int32,
                              ctypes.POINTER(out)]
                f.restype = None
        with _lock:
            _pack_state.update(tried=True, lib=lib)
    return _pack_state["lib"]


def available() -> bool:
    """Whether the native packer builds and loads here."""
    return _packer() is not None


# calls of the native packer in this process, by function (what shows that
# a path went through it)
calls = {"pack": 0, "unpack": 0}


def _count(fn: str):
    with _lock:
        calls[fn] += 1


def _nlimbs(int_bits: int) -> int:
    """ops/lanes.py's nlimbs_for (this module imports no torch)."""
    return (int_bits + 31) // 32


def _u32(lanes) -> np.ndarray:
    """Host lanes as a contiguous uint32 array: the port's int32 carrier
    is viewed as its bit patterns, any other dtype cast as the numpy path
    casts it."""
    arr = np.ascontiguousarray(lanes)
    if arr.dtype == np.int32:
        return arr.view(np.uint32)
    return np.ascontiguousarray(arr, dtype=np.uint32)


def pack_lanes(lanes, int_bits: int) -> bytes | None:
    """(n,) lanes (int_bits <= 32; any shape, flattened) or (n, L) limbs
    (L at least the limbs of int_bits) -> the big-endian packed bytes of their
    low int_bits bits, as ops/pack.py's numpy path packs them; None when
    the native packer is not available."""
    lib = _packer()
    if lib is None:
        return None
    arr = _u32(lanes)
    if _nlimbs(int_bits) == 1:
        arr = arr.reshape(-1)
        n, nlimbs = arr.shape[0], 1
    elif arr.ndim == 2 and arr.shape[1] >= _nlimbs(int_bits):
        n, nlimbs = arr.shape
    else:
        raise ValueError(f"lanes of shape {arr.shape} hold no "
                         f"{_nlimbs(int_bits)} limbs an element for "
                         f"int_bits {int_bits}")
    out = np.zeros((n * int_bits + 7) // 8, np.uint8)
    lib.pack_lanes_u32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n, nlimbs,
        int_bits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    _count("pack")
    return out.tobytes()


def unpack_lanes(data: bytes, n: int, int_bits: int) -> np.ndarray | None:
    """The last ceil(n * int_bits / 8) bytes of `data` -> (n,) uint32 (or
    (n, L) limb) lanes, as ops/pack.py's numpy path unpacks them; None when
    the native packer is not available."""
    lib = _packer()
    if lib is None:
        return None
    nbytes = (n * int_bits + 7) // 8
    buf = np.frombuffer(data, np.uint8)
    if buf.size < nbytes:
        raise ValueError(f"{buf.size} bytes hold no {n} lanes of "
                         f"{int_bits} bits")
    buf = np.ascontiguousarray(buf[buf.size - nbytes:])
    nlimbs = _nlimbs(int_bits)
    out = np.zeros(n * nlimbs, np.uint32)
    lib.unpack_lanes_u32(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, nlimbs,
        int_bits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    _count("unpack")
    return out.reshape(n, nlimbs) if nlimbs > 1 else out
