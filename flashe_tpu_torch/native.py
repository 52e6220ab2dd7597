"""Builds the port's native C++ storage node (port of the part of
flashe_tpu/native.py that the table data plane uses: `_compile`,
`build_lib`, `kvserver_binary`).

- csrc/kvstore.cpp: the persistent KV store, bound through ctypes by
  flashe_tpu_torch/data/kvstore.py (pure-python fallback there);
- csrc/kvserver.cpp: the networked storage node, spawned by
  flashe_tpu_torch/data/remote_kv.py (pure-python server fallback there).

Both build with g++ on first use into build/flashe_tpu_torch/ at the
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

from flashe_tpu_torch.ops._build import build_dir

__all__ = ["build_lib", "kvserver_binary", "last_error"]

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
    """Why the last build of `name` ("kvstore" or "kvserver") failed in
    this process, or None."""
    return _errors.get(name)


def build_lib(src_name: str, lib_name: str):
    """Compile csrc/<src_name> into build/flashe_tpu_torch/<lib_name> on
    first use (again when the source is newer) and return its CDLL handle;
    None when it cannot be built (callers keep a pure-python fallback)."""
    src = os.path.join(_CSRC, src_name)
    out = str(build_dir() / lib_name)
    with _lock:
        try:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            if _stale(out, src):
                _compile(src, out, ["-O2", "-shared", "-fPIC"])
            return ctypes.CDLL(out)
        except Exception as e:
            _note(os.path.splitext(src_name)[0], e)
            return None


_kvsrv_state = {"tried": False, "path": None}


def kvserver_binary() -> str | None:
    """Builds (if stale) and returns the storage-node executable
    (csrc/kvserver.cpp, which includes csrc/kvstore.cpp), or None when it
    cannot be built."""
    with _lock:
        if _kvsrv_state["tried"]:
            return _kvsrv_state["path"]
        _kvsrv_state["tried"] = True
        src = os.path.join(_CSRC, "kvserver.cpp")
        out = str(build_dir() / "kvserver")
        try:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            if _stale(out, src, os.path.join(_CSRC, "kvstore.cpp")):
                _compile(src, out, ["-O2", "-pthread", "-I", _CSRC])
            _kvsrv_state["path"] = out
        except Exception as e:
            _note("kvserver", e)
            _kvsrv_state["path"] = None
        return _kvsrv_state["path"]
