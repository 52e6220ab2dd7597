"""Build and load the port's CUDA kernels.

Each kernel is one `.cu` file under flashe_tpu_torch/csrc/ with a plain C
entry point.  At first use it is compiled with nvcc for sm_90a into a shared
library under build/flashe_tpu_torch/ at the repository root and loaded with
ctypes.  The library's file name carries a hash of the source and the flags,
so an edited source is rebuilt.  A build holds an exclusive `flock` on
build/flashe_tpu_torch/<name>.lock, so that of the processes that ask for
a missing library at once (a job's party processes) one builds it and the
rest wait and load it; the lock is released when its holder exits,
however it exits.  The compiler's messages, ptxas's registers and spills
of every kernel among them, are kept beside the library (`build_log`);
`sass_opcodes` counts the instructions of what was built, where the
toolkit's cuobjdump is at hand.  Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "nvcc_path", "compile_so", "load",
           "build_log", "ptxas_usage", "sass_opcodes", "count_sass"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    return _PKG.parent / "build" / "flashe_tpu_torch"


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "flashe_tpu_torch are built from source at first use")


def compile_so(src: Path, lib: Path, extra_flags=()) -> str:
    """nvcc src into the shared library lib (written whole or not at all)
    with NVCC_FLAGS and extra_flags; returns the compiler's messages."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{res.stderr}")
    os.replace(tmp, lib)
    return res.stdout + res.stderr


def _lib_path(name: str) -> Path:
    """The library of csrc/<name>.cu as it reads now, under NVCC_FLAGS."""
    src = _SRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


_load_locks = collections.defaultdict(threading.Lock)


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib = _lib_path(name)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        with open(lib.parent / f"{name}.lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not lib.exists():  # another process may have built it
                log = compile_so(_SRC / f"{name}.cu", lib)
                lib.with_suffix(".log").write_text(log)
    return ctypes.CDLL(str(lib))


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing or stale; load it.
    Threads and processes that ask for one source at once build it once;
    two sources build side by side."""
    with _load_locks[name]:
        return _load(name)


def build_log(name: str) -> str:
    """The compiler's messages from the build of csrc/<name>.cu's library
    (after load(name))."""
    return _lib_path(name).with_suffix(".log").read_text()


def _kernel_name(mangled: str) -> str:
    """`mont_mul_kernel<16,8>` for a mangled kernel (template) name."""
    m = re.search(r"([a-z_]+_kernel)(?:I((?:Li\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_usage(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes)], sorted,
    from the messages of nvcc -Xptxas -v."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return sorted(rows)


def count_sass(sass: str):
    """{kernel: Counter of opcodes, modifiers cut (`LDS.128` counts as
    `LDS`)} from the text of cuobjdump -sass."""
    out, ops = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            ops = out.setdefault(_kernel_name(m.group(1)),
                                 collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and ops is not None:
            ops[m.group(1)] += 1
    return out


def sass_opcodes(name: str):
    """count_sass of the library of csrc/<name>.cu (after load(name)), or
    None where there is no cuobjdump beside nvcc."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    res = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                         capture_output=True, text=True)
    return count_sass(res.stdout) if res.returncode == 0 else None
