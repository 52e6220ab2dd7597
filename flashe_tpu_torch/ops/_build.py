"""Build and load the port's CUDA kernels.

Each kernel is one `.cu` file under flashe_tpu_torch/csrc/ with a plain C
entry point.  At first use it is compiled with nvcc for sm_90a into a shared
library under build/flashe_tpu_torch/ at the repository root and loaded with
ctypes.  The library's file name carries the source's hash, so an edited
source is rebuilt.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "nvcc_path", "load"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing or stale; load it."""
    src = _SRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out_dir = build_dir()
    lib = out_dir / f"lib{name}_{digest}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}_{digest}.{os.getpid()}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{res.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
