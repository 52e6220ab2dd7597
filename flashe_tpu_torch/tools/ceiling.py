"""The card's integer and shared-memory ceilings (csrc/ceiling.cu).

`int_chain(x)` runs each element of an int32 vector through 64 dependent
steps of x ^= c_s; x += x >> 7; x ^= x << 3 (mod 2^32, the constants
CHAIN_CONSTS); `lds_chain(x)` walks four chains of 64 dependent loads
through a 4 KB table from each element.  On a CUDA tensor each is one
launch of its kernel in csrc/ceiling.cu, which the benchmark harness's
roofline mode times to measure the 32-bit integer rate and the
shared-memory load rate; on a CPU tensor each runs its plain torch
version, which the harness also holds the kernels against on a slice.
`launches` counts the kernels' launches.  The constants are bench.py's
(`np.random.RandomState(7)`, 64 draws in [1, 2^31)).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from flashe_tpu_torch.ops import _build
from flashe_tpu_torch.ops.lanes import as_u32, to_i32

__all__ = ["CHAIN_STEPS", "CHAIN_OPS", "LDS_STEPS", "LDS_CHAINS", "LDS_LOADS",
           "CHAIN_CONSTS", "THREADS", "launches", "int_chain", "lds_chain",
           "int_chain_ref", "lds_chain_ref", "per_element"]

CHAIN_STEPS = 64
CHAIN_OPS = 5 * CHAIN_STEPS  # an element's operations in the source
LDS_STEPS, LDS_CHAINS = 64, 4
LDS_LOADS = LDS_STEPS * LDS_CHAINS  # an element's shared-memory loads
THREADS = 256  # a block: the lane of element i is i % 32
TABLE_WORDS = 1024
CHAIN_CONSTS = np.random.RandomState(7).randint(1, 1 << 31, CHAIN_STEPS,
                                                dtype=np.uint32)

launches = {"int_chain": 0, "lds_chain": 0}
_count_lock = threading.Lock()
_U32 = 0xFFFFFFFF


def int_chain_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the integer chain (int32 in and out)."""
    v = as_u32(x)
    for c in CHAIN_CONSTS.tolist():
        v = v ^ c
        v = (v + (v >> 7)) & _U32
        v = (v ^ (v << 3)) & _U32
    return to_i32(v)


def _table(device) -> torch.Tensor:
    j = torch.arange(TABLE_WORDS, dtype=torch.int64, device=device)
    return (j * 2654435761 & _U32) ^ 0x5BD1E995


def lds_chain_ref(x: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Plain torch version of the load chains; x holds elements first ..
    first + len(x) - 1 of the kernel's vector (their lanes follow)."""
    tbl = _table(x.device)
    lane4 = ((torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
              + first) & 31) << 2
    u = as_u32(x)
    v = [u ^ (0x9E3779B9 * c & _U32) for c in range(LDS_CHAINS)]
    for _ in range(LDS_STEPS):
        v = [tbl[((w & 0xF80) | lane4) >> 2] for w in v]
    return to_i32(v[0] ^ v[1] ^ v[2] ^ v[3])


@functools.cache
def _lib():
    lib = _build.load("ceiling")
    lib.ceiling_int_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.ceiling_lds_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_void_p]
    for fn in (lib.ceiling_int_chain, lib.ceiling_lds_chain):
        fn.restype = ctypes.c_int
    shape = [lib.ceiling_shape(k) for k in range(5)]
    if shape != [CHAIN_STEPS, LDS_STEPS, LDS_CHAINS, THREADS, TABLE_WORDS]:
        raise RuntimeError(f"csrc/ceiling.cu's shape {shape} is not the "
                           "plain versions'")
    return lib


_CONSTS = (ctypes.c_uint32 * CHAIN_STEPS)(*CHAIN_CONSTS.tolist())


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 1-D int32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if name == "int_chain":
            rc = _lib().ceiling_int_chain(x.data_ptr(), out.data_ptr(),
                                          x.shape[0], _CONSTS, stream)
        else:
            rc = _lib().ceiling_lds_chain(x.data_ptr(), out.data_ptr(),
                                          x.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches[name] += 1
    return out


def _on_card(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return True


def per_element() -> dict:
    """{"int_chain": (integer operations, loads), "lds_chain": (...)} an
    element.  Counted in the built library's SASS where cuobjdump is at
    hand (each kernel runs one element a thread, straight-line): IMAD
    issues on the FMA pipe and the other integer opcodes on the ALU pipe,
    each at the integer rate and side by side, so the busier pipe's count
    is the one that binds.  Else the source's counts (CHAIN_OPS; a load
    and one LOP3 a load)."""
    from flashe_tpu_torch.tools.roofline import INTEGER_OPCODES

    sass = _build.sass_opcodes("ceiling")
    if sass is None:
        return {"int_chain": (CHAIN_OPS, 0),
                "lds_chain": (LDS_LOADS, LDS_LOADS)}
    out = {}
    for name, ops in sass.items():
        alu = sum(v for k, v in ops.items()
                  if k in INTEGER_OPCODES and k != "IMAD")
        out[name.split("_kernel")[0]] = (max(alu, ops["IMAD"]), ops["LDS"])
    return out


def int_chain(x: torch.Tensor) -> torch.Tensor:
    """The integer chain of every element: one launch on the card."""
    return _launch("int_chain", x) if _on_card(x, "int_chain") \
        else int_chain_ref(x)


def lds_chain(x: torch.Tensor) -> torch.Tensor:
    """The load chains of every element: one launch on the card."""
    return _launch("lds_chain", x) if _on_card(x, "lds_chain") \
        else lds_chain_ref(x)
