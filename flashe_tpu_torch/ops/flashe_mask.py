"""Fused FLASHE mask apply (port of flashe_tpu/ops/pallas_flashe.py).

`mask_apply` computes (q + stream(add_idx) - stream(minus_idx)) mod 2^m over
lanes, either stream absent where its index is None: the double mask takes
both, the single mask's encrypt only the add stream and its decrypt only
the minus stream.  Lanes of m <= 32 bits are an int32 vector; wider lanes
(m <= 128) are (count, L) int32 limb rows, little-endian.  `mask_scatter`
is the sparse decrypt: it applies the same update in place to a dense
aggregate at a client's locations, with the client's compact stream.

On a CUDA tensor each call is one launch of the hand-written kernel of
flashe_tpu_torch/csrc/flashe_mask.cu, which generates the AES-256-CTR mask
streams on chip (a T-table AES on column words, its table
`aes.te0_words()` uploaded once a device) and never writes them to device
memory; a failed build or launch raises.  On a CPU tensor it runs the plain
torch version (`mask_apply_ref`, `mask_scatter_ref`), which the tests hold
against the JAX package.  `launches` counts the kernel's launches and
`mode_launches` the launches of each mode: "double" (both streams, m <=
32), "single" (one stream, m <= 32), "limbs" (m > 32) and "scatter".  The
counts are bumped under a lock, since the roles of a federated round
launch from threads of one process, and each launch runs with its tensor's
device made current, on that device's current stream.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from flashe_tpu_torch.device import synchronize
from flashe_tpu_torch.ops import _build, aes
from flashe_tpu_torch.ops.lanes import lane_add, lane_sub, nlimbs_for
from flashe_tpu_torch.ops.masks import prp_lane_stream

__all__ = ["mask_apply", "mask_apply_ref", "mask_scatter", "mask_scatter_ref",
           "encrypt", "decrypt", "layout", "launches", "mode_launches",
           "MODES"]

MODES = ("double", "single", "limbs", "scatter")
launches = 0
mode_launches = dict.fromkeys(MODES, 0)
_count_lock = threading.Lock()
_te0_lock = threading.Lock()


def _check_streams(add_idx, minus_idx):
    if add_idx is None and minus_idx is None:
        raise ValueError("a mask apply takes the add stream, the minus "
                         "stream or both")


def mask_apply_ref(q, rk, iter_index, add_idx, minus_idx, int_bits: int,
                   base_block: int = 0) -> torch.Tensor:
    """Plain torch version of the kernel, on q's device (any int_bits;
    lanes wider than 32 bits are (count, L) limbs).  A stream whose index
    is None is left out."""
    _check_streams(add_idx, minus_idx)
    count = q.shape[0]
    rk = torch.as_tensor(rk).to(q.device)
    out = q
    if add_idx is not None:
        out = lane_add(out, prp_lane_stream(rk, iter_index, add_idx, count,
                                            int_bits, base_block), int_bits)
    if minus_idx is not None:
        out = lane_sub(out, prp_lane_stream(rk, iter_index, minus_idx, count,
                                            int_bits, base_block), int_bits)
    return out


def mask_scatter_ref(out, loc, rk, iter_index, add_idx, minus_idx,
                     int_bits: int, base_block: int = 0) -> torch.Tensor:
    """Plain torch version of the scatter: out[loc[k]] = (out[loc[k]] +
    stream(add_idx)[k] - stream(minus_idx)[k]) mod 2^m, in place, with the
    streams' lanes 0 .. len(loc) - 1 from counter block base_block.
    Returns out."""
    if loc.shape[0] == 0:
        return out
    out[loc] = mask_apply_ref(out[loc], rk, iter_index, add_idx, minus_idx,
                              int_bits, base_block)
    return out


@functools.cache
def _kernel():
    fn = _build.load("flashe_mask").flashe_mask_apply
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _modes_kernel():
    fn = _build.load("flashe_mask").flashe_mask_apply_modes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _te0(device: torch.device) -> torch.Tensor:
    """The kernel's table on `device`, uploaded once and kept.  One thread
    uploads it: two first calls at once each made a table, and the one the
    cache let go was freed while its kernel was still to read it."""
    with _te0_lock:
        return _te0_upload(device)


@functools.cache
def _te0_upload(device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(aes.te0_words().view("int32")).to(device)
    synchronize(device)
    return t


def layout():
    """(counter blocks a warp makes at a time, counter blocks one pass of
    the kernel's resident grid covers on the current device), as the built
    library reports them: times 128 // int_bits, the lane counts at which
    the kernel's work changes shape."""
    lib = _build.load("flashe_mask")
    lib.flashe_mask_pass_blocks.restype = ctypes.c_int64
    span, one_pass = (lib.flashe_mask_span_blocks(),
                      lib.flashe_mask_pass_blocks())
    if one_pass <= 0:
        raise RuntimeError("the flashe_mask kernel cannot be resident: CUDA "
                           f"error {-one_pass}")
    return span, one_pass


def _check_keys(rk: torch.Tensor, device: torch.device):
    if (rk.device != device or rk.dtype != torch.int32
            or tuple(rk.shape) != (15, 16) or not rk.is_contiguous()):
        raise ValueError("round keys must be a contiguous (15, 16) int32 "
                         f"tensor on {device}")


def _count(mode: str):
    global launches
    with _count_lock:
        launches += 1
        mode_launches[mode] += 1


def _launch(q: torch.Tensor, rk: torch.Tensor, iter_index, add_idx, minus_idx,
            int_bits: int, base_block: int) -> torch.Tensor:
    nl = nlimbs_for(int_bits)
    shape = (q.shape[0],) if nl == 1 else (q.shape[0], nl)
    if (q.dtype != torch.int32 or tuple(q.shape) != shape
            or not q.is_contiguous() or not 1 <= int_bits <= 128):
        raise ValueError(f"q must be contiguous int32 lanes of shape (count,)"
                         f" at int_bits <= 32 or (count, L) limbs up to 128 "
                         f"bits, got {q.dtype} {tuple(q.shape)} at "
                         f"int_bits={int_bits}")
    _check_keys(rk, q.device)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        te0 = _te0(q.device)
        if nl == 1 and add_idx is not None and minus_idx is not None:
            rc, mode = _kernel()(q.data_ptr(), out.data_ptr(), q.shape[0],
                                 rk.data_ptr(), int(iter_index), int(add_idx),
                                 int(minus_idx), int_bits, int(base_block),
                                 stream, te0.data_ptr()), "double"
        else:
            streams = (add_idx is not None) | (minus_idx is not None) << 1
            rc = _modes_kernel()(q.data_ptr(), out.data_ptr(), q.shape[0],
                                 rk.data_ptr(), int(iter_index),
                                 int(add_idx or 0), int(minus_idx or 0),
                                 streams, int_bits, int(base_block), None, 0,
                                 stream, te0.data_ptr())
            mode = "single" if nl == 1 else "limbs"
    if rc != 0:
        raise RuntimeError(f"flashe_mask kernel launch failed: CUDA error {rc}")
    _count(mode)
    return out


def _device_ok(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return False


def mask_apply(q: torch.Tensor, rk: torch.Tensor, iter_index, add_idx,
               minus_idx, int_bits: int, base_block: int = 0) -> torch.Tensor:
    """(q + stream(add_idx) - stream(minus_idx)) mod 2^int_bits; a stream
    whose index is None is left out, and at least one is present.

    base_block offsets the AES counters and may take any value: lane i
    uses block base_block + i // (128 // int_bits).
    """
    _check_streams(add_idx, minus_idx)
    if _device_ok(q, "mask_apply"):
        return mask_apply_ref(q, rk, iter_index, add_idx, minus_idx, int_bits,
                              base_block)
    return _launch(q, rk, iter_index, add_idx, minus_idx, int_bits, base_block)


def mask_scatter(out: torch.Tensor, loc: torch.Tensor, rk: torch.Tensor,
                 iter_index, add_idx, minus_idx, int_bits: int,
                 base_block: int = 0) -> torch.Tensor:
    """The sparse decrypt's update of a dense aggregate, in place:
    out[loc[k]] = (out[loc[k]] + stream(add_idx)[k] - stream(minus_idx)[k])
    mod 2^int_bits for k < len(loc), the streams counted from block
    base_block.  int_bits <= 32; the minus stream is present, the add
    stream may be None.  loc is an int64 vector of distinct positions below
    len(out): the caller checks them (the kernel skips, and does not
    report, a position outside out).  Returns out."""
    if minus_idx is None or nlimbs_for(int_bits) != 1:
        raise ValueError("the scatter subtracts a client's stream at "
                         "int_bits <= 32")
    if _device_ok(out, "mask_scatter"):
        return mask_scatter_ref(out, loc, rk, iter_index, add_idx, minus_idx,
                                int_bits, base_block)
    if (out.dtype != torch.int32 or out.dim() != 1 or not out.is_contiguous()
            or loc.dtype != torch.int64 or loc.dim() != 1
            or not loc.is_contiguous() or loc.device != out.device):
        raise ValueError("the scatter takes a contiguous 1-D int32 aggregate "
                         "and a contiguous 1-D int64 location vector on its "
                         f"device, got {out.dtype} {tuple(out.shape)} and "
                         f"{loc.dtype} {tuple(loc.shape)} on {loc.device}")
    _check_keys(rk, out.device)
    if loc.shape[0] == 0:
        return out
    streams = 2 | (add_idx is not None)
    with torch.cuda.device(out.device):
        rc = _modes_kernel()(
            None, out.data_ptr(), loc.shape[0], rk.data_ptr(),
            int(iter_index), int(add_idx or 0), int(minus_idx), streams,
            int_bits, int(base_block), loc.data_ptr(), out.shape[0],
            torch.cuda.current_stream(out.device).cuda_stream,
            _te0(out.device).data_ptr())
    if rc != 0:
        raise RuntimeError(f"flashe_mask scatter launch failed: CUDA error "
                           f"{rc}")
    _count("scatter")
    return out


def encrypt(q, rk, iter_index, client_idx, int_bits: int, base_block: int = 0):
    """FLASHE double-mask encrypt: add stream idx, subtract stream idx + 1."""
    return mask_apply(q, rk, iter_index, client_idx, client_idx + 1, int_bits,
                      base_block)


def decrypt(agg, rk, iter_index, num_clients, int_bits: int,
            base_block: int = 0):
    """Boundary-mask decrypt of a full aggregate (add idx=n, minus idx=0)."""
    return mask_apply(agg, rk, iter_index, num_clients, 0, int_bits,
                      base_block)
