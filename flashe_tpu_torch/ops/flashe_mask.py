"""Fused FLASHE mask apply (port of flashe_tpu/ops/pallas_flashe.py).

`mask_apply` computes (q + stream(add_idx) - stream(minus_idx)) mod 2^m over
int32 lanes.  On a CUDA tensor it launches the hand-written kernel of
flashe_tpu_torch/csrc/flashe_mask.cu, which generates both AES-256-CTR mask
streams on chip (a T-table AES on column words, its table `aes.te0_words()`
uploaded once a device) and never writes them to device memory; a failed
build or launch raises.  On a CPU tensor it runs the plain torch version,
`mask_apply_ref`, which the tests hold against the JAX package.  `launches`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flashe_tpu_torch.ops import _build, aes
from flashe_tpu_torch.ops.lanes import lane_add, lane_sub, nlimbs_for
from flashe_tpu_torch.ops.masks import prp_lane_stream

__all__ = ["mask_apply", "mask_apply_ref", "encrypt", "decrypt", "layout",
           "launches"]

launches = 0


def mask_apply_ref(q, rk, iter_index, add_idx, minus_idx, int_bits: int,
                   base_block: int = 0) -> torch.Tensor:
    """Plain torch version of the kernel, on q's device (any int_bits;
    lanes wider than 32 bits are (count, L) limbs)."""
    count = q.shape[0]
    rk = torch.as_tensor(rk).to(q.device)
    add = prp_lane_stream(rk, iter_index, add_idx, count, int_bits, base_block)
    minus = prp_lane_stream(rk, iter_index, minus_idx, count, int_bits,
                            base_block)
    return lane_sub(lane_add(q, add, int_bits), minus, int_bits)


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
def _te0(device: torch.device) -> torch.Tensor:
    """The kernel's table on `device`, uploaded once and kept."""
    t = torch.from_numpy(aes.te0_words().view("int32")).to(device)
    torch.cuda.synchronize(device)
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


def _launch(q: torch.Tensor, rk: torch.Tensor, iter_index, add_idx, minus_idx,
            int_bits: int, base_block: int) -> torch.Tensor:
    global launches
    if nlimbs_for(int_bits) > 1:
        raise NotImplementedError(
            "the CUDA mask kernel takes int_bits <= 32; multi-limb lanes on "
            "the card are not ported yet")
    if q.dtype != torch.int32 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("q must be a contiguous 1-D int32 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if (rk.device != q.device or rk.dtype != torch.int32
            or tuple(rk.shape) != (15, 16) or not rk.is_contiguous()):
        raise ValueError("round keys must be a contiguous (15, 16) int32 "
                         f"tensor on {q.device}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _kernel()(q.data_ptr(), out.data_ptr(), q.numel(), rk.data_ptr(),
                   int(iter_index), int(add_idx), int(minus_idx), int_bits,
                   int(base_block),
                   torch.cuda.current_stream(q.device).cuda_stream,
                   _te0(q.device).data_ptr())
    if rc != 0:
        raise RuntimeError(f"flashe_mask kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def mask_apply(q: torch.Tensor, rk: torch.Tensor, iter_index, add_idx,
               minus_idx, int_bits: int, base_block: int = 0) -> torch.Tensor:
    """(q + stream(add_idx) - stream(minus_idx)) mod 2^int_bits.

    base_block offsets the AES counters and may take any value: lane i
    uses block base_block + i // (128 // int_bits).
    """
    if q.device.type == "cpu":
        return mask_apply_ref(q, rk, iter_index, add_idx, minus_idx, int_bits,
                              base_block)
    if q.device.type != "cuda":
        raise ValueError(f"mask_apply runs on cpu or cuda, not {q.device}")
    return _launch(q, rk, iter_index, add_idx, minus_idx, int_bits, base_block)


def encrypt(q, rk, iter_index, client_idx, int_bits: int, base_block: int = 0):
    """FLASHE double-mask encrypt: add stream idx, subtract stream idx + 1."""
    return mask_apply(q, rk, iter_index, client_idx, client_idx + 1, int_bits,
                      base_block)


def decrypt(agg, rk, iter_index, num_clients, int_bits: int,
            base_block: int = 0):
    """Boundary-mask decrypt of a full aggregate (add idx=n, minus idx=0)."""
    return mask_apply(agg, rk, iter_index, num_clients, 0, int_bits,
                      base_block)
