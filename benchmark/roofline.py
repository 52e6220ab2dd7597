"""Frozen yardsticks: the published peaks of one NVIDIA H100 SXM, the least
time of the FLASHE mask kernel's launches, and the operations and bytes of
a round.  Copied, not imported, so that a change to the program cannot move
them.

Rates (NVIDIA's H100 SXM data sheet, at its 700 W limit): HBM3 3.35e12 B/s;
dense bf16 989e12 FLOP/s; 132 SMs at a maximum SM clock of 1,980 MHz, with
64 32-bit integer operations and 32 shared-memory lane loads a clock on
each SM.

The mask kernel's bound (the program's tools/roofline.py::mask_bound at
these rates): a lane of m bits takes 128 // m lanes a T-table AES-256
block; each stream costs a block for every 128 // m lanes; a block is 348
integer operations and 224 shared-memory loads; each lane adds 2 x streams
+ 2 integer operations a 32-bit limb; each lane's limbs are read once and
written once (8 bytes a limb).  Pipes issue side by side, so the bound is
the largest of the three times.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOPS_PER_S", "INT32_PER_S", "LDS_PER_S",
           "mask_bound_s", "conv2d_flops", "dense_flops", "sum_bytes",
           "codec_bytes", "train_round_flops"]

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SMS = 132
MAX_SM_HZ = 1.98e9
INT32_PER_S = 64 * SMS * MAX_SM_HZ
LDS_PER_S = 32 * SMS * MAX_SM_HZ
AES_TTABLE_INT_OPS = 348
AES_TTABLE_LOADS = 224


def mask_bound_s(count: int, m: int = 20, streams: int = 2) -> float:
    """Least seconds of one mask launch over `count` lanes of m bits with
    `streams` mask streams (dense modes: double = 2, single = 1)."""
    limbs = -(-m // 32)
    blocks = streams * -(-count // (128 // m))
    int_ops = blocks * AES_TTABLE_INT_OPS + (2 * streams + 2) * limbs * count
    loads = blocks * AES_TTABLE_LOADS
    nbytes = 8 * limbs * count
    return max(int_ops / INT32_PER_S, loads / LDS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def conv2d_flops(out_h: int, out_w: int, cin: int, cout: int, kh: int,
                 kw: int) -> int:
    """2 x multiply-adds of one sample's convolution."""
    return 2 * out_h * out_w * cout * cin * kh * kw


def dense_flops(fan_in: int, fan_out: int) -> int:
    """2 x multiply-adds of one row through a dense layer."""
    return 2 * fan_in * fan_out


def sum_bytes(lanes: int, clients: int) -> int:
    """The arbiter's mod-2^m sum: each client's int32 lanes read once, the
    aggregate written once."""
    return 4 * lanes * (clients + 1)


def codec_bytes(lanes: int, clients: int) -> int:
    """The clients' codec passes a round: each encode reads the float32
    model and writes its int32 lanes, each decode reads the int32
    aggregate and writes the float32 model."""
    return 16 * lanes * clients


def train_round_flops(forward_flops: int, train_rows: int,
                      eval_rows: int) -> int:
    """A training round's model FLOPs: a training row at three forward
    passes (forward, and the backward's two), an evaluated row at one."""
    return forward_flops * (3 * train_rows + eval_rows)
