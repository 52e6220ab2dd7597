"""The least time an NVIDIA card could take for a kernel's work.

A kernel's bound is the larger of its times on each resource: the bytes it
must move (each input read once, each output written once) over the card's
memory rate, and the operations it must do on each pipe over that pipe's
peak rate.  Pipes issue side by side, so their times are not added.  Rates:
  - memory: 3.35e12 B/s, the published HBM3 rate of an H100 SXM;
  - 32-bit integer operations (IMAD, LOP3, shifts, adds): 64 a clock on
    each SM, so 64 x SMs x the maximum SM clock that
    `nvidia-smi --query-gpu=clocks.max.sm` reports;
  - shared-memory loads: 128 bytes a clock on each SM, 32 four-byte lanes.
`mask_bound` counts the mask kernel's work (a T-table AES-256 block a pipe
at a time) and `mont_imads` the Montgomery kernels'.  `Card.measured`
holds rates measured on the card in place of the published ones, so that
a bound can be stated against either.  Nothing here runs at import time,
and nothing runs without a card.
"""

from __future__ import annotations

import subprocess

import torch

from flashe_tpu_torch.ops.lanes import nlimbs_for
from flashe_tpu_torch.ops.masks import merge_size

__all__ = ["HBM_BYTES_PER_S", "INT32_PER_SM_CLOCK", "LDS_PER_SM_CLOCK",
           "MODMUL_INT_OPS", "AES_TTABLE_INT_OPS", "AES_TTABLE_LOADS",
           "INTEGER_OPCODES", "Card", "card", "bound_ms", "lane_ops",
           "mask_bound", "mont_imads", "ntt_modmuls"]

HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
LDS_PER_SM_CLOCK = 32
# one modular product of two residues below 2^31 on 32-bit lanes, by
# Shoup's method with the twiddle's w' = floor(w 2^32 / p) precomputed: the
# high word of a w', the low words of a w and of that quotient times p
# (the conditional subtract and a butterfly's add and subtract uncounted)
MODMUL_INT_OPS = 3
# one T-table AES-256 block, counted a pipe at a time with the round keys
# in registers.  Integer pipe: the first AddRoundKey (4 XOR), 13 rounds of
# 4 columns x (4 byte extracts, 2 LOP3 that fold the 4 table words and the
# round key), and the last round (16 byte extracts, 12 byte merges, 4 XOR):
# 4 + 312 + 32.  Shared-memory loads: 13 x 16 table words and 16 S-box
# bytes.  Loads bind: 224 / 32 a clock against 348 / 64.
AES_TTABLE_INT_OPS = 348
AES_TTABLE_LOADS = 224
# the SASS opcodes that issue on the integer pipe, as the mask kernel's and
# the ceiling kernel's instruction counts take them
INTEGER_OPCODES = frozenset((
    "PRMT", "LOP3", "SHF", "IADD3", "VIADD", "LEA", "SEL", "ISETP", "IMAD",
    "MOV", "IABS", "IMNMX"))


class Card:
    """Name, power limit and integer rates of CUDA device 0: the published
    rates at the maximum SM clock, or, where `measured` holds them
    ({"int32_per_s", "lds_per_s", "hbm_bytes_per_s"}), rates measured on
    the card."""

    def __init__(self, name: str, power_limit: str, max_sm_mhz: float,
                 sms: int, measured: dict | None = None):
        self.name, self.power_limit = name, power_limit
        self.max_sm_mhz, self.sms = max_sm_mhz, sms
        self.measured = measured

    @property
    def int32_per_s(self) -> float:
        if self.measured:
            return self.measured["int32_per_s"]
        return INT32_PER_SM_CLOCK * self.sms * self.max_sm_mhz * 1e6

    @property
    def lds_per_s(self) -> float:
        if self.measured:
            return self.measured["lds_per_s"]
        return LDS_PER_SM_CLOCK * self.sms * self.max_sm_mhz * 1e6

    @property
    def hbm_bytes_per_s(self) -> float:
        if self.measured:
            return self.measured["hbm_bytes_per_s"]
        return HBM_BYTES_PER_S

    def describe(self) -> str:
        return (f"{self.name}, {self.power_limit}, {self.sms} SMs, max SM "
                f"clock {self.max_sm_mhz:g} MHz: {self.int32_per_s:.4g} "
                f"int32 op/s, {self.lds_per_s:.4g} shared-memory loads/s, "
                f"{self.hbm_bytes_per_s:.4g} B/s"
                + (" (measured)" if self.measured else ""))


def card() -> Card:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit, mhz = (f.strip() for f in out.split(","))
    return Card(name, limit, float(mhz.split()[0]),
                torch.cuda.get_device_properties(0).multi_processor_count)


def bound_ms(int_ops: float, nbytes: float, c: Card, lds: float = 0):
    """(least ms, "operations" or "bytes") for int_ops 32-bit integer
    operations, lds shared-memory lane loads and nbytes of device-memory
    traffic."""
    ops_ms = max(int_ops / c.int32_per_s, lds / c.lds_per_s) * 1e3
    bytes_ms = nbytes / c.hbm_bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def lane_ops(streams: int) -> int:
    """A lane's integer operations, for each limb: an extract and an add
    or subtract for each stream, a mask and a select (6 for the double
    mask)."""
    return 2 * streams + 2


def mask_bound(count, card, m=20, streams=2, sectors=None):
    """The mask kernel's bound at `count` lanes of m bits and `streams`
    mask streams: that many T-table AES-256 blocks for every 128 // m
    lanes, lane_ops(streams) a limb of a lane.  Bytes: each lane's limbs
    read from q and written to out; or for the scatter (`sectors`, the
    32-byte sectors of the aggregate that the locations touch) the int64
    locations read once and those sectors read and written."""
    limbs = nlimbs_for(m)
    blocks = streams * -(-count // merge_size(m))
    nbytes = (8 * limbs * count if sectors is None
              else 8 * count + 2 * 32 * sectors)
    return bound_ms(
        blocks * AES_TTABLE_INT_OPS + lane_ops(streams) * limbs * count,
        nbytes, card, lds=blocks * AES_TTABLE_LOADS)


def mont_imads(rows: int, L: int, products: int = 1,
               squarings: int = 0) -> int:
    """IMADs of `products` Montgomery products on each of `rows` rows of L
    32-bit limbs, `squarings` of them squarings; two IMADs (low and high
    word) a limb product.  A product forms 2 L^2 limb products (a_i b_j and
    m n_j); a squaring forms each a_i a_j once, L (L + 1) / 2 + L^2."""
    general = products - squarings
    return rows * (general * 4 * L * L + squarings * (L * (L + 1) + 2 * L * L))


def ntt_modmuls(batch: int, k: int, N: int) -> int:
    """Modular products of a negacyclic NTT (or its inverse) of `batch`
    polynomials over k primes of degree N: N/2 butterflies in each of the
    log2 N stages, one product each, and the N products of the twist."""
    return batch * k * (N // 2 * (N.bit_length() - 1) + N)
