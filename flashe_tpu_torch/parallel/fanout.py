"""Batch-axis fan-out over a party's local devices (port of
flashe_tpu/parallel/fanout.py).

The reference parallelizes every HE scheme inside one silo with a
`multiprocessing.Pool` over contiguous index chunks: Paillier by element
(jzf_paillier.py:190-237), BFV by ciphertext (jzf_bfv.py:116-173).  For
batch-row work (Paillier modexp rows, BFV and CKKS ciphertext rows) the
batch axis splits into contiguous chunks, one a device, and the same
function runs on each chunk there.  Every chunk is launched before any is
waited for: the launches are asynchronous, so the devices work at once,
and the rows are independent, so no collective is needed.  The results
come back to host numpy in one gather at the end, where the call sites
take them to the host anyway (Paillier's CRT assembly, the wire).

Contrast with parallel/party.LocalLaneMesh, which splits FLASHE's lane
axis (one vector, counter-offset mask streams); here whole independent
rows fan out.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_devices, synchronize

__all__ = ["DeviceFanout"]


class DeviceFanout:
    """Contiguous batch-axis fan-out over local devices (every visible card
    by default; a device may repeat)."""

    def __init__(self, n_shards=None, devices=None):
        devices = resolve_devices(devices)
        if n_shards in (None, "all"):
            n_shards = len(devices)
        n_shards = int(n_shards)
        if n_shards > len(devices):
            raise ValueError(
                f"n_shards={n_shards} > {len(devices)} local devices")
        self.devices = devices[:max(n_shards, 1)]
        self.n_shards = max(n_shards, 1)

    def spans(self, B: int) -> List[Tuple[int, int]]:
        """Balanced contiguous [lo, hi) spans of a batch of B rows (at most
        n_shards; empty spans are dropped, so B < n_shards still works)."""
        base, rem = divmod(B, self.n_shards)
        spans, lo = [], 0
        for i in range(self.n_shards):
            size = base + (1 if i < rem else 0)
            if size:
                spans.append((lo, lo + size))
                lo += size
        return spans

    def generators(self, generator: torch.Generator) -> list:
        """One torch.Generator a shard, on the shard's device, each seeded
        by a draw from `generator` (where the JAX package splits its PRNG
        key for each shard)."""
        seeds = torch.randint(0, 2**62, (self.n_shards,), generator=generator,
                              device=generator.device).tolist()
        return [torch.Generator(device=d).manual_seed(int(s))
                for d, s in zip(self.devices, seeds)]

    def run(self, fn, *arrays):
        """fn(shard_index, *chunks) on each device over axis-0 chunks.

        Each batch tensor (or array) is sliced into contiguous spans and
        each chunk moved to its device, so that the work inside `fn` runs
        there; every shard is launched before any result is awaited.  fn
        returns a tensor or a tuple of tensors (concatenated position by
        position).  The results come back as host numpy arrays, copied
        without a wait and synchronized once, device by device, at the
        end."""
        outs, tupled = [], False
        for i, ((lo, hi), dev) in enumerate(zip(
                self.spans(arrays[0].shape[0]), self.devices)):
            chunks = [torch.as_tensor(a[lo:hi]).to(dev) for a in arrays]
            out = fn(i, *chunks)
            tupled = isinstance(out, tuple)
            outs.append(out if tupled else (out,))
        host = [tuple(t.to("cpu", non_blocking=True) for t in o)
                for o in outs]
        for dev in {t.device for o in outs for t in o}:
            if dev.type == "cuda":
                synchronize(dev)
        cols = tuple(np.concatenate([h[j].numpy() for h in host])
                     for j in range(len(host[0])))
        return cols if tupled else cols[0]
