"""Wire payloads for model uploads and downloads (port of
flashe_tpu/protocol/payload.py).

Replaces JZFTransferableWeights (reference jzf_weights.py:140-293): a
flattened model travels as one lane vector plus metadata (degree, idx_list,
element count).  Lanes are what the round computes: int32 tensors that hold
uint32 bit patterns (FLASHE and quantized plain lanes; (n, L) limbs above
32 bits), float32 tensors (plain, unquantized) or object arrays of python
ints (Paillier ciphertexts, which pass through untouched).

- In memory the payload is passed by reference, so tensors stay on their
  card, as the JAX package keeps its arrays on device.
- `pack()` moves lanes to the host as uint32 numpy and bit-packs them into
  the reference's byte layout (ops/pack.py), for transports that
  serialize; `unpack()` gives host uint32 numpy lanes back, which the
  receiving role moves to its own device.
- A payload that is pickled (the TCP transport) pickles its lanes as host
  numpy, packed or not: a CUDA tensor in a pickle would tie the receiver to
  the sender's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from flashe_tpu_torch.ops import pack as packops

__all__ = ["ModelPayload", "partition_lanes", "merge_lane_parts",
           "host_lanes"]


def host_lanes(lanes):
    """Lanes as host numpy: int32 tensors as uint32 bit patterns, float
    tensors as they are; numpy (object ints included) passes through."""
    if not isinstance(lanes, torch.Tensor):
        return np.asarray(lanes)
    arr = lanes.detach().cpu().numpy()
    return arr.view(np.uint32) if arr.dtype == np.int32 else arr


@dataclasses.dataclass
class ModelPayload:
    lanes: Any  # int32 lanes/limbs, float32 (plain), object ints, or None
    n_elements: int
    int_bits: Optional[int]  # None => unquantized float payload
    degree: Optional[float] = None
    idx_list: Optional[list] = None
    shape_list: Optional[list] = None  # partition bookkeeping
    packed: Optional[bytes] = None
    packed_n_lanes: Optional[int] = None

    def __getstate__(self):
        state = dict(self.__dict__)
        if state["lanes"] is not None:
            state["lanes"] = host_lanes(state["lanes"])
        return state

    def pack(self) -> "ModelPayload":
        """Serialize lanes to the reference bit-packed wire bytes."""
        if self.int_bits is None or self.packed is not None:
            return self
        lanes = host_lanes(self.lanes)
        data = packops.pack_lanes(lanes, self.int_bits)
        return dataclasses.replace(
            self, lanes=None, packed=data, packed_n_lanes=int(lanes.shape[0])
        )

    def unpack(self) -> "ModelPayload":
        if self.packed is None:
            return self
        lanes = packops.unpack_lanes(self.packed, self.packed_n_lanes,
                                     self.int_bits)
        return dataclasses.replace(self, lanes=lanes, packed=None)

    @property
    def n_lanes(self) -> int:
        if self.lanes is not None:
            return int(self.lanes.shape[0])
        return self.packed_n_lanes

    def wire_bytes(self) -> int:
        if self.packed is not None:
            return len(self.packed)
        if isinstance(self.lanes, np.ndarray) and self.lanes.dtype == object:
            # big-int ciphertexts (Paillier)
            return int(sum((int(v).bit_length() + 7) // 8
                           for v in self.lanes.ravel()))
        if self.int_bits is None:
            return int(host_lanes(self.lanes).nbytes)
        return packops.packed_nbytes(self.n_lanes, self.int_bits)


def _split(lanes, num_partitions: int) -> list:
    """np.array_split's parts: the first n % k parts one lane longer."""
    if isinstance(lanes, torch.Tensor):
        return list(torch.tensor_split(lanes, num_partitions, dim=0))
    return np.array_split(np.asarray(lanes), num_partitions, axis=0)


def partition_lanes(payload: ModelPayload,
                    num_partitions: int) -> List[ModelPayload]:
    """Split a payload into chunks for flow-controlled transfer
    (reference jzf_aggregator.py:72-90)."""
    parts = _split(payload.lanes, num_partitions)
    out = []
    for i, p in enumerate(parts):
        out.append(
            ModelPayload(
                lanes=p,
                n_elements=payload.n_elements if i == 0 else 0,
                int_bits=payload.int_bits,
                degree=payload.degree if i == 0 else None,
                idx_list=payload.idx_list if i == 0 else None,
                shape_list=[len(q) for q in parts] if i == 0 else None,
            )
        )
    return out


def merge_lane_parts(parts: List[ModelPayload]) -> ModelPayload:
    """Inverse of partition_lanes (reference merge_at_*
    jzf_aggregator.py:93-132).  Parts that are all tensors are joined on
    their device; otherwise every part is joined on the host."""
    lanes = [p.unpack().lanes for p in parts]
    if all(isinstance(x, torch.Tensor) for x in lanes):
        merged = torch.cat(lanes, dim=0)
    else:
        merged = np.concatenate([host_lanes(x) for x in lanes], axis=0)
    head = parts[0]
    return ModelPayload(
        lanes=merged,
        n_elements=head.n_elements,
        int_bits=head.int_bits,
        degree=head.degree,
        idx_list=head.idx_list,
    )
