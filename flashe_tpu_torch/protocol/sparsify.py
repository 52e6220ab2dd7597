"""Layer-wise top-s% sparsification with residual memory (port of
flashe_tpu/protocol/sparsify.py).

Per layer, select the max(1, floor(s * size)) largest-|delta| positions;
the residual memory is added to the values sent but does not steer the
selection, as in the JAX package and the reference.  The unselected
delta + residual is carried to the next round.  The selection runs on the
codec's device (a top-k per layer, each layer's set sorted); the locations
go on the wire bit-packed, which is host work.

The JAX package selects with numpy's argsort, which is not stable: the
selected set is the same wherever |delta| has no tie at a layer's
threshold, and where it has one the two may keep other positions of equal
|delta|.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import pack as packops

__all__ = ["Sparsifier", "SparsifyResult", "encode_locations",
           "decode_locations"]


def encode_locations(locations, total: int) -> dict:
    """Bit-pack location indices (a tensor or an array) for the wire."""
    if isinstance(locations, torch.Tensor):
        locations = locations.cpu().numpy()
    bits = int(total).bit_length()
    return {
        "encoded_masked_locations": packops.pack_lanes(
            np.asarray(locations).astype(np.uint32), bits),
        "bits": bits,
        "l": int(len(locations)),
        "total": int(total),
    }


def decode_locations(obj: dict) -> np.ndarray:
    """The int64 locations of an encode_locations dict, on the host."""
    return packops.unpack_lanes(obj["encoded_masked_locations"], obj["l"],
                                obj["bits"]).astype(np.int64)


@dataclasses.dataclass
class SparsifyResult:
    values: torch.Tensor  # compacted delta + residual at the locations
    locations: torch.Tensor  # int64 global flat indices, sorted
    total: int


class Sparsifier:
    """One client's top-s% selection and residual memory, on the codec's
    device."""

    def __init__(self, codec: WeightsCodec, sparsity: float):
        self.codec = codec
        self.sparsity = sparsity
        self.residual: torch.Tensor | None = None

    def counts(self):
        """Positions selected in each layer: max(1, floor(s * size))."""
        c = self.codec
        return [max(1, int(np.floor(self.sparsity * (c.offsets[k + 1]
                                                     - c.offsets[k]))))
                for k in range(c.n_layers)]

    def sparsify(self, flat_delta: torch.Tensor) -> SparsifyResult:
        c = self.codec
        delta = flat_delta.to(c.device, torch.float32)
        if self.residual is None:
            self.residual = torch.zeros(c.total, dtype=torch.float32,
                                        device=c.device)
        mag = delta.abs()
        locations = []
        for k, count in enumerate(self.counts()):
            b, e = int(c.offsets[k]), int(c.offsets[k + 1])
            sel = torch.topk(mag[b:e], count, sorted=False).indices
            locations.append(torch.sort(sel).values + b)
        locations = torch.cat(locations)

        carried = delta + self.residual
        values = carried[locations]
        carried[locations] = 0.0
        self.residual = carried
        return SparsifyResult(values=values, locations=locations,
                              total=c.total)
