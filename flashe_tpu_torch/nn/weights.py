"""Stable model <-> vector codec (port of flashe_tpu/nn/weights.py).

The codec works over an ordered mapping from each parameter's JAX path name
("Conv_0/kernel", ...) to a tensor in the JAX layout, and flattens in sorted
path order, exactly as the JAX codec walks a flax params tree.  That flat
order and layout are the wire contract: a port client's ciphertext must be
bit-identical to a JAX client's.  Per-layer scalars broadcast to elements
through `segment_ids`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device

__all__ = ["WeightsCodec"]


class WeightsCodec:
    """Flatten/unflatten a {path name: tensor} mapping in sorted-path order."""

    def __init__(self, template: Mapping[str, torch.Tensor], device="cuda"):
        self.device = resolve_device(device)
        self._template_keys = list(template)
        self.keys = sorted(template)
        self.shapes = [tuple(template[k].shape) for k in self.keys]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(int)
        self.total = int(self.offsets[-1])
        self.n_layers = len(self.keys)
        self.segment_ids = torch.repeat_interleave(
            torch.arange(self.n_layers, device=self.device),
            torch.tensor(self.sizes, device=self.device))
        self._sizes_f = torch.tensor(self.sizes, dtype=torch.float32,
                                     device=self.device)

    def flatten(self, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([torch.as_tensor(params[k]).reshape(-1).to(
            self.device, torch.float32) for k in self.keys])

    def unflatten(self, flat: torch.Tensor) -> dict:
        """-> {path name: tensor} in the template's key order (views of
        flat, in the JAX layout)."""
        parts = {k: flat[self.offsets[i]:self.offsets[i + 1]].reshape(
            self.shapes[i]) for i, k in enumerate(self.keys)}
        return {k: parts[k] for k in self._template_keys}

    def spread(self, per_layer: torch.Tensor) -> torch.Tensor:
        """(n_layers,) -> (total,) by segment broadcast."""
        return torch.index_select(torch.as_tensor(per_layer, device=self.device),
                                  0, self.segment_ids)

    def layer_mean_std(self, flat: torch.Tensor):
        """Per-layer mean and std of a flat vector -> ((L,), (L,)).

        The sums are taken a layer at a time over its contiguous slice,
        the same bits on every call and every device.  (An index_add on
        the card sums with atomics in no fixed order, so clients that
        decode one global model would derive clip thresholds that differ
        in their last bits, and their next models would differ.)  The
        order differs from jax.ops.segment_sum's, so the result agrees with
        the JAX package's to rounding, not bit for bit."""
        both = torch.stack((flat, flat * flat))
        s1, s2 = torch.stack([part.sum(dim=1) for part in
                              both.split(self.sizes, dim=1)], dim=1)
        mean = s1 / self._sizes_f
        var = torch.clamp(s2 / self._sizes_f - mean * mean, min=0.0)
        return mean, torch.sqrt(var)
