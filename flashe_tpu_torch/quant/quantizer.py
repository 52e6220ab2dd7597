"""Role-split quantizer, secure path (port of flashe_tpu/quant/quantizer.py).

Each client derives per-layer clip thresholds alpha by ACIQ from the running
std of the previous global model, normalizes by running layer means,
quantizes with stochastic rounding and corrects alpha by the number of
summed clients on the way back.  The uniforms of the stochastic rounding come
from the client's own torch.Generator, seeded from the client index, unless
the caller passes them.  With batch=True the quantized values are packed
into int_bits-bit lanes (ops/quantize.py::batch_lanes) on the way out and
unpacked on the way back.  A sparse upload normalizes and quantizes its
compacted top-s% values with the layer scalars gathered at their
locations (`normalize_gather`, `quantize_gather`); the non-secure path's
per-layer min and max are `local_min_max`.
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import quantize as qops
from flashe_tpu_torch.ops.lanes import as_u32
from flashe_tpu_torch.quant.aciq import ACIQ
from flashe_tpu_torch.runtime.tracking import count, span

__all__ = ["QuantizingClient", "QuantizingArbiter", "quantized_zero"]


def _quantize_flat(x: torch.Tensor, alpha_vec: torch.Tensor,
                   element_bits: int, u: torch.Tensor) -> torch.Tensor:
    """The JAX package's op order, so that the same uniforms give the same
    q: clip + a, then * ((2^eb - 1) / 2), then / a, then floor(. + u)."""
    a = alpha_vec
    x = torch.clamp(x, -a, a) + a
    x = x * float(np.float32((1 << element_bits) - 1) / np.float32(2.0)) / a
    return torch.floor(x + u).to(torch.int32)


def _unquantize_flat(q: torch.Tensor, alpha_vec: torch.Tensor,
                     element_bits: int, num_clients: int) -> torch.Tensor:
    a = alpha_vec * num_clients
    scale = (2.0 * a) / (float(np.float32((1 << element_bits) - 1))
                         * num_clients)
    return as_u32(q).to(torch.float32) * scale - a


def quantized_zero(element_bits: int, u: float) -> int:
    """Quantized 0.0, alpha-independent: floor((2^eb - 1)/2 + u)."""
    return int(np.floor(((1 << element_bits) - 1) / 2.0 + u))


class _QuantizingBase:
    def __init__(self, int_bits, batch, element_bits, secure):
        self.int_bits = int_bits
        self.batch = batch
        self.element_bits = element_bits
        self.secure = secure
        self.num_clients = None
        self.iter = 0

    def set_iter(self, it: int):
        self.iter = it

    def set_num_clients(self, n: int):
        self.num_clients = n

    @property
    def factor(self) -> int:
        return int(np.ceil(np.log2(self.num_clients)))


class QuantizingClient(_QuantizingBase):
    def __init__(self, int_bits, batch, element_bits, padding, secure,
                 seed: int = 0, device="cuda"):
        super().__init__(int_bits, batch, element_bits, secure)
        self.padding = padding
        self.device = resolve_device(device)
        self.aciq = ACIQ(element_bits)
        self.codec: WeightsCodec | None = None
        self.past_mean = None  # (L,) np.float32 running layer means
        self.past_std = None  # (L,) running layer stds
        self.alpha = None  # (L,) alphas used this round
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def set_codec(self, codec: WeightsCodec):
        """First-round layer bookkeeping: mean 0, std 1 priors."""
        self.codec = codec
        self.past_mean = np.zeros(codec.n_layers, np.float32)
        self.past_std = np.ones(codec.n_layers, np.float32)

    def _spread(self, per_layer) -> torch.Tensor:
        # a copy from the host waits for the card
        with span("host sync", cpu=True):
            count("host_syncs")
            per_layer = torch.as_tensor(per_layer, device=self.device)
        return self.codec.spread(per_layer)

    def compute_alphas(self) -> np.ndarray:
        alphas = np.array(
            [self.aciq.get_alpha_gaus_direct(s) for s in self.past_std],
            np.float32)
        # a constant layer (sigma == 0) still needs a clip range
        alphas[alphas == 0] = 0.1
        return alphas

    def quantize(self, flat: torch.Tensor, alpha_override=None,
                 uniforms: torch.Tensor | None = None) -> torch.Tensor:
        """flat f32 -> int32 quantized values in [0, 2^eb - 1], or with
        batch=True their int_bits-bit lanes."""
        self.alpha = (self.compute_alphas() if alpha_override is None
                      else alpha_override)
        if uniforms is None:
            uniforms = torch.rand(flat.shape, generator=self.generator,
                                  dtype=torch.float32, device=self.device)
        q = _quantize_flat(flat, self._spread(self.alpha), self.element_bits,
                           uniforms)
        if self.batch:
            q = qops.batch_lanes(q, self.int_bits, self.element_bits,
                                 self.factor)
        return q

    def unquantize(self, q: torch.Tensor, n_elements: int | None = None,
                   n_clients: int | None = None) -> torch.Tensor:
        """Summed quantized values -> flat f32.  n_clients overrides the
        registered count after a dropout: the offset correction must match
        the number of summands in the aggregate."""
        n = self.codec.total if n_elements is None else n_elements
        if self.batch:
            q = qops.unbatch_lanes(q, n, self.int_bits, self.element_bits,
                                   self.factor)
        return _unquantize_flat(q[:n], self._spread(self.alpha)[:n],
                                self.element_bits,
                                n_clients or self.num_clients)

    def normalize(self, flat: torch.Tensor) -> torch.Tensor:
        """Subtract the running layer means."""
        return flat - self._spread(self.past_mean)

    def unnormalize(self, flat: torch.Tensor) -> torch.Tensor:
        """Add the means back and refresh the running statistics from the
        new global model."""
        flat = flat + self._spread(self.past_mean)
        mean, std = self.codec.layer_mean_std(flat)
        with span("host sync", cpu=True):
            count("host_syncs", 2)
            self.past_mean = mean.cpu().numpy()
            self.past_std = std.cpu().numpy()
        return flat

    def quantized_zero(self, u: float | None = None) -> int:
        """Quantized 0.0, the dense filler of a sparse upload; u is the
        uniform of its rounding (drawn from the generator when None)."""
        if u is None:
            u = float(torch.rand((), generator=self.generator,
                                 device=self.device))
        return quantized_zero(self.element_bits, u)

    # -- sparse (compacted) variants: per-element gather of layer scalars --

    def _gather(self, per_layer, locations: torch.Tensor) -> torch.Tensor:
        seg = self.codec.segment_ids[locations.to(self.device)]
        return torch.as_tensor(per_layer, device=self.device)[seg]

    def normalize_gather(self, values: torch.Tensor,
                         locations: torch.Tensor) -> torch.Tensor:
        """Subtract the running mean of each value's layer."""
        return values - self._gather(self.past_mean, locations)

    def quantize_gather(self, values: torch.Tensor, locations: torch.Tensor,
                        uniforms: torch.Tensor | None = None) -> torch.Tensor:
        """Quantize a compacted top-s% vector with per-position alphas."""
        self.alpha = self.compute_alphas()
        if uniforms is None:
            uniforms = torch.rand(values.shape, generator=self.generator,
                                  dtype=torch.float32, device=self.device)
        return _quantize_flat(values, self._gather(self.alpha, locations),
                              self.element_bits, uniforms)

    def local_min_max(self, flat: torch.Tensor):
        """Per-layer min and max of flat, for the arbiter-assisted clipping
        of the non-secure path: ((L,), (L,)) numpy arrays."""
        ids, n = self.codec.segment_ids, self.codec.n_layers
        inf = torch.full((n,), float("inf"), dtype=flat.dtype,
                         device=flat.device)
        mins = inf.scatter_reduce(0, ids, flat, "amin")
        maxs = (-inf).scatter_reduce(0, ids, flat, "amax")
        return mins.cpu().numpy(), maxs.cpu().numpy()


class QuantizingArbiter(_QuantizingBase):
    """Arbiter-side helper: holds num_clients; in the non-secure mode it
    aggregates per-layer min/max into ACIQ alphas."""

    def __init__(self, int_bits, batch, element_bits, secure):
        super().__init__(int_bits, batch, element_bits, secure)
        self.aciq = ACIQ(element_bits)
        self.layer_sizes = None

    def set_layer_sizes(self, sizes):
        self.layer_sizes = list(sizes)

    def help_quantize(self, min_lists, max_lists):
        """min/max_lists: per-client (L,) arrays -> broadcast alphas."""
        if self.secure:
            return None
        mins = np.min(np.stack(min_lists), axis=0)
        maxs = np.max(np.stack(max_lists), axis=0)
        return np.array(
            [self.aciq.get_alpha_gaus(mins[i], maxs[i], size)
             for i, size in enumerate(self.layer_sizes)],
            np.float32)
