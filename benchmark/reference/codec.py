"""The secure round's arithmetic, from the clients' float updates to the
model each client installs, without masks: the masks of a correct FLASHE
round cancel in the mod-2^m sum, so the reference adds the quantized values
themselves.

For each layer, with alpha = ALPHA_GAUS[element_bits] x the layer's std
(0.1 where that is 0) and mu its mean, both of the last global model times
the degree d (mean 0, std 1 before the first round):
    x_i = d * update_i - mu
    y_i = (clip(x_i, -alpha, alpha) + alpha) * (2^eb - 1) / (2 alpha)
a client sends q_i = floor(y_i + u), u uniform, so E[q_i] = y_i.  The sum
S = sum q_i (below 2^int_bits for the configured client count) decodes to
    d * G = (S * 2 alpha / (2^eb - 1) - n alpha) / n + mu
and G is what every client installs.  The reference takes S = sum y_i, the
expected value: the system's decode lies within one quantization step
(2 alpha / (2^eb - 1) / d) of it, since each |q_i - y_i| < 1.

The ACIQ table is the ACIQ paper's (Banner et al., NeurIPS 2019).
"""

from __future__ import annotations

import torch

__all__ = ["ALPHA_GAUS", "Layout", "layer_stats", "encode", "aggregate"]

ALPHA_GAUS = [
    None, None, 1.710635, 2.151593, 2.559136, 2.936201, 3.286914, 3.615114,
    3.924035, 4.216331, 4.494167, 4.759313, 5.013188, 5.257151, 5.491852,
    5.719160, 5.938345, 6.150141, 6.356593, 6.560495, 6.752936, 6.931921,
    7.106395, 7.350340, 7.482915, 7.691728, 7.668494, 7.583591, 7.583591,
    8.326501, 8.171210, 8.171210,
]


class Layout:
    """Leaves in sorted name order, as the wire flattens them."""

    def __init__(self, shapes: dict, device):
        self.names = sorted(shapes)
        self.shapes = [tuple(shapes[k]) for k in self.names]
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.total = sum(self.sizes)
        self.device = device
        self.seg = torch.repeat_interleave(
            torch.arange(len(self.sizes), device=device),
            torch.tensor(self.sizes, device=device))

    def spread(self, per_layer: torch.Tensor) -> torch.Tensor:
        return per_layer.to(self.device)[self.seg]

    def flatten(self, params: dict, dtype=torch.float32) -> torch.Tensor:
        return torch.cat([params[k].reshape(-1).to(dtype)
                          for k in self.names])

    def unflatten(self, flat: torch.Tensor) -> dict:
        out, at = {}, 0
        for k, shape, size in zip(self.names, self.shapes, self.sizes):
            out[k] = flat[at:at + size].reshape(shape)
            at += size
        return out


def layer_stats(layout: Layout, flat: torch.Tensor):
    """Per-layer mean and population std, in float64."""
    flat = flat.to(torch.float64)
    parts = flat.split(layout.sizes)
    mean = torch.stack([p.mean() for p in parts])
    std = torch.stack([p.std(unbiased=False) for p in parts])
    return mean, std


def encode(u: torch.Tensor, degree: float, mu: torch.Tensor,
           a: torch.Tensor, levels: float) -> torch.Tensor:
    """A client's y = (clip(d u - mu, -a, a) + a) levels / (2 a), in the
    precision of mu and a (float64 from `aggregate`)."""
    x = u.to(a.dtype) * degree - mu
    x = torch.clamp(x, -a, a) + a
    return x * (levels / 2.0) / a


def aggregate(layout: Layout, updates, degree: float, stats,
              element_bits: int):
    """The model every client installs after a round whose clients sent
    `updates` (float32 flat vectors, one a client, all of degree `degree`),
    with `stats` = (mean, std) of degree x the last global model, or None
    before the first round.  Returns (G float64, stats of degree x G, the
    quantization step of G per element)."""
    n = len(updates)
    if stats is None:
        mean = torch.zeros(len(layout.sizes), dtype=torch.float64)
        std = torch.ones(len(layout.sizes), dtype=torch.float64)
    else:
        mean, std = stats
    alpha = ALPHA_GAUS[min(element_bits, 31)] * std.to(torch.float64)
    alpha[alpha == 0] = 0.1
    a = layout.spread(alpha)
    mu = layout.spread(mean.to(torch.float64))
    levels = float((1 << element_bits) - 1)
    s = torch.zeros(layout.total, dtype=torch.float64, device=layout.device)
    for u in updates:
        s += encode(u, degree, mu, a, levels).to(torch.float64)
    scaled = (s * (2.0 * a / levels) - n * a) / n + mu
    new_stats = layer_stats(layout, scaled)
    return scaled / degree, new_stats, 2.0 * a / levels / degree
