"""The Shakespeare next-character model of the FLASHE reference's `lstm_*`
job configurations, in plain torch on flax-named parameters:

    Embedding(vocab -> embed) -> GRU(hidden, return_sequences)
    -> Dense(vocab), logits at every position

The GRU is flax's GRUCell with the carry starting at zero:
    r = sigmoid(x Wir + bir + h Whr)
    z = sigmoid(x Wiz + biz + h Whz)
    n = tanh(x Win + bin + r * (h Whn + bhn))
    h = (1 - z) n + z h
The embedding's `mask_zero` reaches the loss only: positions whose label is
the pad token 0 are left out of the mean cross-entropy.  No dropout.
"""

from __future__ import annotations

import torch

from benchmark import roofline

__all__ = ["leaves", "init_scale", "forward", "loss", "forward_flops"]


def _dims(model_cfg: dict):
    return (int(model_cfg["vocab"]), int(model_cfg["embed"]),
            int(model_cfg["hidden"]), int(model_cfg["seq_len"]))


def leaves(model_cfg: dict) -> dict:
    v, e, h, _ = _dims(model_cfg)
    out = {"embedding/embedding": (v, e), "dense/kernel": (h, v),
           "dense/bias": (v,), "gru/hn/bias": (h,)}
    for g in "rzn":
        out[f"gru/i{g}/kernel"] = (e, h)
        out[f"gru/i{g}/bias"] = (h,)
        out[f"gru/h{g}/kernel"] = (h, h)
    return out


def init_scale(name: str, shape) -> float:
    """Standard deviation of a leaf's seeded normal draw: 1/sqrt(features)
    for the embedding, lecun normal for kernels, zero biases."""
    if name.endswith("bias"):
        return 0.0
    if name.endswith("embedding"):
        return shape[-1] ** -0.5
    return shape[0] ** -0.5


def forward(p: dict, x: torch.Tensor, draw=None) -> torch.Tensor:
    """Logits (N, T, vocab) of token rows x (N, T); `draw` is unused (the
    model has no dropout)."""
    xs = p["embedding/embedding"][x.long()]
    n, steps, _ = xs.shape
    zi = {g: xs @ p[f"gru/i{g}/kernel"] + p[f"gru/i{g}/bias"] for g in "rzn"}
    h = xs.new_zeros(n, p["gru/hn/bias"].shape[0])
    out = []
    for t in range(steps):
        r = torch.sigmoid(zi["r"][:, t] + h @ p["gru/hr/kernel"])
        z = torch.sigmoid(zi["z"][:, t] + h @ p["gru/hz/kernel"])
        c = torch.tanh(zi["n"][:, t]
                       + r * (h @ p["gru/hn/kernel"] + p["gru/hn/bias"]))
        h = (1.0 - z) * c + z * h
        out.append(h)
    hs = torch.stack(out, dim=1)
    return hs @ p["dense/kernel"] + p["dense/bias"]


def loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not 0."""
    y = y.long()
    ce = -torch.log_softmax(logits, -1).gather(-1, y.unsqueeze(-1)).squeeze(-1)
    w = (y != 0).to(ce.dtype)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def forward_flops(model_cfg: dict) -> int:
    """Multiply-adds x 2 of one row's forward pass (the gates' elementwise
    work left out)."""
    v, e, h, t = _dims(model_cfg)
    return t * (roofline.dense_flops(e, 3 * h) + roofline.dense_flops(h, 3 * h)
                + roofline.dense_flops(h, v))
