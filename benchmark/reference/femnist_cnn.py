"""FemnistCNN (LEAF's FEMNIST CNN as the FLASHE reference trains it), in
plain torch on flax-named parameters in the flax layout:

    Conv 32 3x3 VALID, relu -> Conv 64 3x3 VALID, relu -> maxpool 2
    -> dropout 0.25 -> flatten (NHWC order) -> Dense 128, relu
    -> dropout 0.5 -> Dense 62

Dropout keeps an element where a uniform drawn from the client's dropout
generator is below 1 - rate and scales it by 1 / (1 - rate); the uniforms
are drawn in the activation's NCHW shape, the first dropout before the
second, which is how the system under test draws them from the same seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import roofline

__all__ = ["leaves", "init_scale", "forward", "loss", "forward_flops"]


def leaves(model_cfg: dict) -> dict:
    c = int(model_cfg.get("num_classes", 62))
    return {
        "Conv_0/kernel": (3, 3, 1, 32), "Conv_0/bias": (32,),
        "Conv_1/kernel": (3, 3, 32, 64), "Conv_1/bias": (64,),
        "Dense_0/kernel": (12 * 12 * 64, 128), "Dense_0/bias": (128,),
        "Dense_1/kernel": (128, c), "Dense_1/bias": (c,),
    }


def init_scale(name: str, shape) -> float:
    """Standard deviation of a leaf's seeded normal draw: lecun normal for
    kernels (fan in = all axes but the last), zero biases."""
    if name.endswith("bias"):
        return 0.0
    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    return fan_in ** -0.5


def _dropout(x, rate, draw):
    if draw is None:
        return x
    keep = draw(x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def forward(p: dict, x: torch.Tensor, draw=None) -> torch.Tensor:
    """Logits of images x (N, 28, 28, 1) or (N, 784); `draw(shape)` gives
    the dropout uniforms in training, None in evaluation."""
    x = x.reshape(x.shape[0], 28, 28, 1).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, p["Conv_0/kernel"].permute(3, 2, 0, 1),
                        p["Conv_0/bias"]))
    x = F.relu(F.conv2d(x, p["Conv_1/kernel"].permute(3, 2, 0, 1),
                        p["Conv_1/bias"]))
    x = _dropout(F.max_pool2d(x, 2), 0.25, draw)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = _dropout(F.relu(x @ p["Dense_0/kernel"] + p["Dense_0/bias"]), 0.5,
                 draw)
    return x @ p["Dense_1/kernel"] + p["Dense_1/bias"]


def loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    ce = -torch.log_softmax(logits, -1).gather(
        -1, y.long().unsqueeze(-1)).squeeze(-1)
    return ce.mean()


def forward_flops(model_cfg: dict) -> int:
    """Multiply-adds x 2 of one sample's forward pass."""
    c = int(model_cfg.get("num_classes", 62))
    return (roofline.conv2d_flops(26, 26, 1, 32, 3, 3)
            + roofline.conv2d_flops(24, 24, 32, 64, 3, 3)
            + roofline.dense_flops(12 * 12 * 64, 128)
            + roofline.dense_flops(128, c))
