"""The plain reference that decides a run's `correct`.

Plain PyTorch in float32 with TF32 off (or in a lower precision, where a
control asks for one).  It imports nothing of the program, of the JAX
package or of JAX, and takes nothing the program made: the benchmark hands
it the inputs it handed the program (weights, rows, seeds), and it works
out every derived value (clip thresholds, layer statistics, dropout masks,
the optimizer's moments) again.

- `femnist_cnn`, `gru_lm`: the models, one module each, found by the name
  a configuration's `reference_model` gives; each has `leaves(model_cfg)`,
  `init_scale(name, shape)`, `forward(params, x, dropout)`, `loss(logits,
  y)` and `forward_flops(model_cfg)`.
- `optim`: Adam as optax computes it.
- `codec`: the secure quantizer's arithmetic (ACIQ clip, the expected value
  of its stochastic rounding), the mod-2^m sum and the decode.
- `federated`: the rounds of the train traffic, client by client.
"""

import importlib

import torch

__all__ = ["model_module", "strict_fp32"]


def model_module(name: str):
    """The reference model module a configuration names."""
    return importlib.import_module(f"benchmark.reference.{name}")


def strict_fp32():
    """Float32 matmuls and convolutions without TF32, for the reference
    (run once the program's window has closed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
