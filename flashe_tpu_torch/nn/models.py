"""The FEMNIST CNN as a torch module (port of flashe_tpu/nn/models.py).

Conv32-3x3/relu -> Conv64-3x3/relu -> maxpool2 -> dropout -> dense128/relu
-> dropout -> dense62: 1,206,590 parameters.  The parameters cross to and
from the JAX layout by name ("Conv_0/kernel", ...): flax keeps conv kernels
HWIO and dense kernels (in, out), torch OIHW and (out, in).  flax flattens
NHWC activations before Dense_0, so the forward permutes to NHWC before
its flatten and Dense_0's kernel needs no row permutation.  Training and
the other models of the JAX zoo are not ported yet.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashe_tpu_torch.device import resolve_device

__all__ = ["FemnistCNN"]


def _named(tree, prefix=""):
    """Nested {name: {name: array}} -> flat {"a/b": array}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_named(v, name + "/"))
        else:
            out[name] = v
    return out


class FemnistCNN(nn.Module):
    def __init__(self, num_classes: int = 62, device="cuda"):
        super().__init__()
        kw = dict(device=resolve_device(device))
        self.conv0 = nn.Conv2d(1, 32, 3, **kw)
        self.conv1 = nn.Conv2d(32, 64, 3, **kw)
        self.dense0 = nn.Linear(12 * 12 * 64, 128, **kw)
        self.dense1 = nn.Linear(128, num_classes, **kw)
        self.drop0 = nn.Dropout(0.25)
        self.drop1 = nn.Dropout(0.5)
        # flax name -> (torch parameter name, flax -> torch permutation)
        self._flax = {
            "Conv_0/kernel": ("conv0.weight", (3, 2, 0, 1)),
            "Conv_0/bias": ("conv0.bias", None),
            "Conv_1/kernel": ("conv1.weight", (3, 2, 0, 1)),
            "Conv_1/bias": ("conv1.bias", None),
            "Dense_0/kernel": ("dense0.weight", (1, 0)),
            "Dense_0/bias": ("dense0.bias", None),
            "Dense_1/kernel": ("dense1.weight", (1, 0)),
            "Dense_1/bias": ("dense1.bias", None),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # inputs in the JAX layout: (N, 28, 28, 1) or (N, 784)
        x = x.reshape(x.shape[0], 28, 28, 1).permute(0, 3, 1, 2)
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        x = self.drop0(F.max_pool2d(x, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = self.drop1(F.relu(self.dense0(x)))
        return self.dense1(x)

    def params_to_flax(self) -> dict:
        """{flax path name: tensor in the flax layout} (detached copies)."""
        params = dict(self.named_parameters())
        out = {}
        for name, (pname, perm) in self._flax.items():
            t = params[pname].detach()
            if perm is not None:
                t = t.permute(tuple(perm.index(i) for i in range(len(perm))))
            out[name] = t.clone(memory_format=torch.contiguous_format)
        return out

    @torch.no_grad()
    def params_from_flax(self, params) -> None:
        """Load a flax params tree (nested or by path name; numpy or
        torch values in the flax layout)."""
        named = _named(params)
        if set(named) != set(self._flax):
            raise KeyError(f"expected parameters {sorted(self._flax)}, got "
                           f"{sorted(named)}")
        params = dict(self.named_parameters())
        for name, (pname, perm) in self._flax.items():
            t = named[name]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t, np.float32))
            params[pname].copy_(t if perm is None else t.permute(perm))
