"""The model zoo as torch modules (port of flashe_tpu/nn/models.py).

- MLP: dense/relu layers, the last one linear;
- FemnistCNN: Conv32-3x3/relu -> Conv64-3x3/relu -> maxpool2 -> dropout
  -> dense128/relu -> dropout -> dense62 (1,206,590 parameters);
- CifarResNet: conv/GroupNorm stem and three stages of two residual
  blocks, GroupNorm(8) in place of BatchNorm (175,066 parameters);
- CharLSTM: embed -> 2 x LSTM(256) -> dense(vocab) on the last step
  (817,872 parameters).

Every model keeps the flax parameter set exactly: the same names
("Conv_0/kernel", "_ResBlock_2/GroupNorm_1/scale", ...), shapes and count.
`params_to_flax` / `params_from_flax` carry the parameters across in the
flax layout (conv kernels HWIO, dense kernels (in, out)), which is what the
weights codec flattens in sorted-name order: that order and layout are the
wire contract (nn/weights.py).

Inputs come in the JAX layout (NHWC images, int token sequences).  Where
flax pads SAME at stride 2 it puts the odd pixel at the end, which
`_same_pad` reproduces (torch's padding=1 would pad both sides); flax's
GroupNorm epsilon is 1e-6 (torch's default is 1e-5); flax's
OptimizedLSTMCell has one bias a gate, on its recurrent dense, so the
cell is written out over the sequence rather than with torch.nn.LSTM's two.

Dropout draws from the model's own `generator` (set by the trainer), never
from the device's global generator, which the client threads of one
process share.  `init_params` draws the flax initializers' distributions
from a CPU torch.Generator; the bits differ from flax's threefry draws,
the distributions do not.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashe_tpu_torch.device import outside_captures, resolve_device

__all__ = ["build_model", "init_params", "FemnistCNN", "CifarResNet",
           "CharLSTM", "MLP"]

_CONV = (3, 2, 0, 1)  # flax HWIO -> torch OIHW
_DENSE = (1, 0)  # flax (in, out) -> torch (out, in)
# jax.nn.initializers.truncated_normal's correction: the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


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


def _pair(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v), int(v))


def _same_pad(x: torch.Tensor, kernel, stride, value: float = 0.0
              ) -> torch.Tensor:
    """Pad an NCHW tensor as lax's SAME padding does: out = ceil(in /
    stride), the total padding split with the odd pixel at the end.
    kernel and stride are ints or (height, width) pairs; `value` fills the
    padding (-inf for a max pool)."""
    pads = []
    for size, k, s in zip((x.shape[3], x.shape[2]), _pair(kernel)[::-1],
                          _pair(stride)[::-1]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class _FlaxModel(nn.Module):
    """A torch module whose parameters cross to and from the flax layout.

    `_flax` maps each flax path name to (torch parameter name, permutation
    from the flax layout to the torch one or None, columns or None): with
    columns (lo, hi) the flax parameter is that slice of the torch
    parameter's last axis."""

    _flax: Dict[str, tuple]

    def __init__(self, device):
        super().__init__()
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(0)
        self.drew = False  # set by each draw from `generator`

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax's Dropout: keep with probability 1 - rate, scale by its
        inverse; the identity in eval mode.  A draw sets `drew`, which
        tells the trainer that a CUDA graph of the step would repeat it."""
        if not self.training or rate == 0.0:
            return x
        self.drew = True
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def shapes_open(self) -> bool:
        """True while a parameter's shape waits for the first input."""
        return any(isinstance(p, nn.parameter.UninitializedParameter)
                   for p in self.parameters())

    def recurrent_kernels(self) -> set:
        """The flax names that flax's recurrent cells draw orthogonal."""
        return {k for k in self._flax if k.startswith("OptimizedLSTMCell")
                and "/h" in k and k.endswith("/kernel")}

    def _slot(self, tensors, name):
        pname, perm, cols = self._flax[name]
        t = tensors[pname]
        if cols is not None:
            t = t[..., cols[0]:cols[1]]
        return t, perm

    def flax_view(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        """{torch parameter name: tensor} (the parameters, or their
        gradients) -> {flax path name: copy in the flax layout}."""
        out = {}
        for name in self._flax:
            t, perm = self._slot(tensors, name)
            t = t.detach()
            if perm is not None:
                t = t.permute(tuple(perm.index(i) for i in range(len(perm))))
            out[name] = t.clone(memory_format=torch.contiguous_format)
        return out

    def params_to_flax(self) -> dict:
        """{flax path name: tensor in the flax layout} (detached copies)."""
        return self.flax_view(dict(self.named_parameters()))

    @torch.no_grad()
    def params_from_flax(self, params) -> None:
        """Load a flax params tree (nested or by path name; numpy or
        torch values in the flax layout) into the existing parameters."""
        named = _named(params)
        if set(named) != set(self._flax):
            raise KeyError(f"expected parameters {sorted(self._flax)}, got "
                           f"{sorted(named)}")
        params = dict(self.named_parameters())
        for name in self._flax:
            dst, perm = self._slot(params, name)
            t = named[name]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t, np.float32))
            dst.copy_(t if perm is None else t.permute(perm))


class MLP(_FlaxModel):
    """Dense layers of `features` widths, relu between them.  The first
    layer takes its input width from the first input it sees, as flax's
    Dense does (init_params shows it one)."""

    def __init__(self, features: Sequence[int] = (64, 10), device="cuda"):
        super().__init__(device)
        kw = dict(device=self.device)
        layers = [nn.LazyLinear(features[0], **kw)]
        layers += [nn.Linear(a, b, **kw) for a, b in zip(features[:-1],
                                                         features[1:])]
        self.dense = nn.ModuleList(layers)
        self._flax = {}
        for i in range(len(features)):
            self._flax[f"Dense_{i}/kernel"] = (f"dense.{i}.weight", _DENSE,
                                               None)
            self._flax[f"Dense_{i}/bias"] = (f"dense.{i}.bias", None, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x)


class FemnistCNN(_FlaxModel):
    """The FEMNIST CNN (cnn_* configs).  flax flattens NHWC activations
    before Dense_0, so the forward permutes to NHWC before its flatten and
    Dense_0's kernel needs no row permutation."""

    def __init__(self, num_classes: int = 62, device="cuda"):
        super().__init__(device)
        kw = dict(device=self.device)
        self.conv0 = nn.Conv2d(1, 32, 3, **kw)
        self.conv1 = nn.Conv2d(32, 64, 3, **kw)
        self.dense0 = nn.Linear(12 * 12 * 64, 128, **kw)
        self.dense1 = nn.Linear(128, num_classes, **kw)
        self._flax = {
            "Conv_0/kernel": ("conv0.weight", _CONV, None),
            "Conv_0/bias": ("conv0.bias", None, None),
            "Conv_1/kernel": ("conv1.weight", _CONV, None),
            "Conv_1/bias": ("conv1.bias", None, None),
            "Dense_0/kernel": ("dense0.weight", _DENSE, None),
            "Dense_0/bias": ("dense0.bias", None, None),
            "Dense_1/kernel": ("dense1.weight", _DENSE, None),
            "Dense_1/bias": ("dense1.bias", None, None),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # inputs in the JAX layout: (N, 28, 28, 1) or (N, 784)
        x = x.reshape(x.shape[0], 28, 28, 1).permute(0, 3, 1, 2)
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        x = self.dropout(F.max_pool2d(x, 2), 0.25)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = self.dropout(F.relu(self.dense0(x)), 0.5)
        return self.dense1(x)


def _group_norm(channels, device):
    return nn.GroupNorm(8, channels, eps=1e-6, device=device)  # flax's eps


class _ResBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int, device):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.strides = strides
        self.conv0 = nn.Conv2d(in_ch, filters, 3, stride=strides, **kw)
        self.gn0 = _group_norm(filters, device)
        self.conv1 = nn.Conv2d(filters, filters, 3, **kw)
        self.gn1 = _group_norm(filters, device)
        self.conv2 = (nn.Conv2d(in_ch, filters, 1, stride=strides, **kw)
                      if in_ch != filters or strides != 1 else None)

    def flax_names(self, flax_prefix: str, prefix: str) -> dict:
        out = {}
        convs = [("Conv_0", "conv0"), ("Conv_1", "conv1")]
        if self.conv2 is not None:
            convs.append(("Conv_2", "conv2"))
        for fname, tname in convs:
            out[f"{flax_prefix}{fname}/kernel"] = (f"{prefix}{tname}.weight",
                                                   _CONV, None)
        for fname, tname in (("GroupNorm_0", "gn0"), ("GroupNorm_1", "gn1")):
            out[f"{flax_prefix}{fname}/scale"] = (f"{prefix}{tname}.weight",
                                                  None, None)
            out[f"{flax_prefix}{fname}/bias"] = (f"{prefix}{tname}.bias",
                                                 None, None)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv0(_same_pad(x, 3, self.strides))
        y = F.relu(self.gn0(y))
        y = self.gn1(self.conv1(_same_pad(y, 3, 1)))
        if self.conv2 is not None:
            x = self.conv2(x)  # 1x1 SAME pads nothing
        return F.relu(x + y)


class CifarResNet(_FlaxModel):
    """CIFAR-style ResNet (resnet_* configs).  GroupNorm instead of
    BatchNorm: running batch statistics do not aggregate meaningfully
    under FedAvg."""

    def __init__(self, num_classes: int = 10,
                 stage_sizes: Sequence[int] = (2, 2, 2), width: int = 16,
                 device="cuda"):
        super().__init__(device)
        self.conv0 = nn.Conv2d(3, width, 3, bias=False, device=self.device)
        self.gn0 = _group_norm(width, self.device)
        blocks, ch = [], width
        for stage, n in enumerate(stage_sizes):
            filters = width * (2 ** stage)
            for b in range(n):
                strides = 2 if (b == 0 and stage > 0) else 1
                blocks.append(_ResBlock(ch, filters, strides, self.device))
                ch = filters
        self.blocks = nn.ModuleList(blocks)
        self.dense0 = nn.Linear(ch, num_classes, device=self.device)
        self._flax = {
            "Conv_0/kernel": ("conv0.weight", _CONV, None),
            "GroupNorm_0/scale": ("gn0.weight", None, None),
            "GroupNorm_0/bias": ("gn0.bias", None, None),
            "Dense_0/kernel": ("dense0.weight", _DENSE, None),
            "Dense_0/bias": ("dense0.bias", None, None),
        }
        for i, block in enumerate(self.blocks):
            self._flax.update(block.flax_names(f"_ResBlock_{i}/",
                                               f"blocks.{i}."))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.gn0(self.conv0(_same_pad(x, 3, 1))))
        for block in self.blocks:
            x = block(x)
        return self.dense0(x.mean(dim=(2, 3)))


class _LSTMCell(nn.Module):
    """flax's OptimizedLSTMCell: the gates' input kernels (no bias) and
    recurrent kernels (with bias) held concatenated in gate order i, f, g,
    o, flax layout (in, 4 x hidden)."""

    GATES = "ifgo"

    def __init__(self, in_features: int, hidden: int, device):
        super().__init__()
        self.hidden = hidden
        # torch.nn.LSTM's own default until init_params draws flax's
        bound = 1.0 / math.sqrt(hidden)
        self.wi = nn.Parameter(torch.empty(in_features, 4 * hidden,
                                           device=device).uniform_(-bound,
                                                                   bound))
        self.wh = nn.Parameter(torch.empty(hidden, 4 * hidden, device=device
                                           ).uniform_(-bound, bound))
        self.b = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def flax_names(self, flax_prefix: str, prefix: str) -> dict:
        out, h = {}, self.hidden
        for k, g in enumerate(self.GATES):
            cols = (k * h, (k + 1) * h)
            out[f"{flax_prefix}i{g}/kernel"] = (f"{prefix}wi", None, cols)
            out[f"{flax_prefix}h{g}/kernel"] = (f"{prefix}wh", None, cols)
            out[f"{flax_prefix}h{g}/bias"] = (f"{prefix}b", None, cols)
        return out

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """(N, T, in) -> (N, T, hidden), the carry starting at zero."""
        n, steps, _ = xs.shape
        zi = xs @ self.wi + self.b  # every step's input part at once
        h = xs.new_zeros(n, self.hidden)
        c = xs.new_zeros(n, self.hidden)
        out = []
        for t in range(steps):
            i, f, g, o = (zi[:, t] + h @ self.wh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class CharLSTM(_FlaxModel):
    """Shakespeare next-char model (lstm_* configs): embed -> stacked LSTM
    -> dense(vocab), predicting the next token from the last position."""

    def __init__(self, vocab: int = 80, embed: int = 8, hidden: int = 256,
                 layers: int = 2, device="cuda"):
        super().__init__(device)
        self.embed = nn.Embedding(vocab, embed, device=self.device)
        self.cells = nn.ModuleList(
            _LSTMCell(embed if i == 0 else hidden, hidden, self.device)
            for i in range(layers))
        self.dense0 = nn.Linear(hidden, vocab, device=self.device)
        self._flax = {
            "Embed_0/embedding": ("embed.weight", None, None),
            "Dense_0/kernel": ("dense0.weight", _DENSE, None),
            "Dense_0/bias": ("dense0.bias", None, None),
        }
        for i, cell in enumerate(self.cells):
            self._flax.update(cell.flax_names(f"OptimizedLSTMCell_{i}/",
                                              f"cells.{i}."))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.embed(x.long())
        for cell in self.cells:
            h = cell(h)
        return self.dense0(h[:, -1, :])


_REGISTRY: Dict[str, Callable[..., _FlaxModel]] = {
    "mlp": MLP,
    "cnn": FemnistCNN,
    "femnist_cnn": FemnistCNN,
    "resnet": CifarResNet,
    "cifar_resnet": CifarResNet,
    "lstm": CharLSTM,
    "char_lstm": CharLSTM,
}


def build_model(name: str, device="cuda", **kwargs: Any) -> _FlaxModel:
    """The model `name` on `device`; its layers draw their first values
    from the device's default generator, never beside a CUDA graph's
    capture (device.outside_captures)."""
    return outside_captures(_build_model, name, device, **kwargs)


def _build_model(name: str, device, **kwargs: Any) -> _FlaxModel:
    if name in ("keras", "nn_define"):
        # a Keras-JSON nn_define from a reference-style job conf
        # (federatedml/nn/backend/tf_keras/jzf_nn_model.py:99-109)
        from flashe_tpu_torch.nn.keras_define import KerasDefineModel

        return KerasDefineModel(kwargs["nn_define"], device=device)
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](device=device, **kwargs)


def _flax_init(name: str, shape, gen: torch.Generator,
               orthogonal: bool = False) -> torch.Tensor:
    """One draw of the flax initializer of parameter `name` (flax layout),
    on the CPU from `gen`; `orthogonal` for a recurrent kernel."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "bias":
        return torch.zeros(shape)
    if leaf == "scale":
        return torch.ones(shape)
    if leaf == "embedding":
        # variance_scaling(1, fan_in, normal, out_axis=0): std 1/sqrt(features)
        return torch.randn(shape, generator=gen) / math.sqrt(shape[-1])
    if orthogonal:  # flax's recurrent cells: orthogonal()
        q, r = torch.linalg.qr(torch.randn(shape, generator=gen))
        return q * torch.sign(torch.diagonal(r))
    # lecun_normal: truncated normal on [-2, 2] std, variance 1 / fan_in
    fan_in = int(np.prod(shape[:-1]))
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    return (z / _TRUNC_STD / math.sqrt(fan_in)).float()


@torch.no_grad()
def init_params(model: _FlaxModel, input_example=None, seed: int = 0) -> dict:
    """Draw every parameter from its flax initializer's distribution, in
    sorted flax-name order from a CPU torch.Generator seeded `seed`, and
    load them into `model`: the same model on every device for one seed.
    A model whose input width is still open (MLP, a Keras nn_define) first
    sees `input_example`, which builds its layers (a draw from the
    device's default generator, so never beside a capture).  Returns
    model.params_to_flax()."""
    return outside_captures(_init_params, model, input_example, seed)


def _init_params(model: _FlaxModel, input_example, seed: int) -> dict:
    if model.shapes_open():
        if input_example is None:
            raise ValueError(f"{type(model).__name__} needs an input example "
                             "to fix its input width")
        training = model.training
        model.eval()
        model(torch.as_tensor(input_example).to(model.device))
        model.train(training)
    gen = torch.Generator().manual_seed(seed)
    shapes = {k: tuple(v.shape) for k, v in model.params_to_flax().items()}
    recurrent = model.recurrent_kernels()
    model.params_from_flax({k: _flax_init(k, shapes[k], gen, k in recurrent)
                            for k in sorted(shapes)})
    return model.params_to_flax()
