"""Keras `nn_define` JSON -> torch model interpreter (port of
flashe_tpu/nn/keras_define.py).

The reference builds its training model from the Keras-serialized JSON
embedded in every job conf (`build_keras` from nn_define,
federatedml/nn/backend/tf_keras/jzf_nn_model.py:99-109; the configs live
at examples/configs/*/train_job_conf.json `algorithm_parameters.
homo_nn_0.nn_define`).  This module interprets the same JSON as a torch
module whose parameters are the JAX package's KerasDefineModel's, name for
name and shape for shape, so a reference user's job confs work unchanged
and `params_from_flax` carries JAX weights across:

- Sequential layer stacks (the CNN and LSTM/GRU workloads),
- nested functional `Model` graphs (the ResNet workload: inbound_nodes
  wiring with Add merges),
- layers: InputLayer, Reshape, Conv2D, MaxPooling2D, AveragePooling2D,
  Dropout, Flatten, Dense, Activation, Add, Embedding, GRU, LSTM,
  BatchNormalization.

Parameter names are the flax ones: a layer's config name, else flax's
automatic name (Dense_0, Conv_0, GroupNorm_0, Embed_0, GRUCell_0,
OptimizedLSTMCell_0, _Graph_0 for an unnamed Model, counted a class at a
time within each Model), under its Model's name; an RNN cell's parameters
sit directly under the layer's name.

The parameters' shapes follow the first input, as flax's do: the model
has none until its first call (`init_params(model, example)` makes that
call), and every later call must bring the same feature widths.

Between layers, activations are held in the JAX layout (NHWC, features
last) or channels first where a convolution, pooling or normalization has
just run; a layer that reads the features last (Flatten, Reshape, Dense,
the RNNs) gets them in NHWC order, so Flatten feeds the next Dense's rows
in flax's order.  SAME padding pads as lax does, the odd pixel at the end,
explicitly before the strided convolution or the pooling: -inf for max
pooling, zeros for average pooling, which divides by the window's size as
flax's avg_pool does (count_include_pad).

The JAX file's documented divergences from Keras, kept for parity:
- BatchNormalization maps to GroupNorm (the largest of 8, 4, 2, 1 groups
  that divides the channels, the layer's epsilon, default 1e-3): running
  batch statistics do not aggregate under FedAvg.
- A trailing `softmax` (or `linear`) activation is the identity: the
  trainer takes logits into its softmax cross-entropy, and predict()
  applies softmax.
- A GRU layer applies its `activation` once more to the cell's outputs
  (Keras applies it inside the cell only), as the JAX interpreter does.
- Keras regularizers and initializer seeds are ignored; init_params draws
  flax's initializers' distributions.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flashe_tpu_torch.nn.models import (
    _CONV, _DENSE, _FlaxModel, _LSTMCell, _pair, _same_pad,
)

__all__ = ["KerasDefineModel", "from_nn_define", "count_params_define"]

# jax.nn's functions of these names, as flax exports them
_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "celu": F.celu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": F.softplus,
    "silu": F.silu,
    "swish": F.silu,
    "leaky_relu": F.leaky_relu,
    "relu6": F.relu6,
    "hard_sigmoid": F.hardsigmoid,
    "hard_tanh": F.hardtanh,
    "log_sigmoid": F.logsigmoid,
}

_FLAX_CLASS = {"Dense": "Dense", "Conv2D": "Conv",
               "BatchNormalization": "GroupNorm", "Embedding": "Embed",
               "GRU": "GRUCell", "LSTM": "OptimizedLSTMCell",
               "Model": "_Graph"}


def _last(x: torch.Tensor, cf: bool) -> torch.Tensor:
    """Features last (NHWC) from an activation channels first if cf."""
    return x.permute(0, 2, 3, 1) if cf else x


def _first(x: torch.Tensor, cf: bool) -> torch.Tensor:
    """Channels first (NCHW) from a 4-D activation."""
    if x.dim() != 4:
        raise ValueError(f"a 2-D convolution or pooling needs a 4-D input, "
                         f"got shape {tuple(x.shape)}")
    return x if cf else x.permute(0, 3, 1, 2)


def _act(x: torch.Tensor, cf: bool, name) -> Tuple[torch.Tensor, bool]:
    if not name or name in ("linear", "softmax"):
        # softmax folds into the loss (see module docstring)
        return x, cf
    if name == "log_softmax":
        return F.log_softmax(_last(x, cf), dim=-1), False
    fn = _ACTIVATIONS.get(name)
    if fn is None:
        raise ValueError(f"unsupported activation {name!r}")
    return fn(x), cf


class _GRUCell(nn.Module):
    """flax's GRUCell: input kernels with biases (ir, iz, in), recurrent
    kernels without (hr, hz) and hn with one, held concatenated in gate
    order r, z, n, flax layout (in, 3 x hidden); the carry starts at
    zero."""

    GATES = "rzn"

    def __init__(self, in_features: int, hidden: int, device):
        super().__init__()
        self.hidden = hidden
        bound = 1.0 / math.sqrt(hidden)  # replaced by init_params' draw
        self.wi = nn.Parameter(torch.empty(in_features, 3 * hidden,
                                           device=device).uniform_(-bound,
                                                                   bound))
        self.bi = nn.Parameter(torch.zeros(3 * hidden, device=device))
        self.wh = nn.Parameter(torch.empty(hidden, 3 * hidden, device=device
                                           ).uniform_(-bound, bound))
        self.bhn = nn.Parameter(torch.zeros(hidden, device=device))

    def flax_names(self, flax_prefix: str, prefix: str) -> dict:
        out, h = {}, self.hidden
        for k, g in enumerate(self.GATES):
            cols = (k * h, (k + 1) * h)
            out[f"{flax_prefix}i{g}/kernel"] = (f"{prefix}wi", None, cols)
            out[f"{flax_prefix}i{g}/bias"] = (f"{prefix}bi", None, cols)
            out[f"{flax_prefix}h{g}/kernel"] = (f"{prefix}wh", None, cols)
        out[f"{flax_prefix}hn/bias"] = (f"{prefix}bhn", None, None)
        return out

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """(N, T, in) -> (N, T, hidden)."""
        n, steps, _ = xs.shape
        zi = xs @ self.wi + self.bi  # every step's input part at once
        h = xs.new_zeros(n, self.hidden)
        out = []
        for t in range(steps):
            ir, iz, i_n = zi[:, t].chunk(3, dim=-1)
            hr, hz, hn = (h @ self.wh).chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            c = torch.tanh(i_n + r * (hn + self.bhn))
            h = (1.0 - z) * c + z * h
            out.append(h)
        return torch.stack(out, dim=1)


class _Scope:
    """One Model's parameter namespace: its path and flax's automatic
    name counters, one a module class."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.counts: Dict[str, int] = {}

    def path(self, cls: str, cfg: dict) -> str:
        name = cfg.get("name")
        if not name:
            flax_cls = _FLAX_CLASS[cls]
            k = self.counts.get(flax_cls, 0)
            self.counts[flax_cls] = k + 1
            name = f"{flax_cls}_{k}"
        return self.prefix + name


class KerasDefineModel(_FlaxModel):
    """A torch model interpreting a Keras Sequential/functional nn_define
    (a dict or its JSON string)."""

    def __init__(self, nn_define, device="cuda"):
        super().__init__(device)
        if isinstance(nn_define, str):
            nn_define = json.loads(nn_define)
        if nn_define.get("class_name") not in ("Sequential", "Model"):
            raise ValueError(f"unsupported nn_define class "
                             f"{nn_define.get('class_name')!r}")
        self.define = nn_define
        self.mods = nn.ModuleDict()
        self._flax = {}
        self._recurrent = set()
        self._built = False

    def shapes_open(self) -> bool:
        return not self._built

    def recurrent_kernels(self) -> set:
        return set(self._recurrent)

    def _module(self, path: str, make, flax_names) -> nn.Module:
        """The layer's module, made at the first call (the shapes known);
        flax_names(module, flax prefix, torch prefix) maps its
        parameters."""
        if path not in self.mods:
            if self._built:
                raise KeyError(f"layer {path} was not in the first call")
            self.mods[path] = make()
            self._flax.update(flax_names(self.mods[path], f"{path}/",
                                         f"mods.{path}."))
        return self.mods[path]

    @staticmethod
    def _kernel_bias(perm, use_bias):
        def names(_, flax_prefix, prefix):
            out = {f"{flax_prefix}kernel": (f"{prefix}weight", perm, None)}
            if use_bias:
                out[f"{flax_prefix}bias"] = (f"{prefix}bias", None, None)
            return out
        return names

    def _cell_names(self, cell, flax_prefix, prefix):
        names = cell.flax_names(flax_prefix, prefix)
        self._recurrent.update(
            k for k in names if k.startswith(flax_prefix + "h")
            and k.endswith("/kernel"))
        return names

    def _layer(self, scope: _Scope, cls: str, cfg: dict, x: torch.Tensor,
               cf: bool) -> Tuple[torch.Tensor, bool]:
        """One Keras layer on an activation (channels first if cf)."""
        dev = self.device
        if cls == "Reshape":
            x = _last(x, cf)
            return x.reshape((x.shape[0],) + tuple(cfg["target_shape"])), \
                False
        if cls == "Flatten":
            x = _last(x, cf)
            return x.reshape(x.shape[0], -1), False
        if cls == "Dropout":
            return self.dropout(x, float(cfg["rate"])), cf
        if cls == "Activation":
            return _act(x, cf, cfg.get("activation"))
        if cls == "Dense":
            x = _last(x, cf)
            use_bias = cfg.get("use_bias", True)
            m = self._module(
                scope.path(cls, cfg),
                lambda: nn.Linear(x.shape[-1], int(cfg["units"]),
                                  bias=use_bias, device=dev),
                self._kernel_bias(_DENSE, use_bias))
            return _act(m(x), False, cfg.get("activation"))
        if cls == "Conv2D":
            x = _first(x, cf)
            use_bias = cfg.get("use_bias", True)
            kernel = _pair(cfg["kernel_size"])
            strides = _pair(cfg.get("strides", 1))
            m = self._module(
                scope.path(cls, cfg),
                lambda: nn.Conv2d(x.shape[1], int(cfg["filters"]), kernel,
                                  stride=strides, bias=use_bias, device=dev),
                self._kernel_bias(_CONV, use_bias))
            if cfg.get("padding", "valid").upper() == "SAME":
                x = _same_pad(x, kernel, strides)
            return _act(m(x), True, cfg.get("activation"))
        if cls in ("MaxPooling2D", "AveragePooling2D"):
            x = _first(x, cf)
            pool = _pair(cfg.get("pool_size", 2))
            strides = _pair(cfg.get("strides") or cfg.get("pool_size", 2))
            same = cfg.get("padding", "valid").upper() == "SAME"
            if cls == "MaxPooling2D":
                if same:
                    x = _same_pad(x, pool, strides, float("-inf"))
                return F.max_pool2d(x, pool, strides), True
            if same:
                x = _same_pad(x, pool, strides)
            return F.avg_pool2d(x, pool, strides), True
        if cls == "BatchNormalization":
            # -> GroupNorm (documented divergence, module docstring)
            x = _first(x, cf) if x.dim() == 4 else x.movedim(-1, 1)
            ch = x.shape[1]
            groups = 8
            while ch % groups:
                groups //= 2
            m = self._module(
                scope.path(cls, cfg),
                lambda: nn.GroupNorm(max(groups, 1), ch,
                                     eps=float(cfg.get("epsilon", 1e-3)),
                                     device=dev),
                lambda _, fp, p: {f"{fp}scale": (f"{p}weight", None, None),
                                  f"{fp}bias": (f"{p}bias", None, None)})
            y = m(x)
            return (y, True) if y.dim() == 4 else (y.movedim(1, -1), False)
        if cls == "Embedding":
            m = self._module(
                scope.path(cls, cfg),
                lambda: nn.Embedding(int(cfg["input_dim"]),
                                     int(cfg["output_dim"]), device=dev),
                lambda _, fp, p: {f"{fp}embedding": (f"{p}weight", None,
                                                     None)})
            return m(_last(x, cf).long()), False
        if cls in ("GRU", "LSTM"):
            x = _last(x, cf)
            units = int(cfg["units"])
            cell = _GRUCell if cls == "GRU" else _LSTMCell
            m = self._module(scope.path(cls, cfg),
                             lambda: cell(x.shape[-1], units, dev),
                             self._cell_names)
            y, _ = _act(m(x), False,
                        cfg.get("activation") if cls == "GRU" else None)
            if cfg.get("return_sequences", False):
                return y, False
            return y[:, -1, :], False
        if cls == "Model":
            return self._graph(_Scope(scope.path(cls, cfg) + "/"),
                               cfg["layers"], x, cf)
        raise ValueError(f"unsupported Keras layer {cls!r} in nn_define")

    def _graph(self, scope: _Scope, layers: List[dict], x: torch.Tensor,
               cf: bool) -> Tuple[torch.Tensor, bool]:
        """A functional Keras `Model` graph (the ResNet nn_define)."""
        values: Dict[str, Tuple[torch.Tensor, bool]] = {}
        for spec in layers:
            name, cls = spec["name"], spec["class_name"]
            if cls == "InputLayer":
                values[name] = (x, cf)
                continue
            ins = [values[ref[0]] for ref in spec["inbound_nodes"][0]]
            if cls == "Add":
                if len({c for _, c in ins}) > 1:
                    ins = [(_last(t, c), False) for t, c in ins]
                out = ins[0][0]
                for t, _ in ins[1:]:
                    out = out + t
                values[name] = (out, ins[0][1])
            else:
                values[name] = self._layer(scope, cls, spec["config"],
                                           *ins[0])
        return values[layers[-1]["name"]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        define, root = self.define, _Scope()
        if define["class_name"] == "Model":
            y, cf = self._layer(root, "Model",
                                {"layers": define["config"]["layers"]},
                                x, False)
        else:
            y, cf = x, False
            for spec in define["config"]["layers"]:
                if spec["class_name"] != "InputLayer":
                    y, cf = self._layer(root, spec["class_name"],
                                        spec["config"], y, cf)
        self._built = True
        return _last(y, cf)


def from_nn_define(nn_define: dict, device="cuda") -> KerasDefineModel:
    """The interpreter of an nn_define dict, on `device`."""
    return KerasDefineModel(json.dumps(nn_define), device=device)


@torch.no_grad()
def count_params_define(model: KerasDefineModel, input_example,
                        seed: int = 0) -> int:
    """Total trainable parameter count (to cross-check the reference's
    precompute.num_params, e.g. 1,206,590 for the FEMNIST CNN).  A model
    whose shapes are still open first sees `input_example`, as
    models.init_params shows it one; no parameter is drawn, so the count
    does not depend on `seed` (kept for the JAX function's signature)."""
    if model.shapes_open():
        training = model.training
        model.eval()
        model(torch.as_tensor(input_example).to(model.device))
        model.train(training)
    return sum(p.numel() for p in model.parameters())
