"""PyTorch port: the Keras nn_define interpreter
(flashe_tpu_torch/nn/keras_define.py) against the JAX package's
KerasDefineModel.

For each define (the MLP, the Embedding + GRU and the GRU sequence of
tests/test_dsl.py, its functional Model with Conv2D, BatchNormalization
and Add, an LSTM stack, a strided SAME Conv2D with both SAME poolings, the
FEMNIST CNN, a top-level functional Model, and a define with no layer
names): the port's flax name -> shape map equals the JAX model's init
tree; with the JAX parameters carried across (params_from_flax),
eval-mode logits agree within rtol 1e-5 / atol 1e-5 (float32).  The
FEMNIST CNN define has 1,206,590 parameters, and build_model("nn_define")
builds the interpreter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.nn.keras_define import from_nn_define as jfrom_nn_define
from flashe_tpu_torch.nn.keras_define import KerasDefineModel
from flashe_tpu_torch.nn.models import _named, build_model, init_params


def L(cls, **cfg):
    return {"class_name": cls, "config": cfg}


def seq(name, *layers):
    return {"class_name": "Sequential",
            "config": {"name": name, "layers": list(layers)}}


def node(cls, name, inbound, **cfg):
    return {"class_name": cls, "config": dict(cfg, name=name), "name": name,
            "inbound_nodes": [[[ref, 0, 0, {}] for ref in inbound]]}


GRAPH_LAYERS = [
    {"class_name": "InputLayer", "config": {"name": "in"}, "name": "in",
     "inbound_nodes": []},
    node("Conv2D", "c1", ["in"], filters=2, kernel_size=[3, 3],
         padding="same", use_bias=False),
    node("BatchNormalization", "bn", ["c1"]),
    node("Add", "add", ["in", "bn"]),
    node("Activation", "act", ["add"], activation="relu"),
    node("Flatten", "f", ["act"]),
    node("Dense", "d", ["f"], units=3),
]

FEMNIST_CNN = seq(
    "sequential",
    L("Reshape", name="reshape", target_shape=[28, 28, 1]),
    L("Conv2D", name="conv2d", filters=32, kernel_size=[3, 3],
      activation="relu"),
    L("Conv2D", name="conv2d_1", filters=64, kernel_size=[3, 3],
      activation="relu"),
    L("MaxPooling2D", name="max_pooling2d", pool_size=[2, 2]),
    L("Dropout", name="dropout", rate=0.25),
    L("Flatten", name="flatten"),
    L("Dense", name="dense", units=128, activation="relu"),
    L("Dropout", name="dropout_1", rate=0.5),
    L("Dense", name="dense_1", units=62, activation="softmax"))
N_FEMNIST = 1_206_590

# (define, input maker(rng, n))
DEFINES = {
    "mlp": (seq("mlp", L("Dense", name="d1", units=16, activation="relu"),
                L("Dense", name="d2", units=3, activation="softmax")),
            lambda rng, n: rng.standard_normal((n, 8)).astype(np.float32)),
    "embedding_gru": (
        seq("lstm", L("Embedding", name="e", input_dim=5, output_dim=4),
            L("GRU", name="g", units=8, return_sequences=True),
            L("Dense", name="d", units=5, activation="linear")),
        lambda rng, n: rng.integers(0, 5, (n, 7)).astype(np.int32)),
    "functional_conv_bn_add": (
        seq("g", L("Reshape", name="r", target_shape=[4, 4, 2]),
            L("Model", name="m", layers=GRAPH_LAYERS)),
        lambda rng, n: rng.standard_normal((n, 32)).astype(np.float32)),
    "gru_sequence": (
        seq("lstm", L("Embedding", name="e", input_dim=5, output_dim=4,
                      batch_input_shape=[None, 7]),
            L("GRU", name="g", units=8, activation="tanh",
              return_sequences=True),
            L("Dense", name="d", units=5, activation="linear")),
        lambda rng, n: rng.integers(0, 5, (n, 7)).astype(np.int32)),
    "lstm": (
        seq("lstm", L("Embedding", name="e", input_dim=6, output_dim=4),
            L("LSTM", name="l1", units=8, return_sequences=True),
            L("LSTM", name="l2", units=5),
            L("Dense", name="d", units=6)),
        lambda rng, n: rng.integers(0, 6, (n, 9)).astype(np.int32)),
    # 10x10 -> conv stride 2 SAME: 5x5, padding 0 / 1 (the odd pixel at
    # the end); max pool 2 stride 2 SAME: 3x3, padding 0 / 1 with -inf;
    # average pool 2 stride 2 SAME: 2x2, padding 0 / 1 counted in the mean
    "strided_same": (
        seq("s", L("Reshape", name="r", target_shape=[10, 10, 2]),
            L("Conv2D", name="c", filters=3, kernel_size=[3, 2],
              strides=[2, 2], padding="same", activation="tanh"),
            L("MaxPooling2D", name="mp", pool_size=[2, 2], strides=[2, 2],
              padding="same"),
            L("AveragePooling2D", name="ap", pool_size=2, padding="same"),
            L("Flatten", name="f"),
            L("Dense", name="d", units=4)),
        lambda rng, n: rng.standard_normal((n, 200)).astype(np.float32)),
    "femnist_cnn": (
        FEMNIST_CNN,
        lambda rng, n: rng.standard_normal((n, 28, 28, 1)).astype(
            np.float32)),
    "top_level_model": (
        {"class_name": "Model", "config": {"name": "top",
                                           "layers": GRAPH_LAYERS}},
        lambda rng, n: rng.standard_normal((n, 4, 4, 2)).astype(np.float32)),
    # flax's automatic names: Conv_0, GroupNorm_0, GroupNorm_1, Dense_0,
    # GRUCell_0, _Graph_0 and the nested Model's own Dense_0
    "unnamed": (
        seq("u", L("Reshape", target_shape=[6, 6, 1]),
            L("Conv2D", filters=4, kernel_size=3, activation="gelu"),
            L("BatchNormalization", epsilon=1e-5),
            L("Reshape", target_shape=[4, 16]),
            L("GRU", units=3, return_sequences=True),
            L("BatchNormalization"),
            L("Activation", activation="elu"),
            L("Model", layers=[
                {"class_name": "InputLayer", "config": {}, "name": "i",
                 "inbound_nodes": []},
                node("Flatten", "f", ["i"]),
                {"class_name": "Dense", "config": {"units": 3},
                 "name": "d", "inbound_nodes": [[["f", 0, 0, {}]]]}]),
            L("Dense", units=2)),
        lambda rng, n: rng.standard_normal((n, 36)).astype(np.float32)),
}


def _jax_model(define, x):
    m = jfrom_nn_define(define)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return m, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("case", sorted(DEFINES))
def test_names_shapes_and_logits_match_jax(case):
    define, make_x = DEFINES[case]
    x = make_x(np.random.default_rng(7), 5)
    jm, params = _jax_model(define, x)
    want = {k: v.shape for k, v in _named(params).items()}

    model = KerasDefineModel(define, device="cpu")
    got = {k: tuple(v.shape) for k, v in init_params(model, x[:1]).items()}
    assert got == want

    model.params_from_flax(params)
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    assert logits.shape == ref.shape
    np.testing.assert_allclose(logits, ref, rtol=1e-5, atol=1e-5)
    back = model.params_to_flax()
    for k, v in _named(params).items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_femnist_cnn_define_count_and_build_model():
    model = build_model("nn_define", device="cpu", nn_define=FEMNIST_CNN)
    assert isinstance(model, KerasDefineModel)
    params = init_params(model, np.zeros((1, 784), np.float32))
    assert sum(v.numel() for v in params.values()) == N_FEMNIST
    # init_params draws the same model for the same seed
    again = init_params(KerasDefineModel(FEMNIST_CNN, device="cpu"),
                        np.zeros((1, 28, 28, 1), np.float32))
    for k, v in params.items():
        assert torch.equal(v, again[k])


@pytest.mark.parametrize("name", [
    "relu", "tanh", "sigmoid", "elu", "selu", "celu", "gelu", "softplus",
    "silu", "swish", "leaky_relu", "relu6", "hard_sigmoid", "hard_tanh",
    "log_sigmoid", "log_softmax", "linear", "softmax"])
def test_activations_match_jax(name):
    define = seq("a", L("Dense", name="d", units=6, activation=name))
    x = np.random.default_rng(3).standard_normal((4, 5)).astype(np.float32)
    x *= 4.0
    jm, params = _jax_model(define, x)
    model = KerasDefineModel(define, device="cpu")
    init_params(model, x[:1])
    model.params_from_flax(params)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def test_rejects_unsupported_define_layer_and_activation():
    with pytest.raises(ValueError, match="nn_define class"):
        KerasDefineModel({"class_name": "Functional"}, device="cpu")
    x = torch.zeros(2, 3)
    for layer, match in ((L("Conv1D", filters=2, kernel_size=3), "Conv1D"),
                         (L("Dense", units=2, activation="bogus"),
                          "activation")):
        with pytest.raises(ValueError, match=match):
            KerasDefineModel(seq("x", layer), device="cpu")(x)


def test_dropout_is_active_in_training_only():
    model = KerasDefineModel(FEMNIST_CNN, device="cpu")
    x = np.random.default_rng(0).standard_normal((3, 784)).astype(np.float32)
    init_params(model, x[:1])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ev = [model.eval()(xt) for _ in range(2)]
        tr = [model.train()(xt) for _ in range(2)]
    assert torch.equal(ev[0], ev[1])
    assert not torch.equal(tr[0], tr[1])
