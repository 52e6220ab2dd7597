"""PyTorch port: the model zoo (flashe_tpu_torch/nn/models.py) against the
JAX package's flax models on the CPU.

Each model gets the JAX init carried across by name (params_from_flax):
- the logits agree at atol 1e-5 (CifarResNet 1e-4: twelve convolutions and
  GroupNorms summed in another order than XLA's);
- the codec's flat vector of the carried parameters equals the JAX codec's
  bit for bit, and the parameter names, counts and leaves are flax's;
- the gradient of the eval-mode loss agrees at a relative L2 error below
  1e-4.
The two layout traps are pinned by mutation: CifarResNet with symmetric
SAME padding at stride 2, or with torch's GroupNorm epsilon (1e-5 for
flax's 1e-6), leaves the JAX logits.  The port's own init draws the flax
initializers' distributions (each kernel's std within 10% of the JAX
init's at the same shape, biases zero, GroupNorm scales one, the LSTM's
recurrent kernels orthogonal) and gives every client the same model.
Dropout draws from the model's own generator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flashe_tpu.nn import models as jmodels
from flashe_tpu.nn.weights import WeightsCodec as JCodec
from flashe_tpu_torch.nn import models as pmodels
from flashe_tpu_torch.nn.trainer import _softmax_ce
from flashe_tpu_torch.nn.weights import WeightsCodec

# name: (JAX model, port model, input, labels' range, logits' atol,
#        parameters, leaves)
rng = np.random.default_rng(7)
CASES = {
    "mlp": (jmodels.MLP, pmodels.MLP,
            rng.standard_normal((2, 32)).astype(np.float32), 10, 1e-5,
            2_762, 4),
    "femnist_cnn": (jmodels.FemnistCNN, pmodels.FemnistCNN,
                    0.3 * rng.standard_normal((2, 28, 28, 1)).astype(
                        np.float32), 62, 1e-5, 1_206_590, 8),
    "cifar_resnet": (jmodels.CifarResNet, pmodels.CifarResNet,
                     0.3 * rng.standard_normal((2, 32, 32, 3)).astype(
                         np.float32), 10, 1e-4, 175_066, 43),
    "char_lstm": (jmodels.CharLSTM, pmodels.CharLSTM,
                  rng.integers(0, 80, (2, 80)).astype(np.int32), 80, 1e-5,
                  817_872, 27),
}
del rng


def _names(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def carried():
    """name -> (JAX params, port model holding them in eval mode, x)."""
    out = {}
    for name, (jcls, pcls, x, *_rest) in CASES.items():
        params = jmodels.init_params(jcls(), jnp.asarray(x), seed=0)
        model = pcls(device="cpu")
        pmodels.init_params(model, x)
        model.params_from_flax(jax.tree_util.tree_map(np.asarray, params))
        out[name] = (params, model.eval(), x)
    return out


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_carried_params_give_the_jax_logits(carried, name):
    jcls, _, _, _, atol, n_params, n_leaves = CASES[name]
    params, model, x = carried[name]
    want = np.asarray(jcls().apply({"params": params}, jnp.asarray(x)))
    got = _logits(model, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert sum(p.numel() for p in model.parameters()) == n_params
    assert len(model.params_to_flax()) == n_leaves


@pytest.mark.parametrize("name", list(CASES))
def test_codec_flat_vector_is_the_jax_codecs(carried, name):
    params, model, _ = carried[name]
    jc = JCodec(params)
    pc = WeightsCodec(model.params_to_flax(), device="cpu")
    assert pc.keys == jc.keys and pc.sizes == jc.sizes
    np.testing.assert_array_equal(pc.flatten(model.params_to_flax()).numpy(),
                                  np.asarray(jc.flatten(params)))
    for k, v in _names(params).items():
        np.testing.assert_array_equal(model.params_to_flax()[k].numpy(), v)


@pytest.mark.parametrize("name", list(CASES))
def test_eval_loss_gradient_matches_jax(carried, name):
    jcls, _, _, n_labels, *_ = CASES[name]
    params, model, x = carried[name]
    y = np.arange(x.shape[0], dtype=np.int32) * 3 % n_labels

    def loss_fn(p):
        logits = jcls().apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jgrad = np.asarray(JCodec(params).flatten(jax.grad(loss_fn)(params)))
    model.zero_grad(set_to_none=True)
    _softmax_ce(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    grads = model.flax_view({n: p.grad for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    pgrad = WeightsCodec(grads, device="cpu").flatten(grads).numpy()
    rel = np.linalg.norm(pgrad - jgrad) / np.linalg.norm(jgrad)
    assert rel < 1e-4, rel


def _symmetric_pad(x, kernel, stride):
    p = (kernel - 1) // 2
    return torch.nn.functional.pad(x, (p, p, p, p))


def test_resnet_fails_under_symmetric_padding(carried, monkeypatch):
    """The stride-2 convolutions need flax's (0, 1) SAME padding; torch's
    padding=1 pads (1, 1) and moves every logit."""
    params, model, x = carried["cifar_resnet"]
    want = np.asarray(jmodels.CifarResNet().apply({"params": params},
                                                  jnp.asarray(x)))
    np.testing.assert_allclose(_logits(model, x), want, rtol=0, atol=1e-4)
    monkeypatch.setattr(pmodels, "_same_pad", _symmetric_pad)
    assert np.abs(_logits(model, x) - want).max() > 1e-2


def test_resnet_fails_with_torch_group_norm_eps(carried):
    """flax's GroupNorm eps is 1e-6.  On inputs whose group variances are
    near 1e-5, torch's default 1e-5 moves the logits far past 1e-4."""
    params, model, _ = carried["cifar_resnet"]
    x = 0.003 * np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodels.CifarResNet().apply({"params": params},
                                                  jnp.asarray(x)))
    np.testing.assert_allclose(_logits(model, x), want, rtol=0, atol=1e-4)
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.GroupNorm)]
    assert len(norms) == 13 and all(m.eps == 1e-6 for m in norms)
    try:
        for m in norms:
            m.eps = 1e-5
        assert np.abs(_logits(model, x) - want).max() > 1e-3
    finally:
        for m in norms:
            m.eps = 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_init_draws_the_flax_distributions(carried, name):
    jcls, pcls, x, *_ = CASES[name]
    jparams = _names(carried[name][0])
    a, b = pcls(device="cpu"), pcls(device="cpu")
    got = pmodels.init_params(a, x, seed=0)
    other = pmodels.init_params(b, x, seed=0)
    assert set(got) == set(jparams)
    for k, v in got.items():
        # every client draws the same model from seed 0
        assert torch.equal(v, other[k]), k
        want = jparams[k]
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "bias":
            assert not v.any(), k
        elif leaf == "scale":
            assert bool((v == 1).all()), k
        else:
            assert abs(float(v.std()) / want.std() - 1) < 0.1, k
            assert abs(float(v.mean())) < 3 * want.std() / np.sqrt(v.numel())
        if "/h" in k and leaf == "kernel":
            eye = v.T @ v
            assert torch.allclose(eye, torch.eye(v.shape[1]), atol=1e-5), k
    if name == "femnist_cnn":
        # truncated at two standard deviations, as lecun_normal is
        w = got["Dense_0/kernel"]
        assert float(w.abs().max()) <= 2 / np.sqrt(12 * 12 * 64) / 0.8796 + 1e-7


def test_dropout_draws_from_the_models_generator():
    model = pmodels.FemnistCNN(device="cpu")
    x = torch.ones(64, 128)
    model.train()
    model.generator.manual_seed(5)
    first = model.dropout(x, 0.5)
    model.generator.manual_seed(5)
    assert torch.equal(model.dropout(x, 0.5), first)
    assert not torch.equal(model.dropout(x, 0.5), first)
    # flax's rule: kept entries scaled by 1 / (1 - rate), about half kept
    assert set(first.unique().tolist()) <= {0.0, 2.0}
    assert 0.45 < float((first > 0).float().mean()) < 0.55
    # the global generator is not drawn from
    state = torch.get_rng_state()
    model(torch.zeros(2, 28, 28, 1))
    assert torch.equal(torch.get_rng_state(), state)
    model.eval()
    assert model.dropout(x, 0.5) is x
    xs = torch.randn(3, 28, 28, 1)
    model.generator.manual_seed(1)
    a = model(xs)
    model.generator.manual_seed(2)
    assert torch.equal(model(xs), a)


def test_build_model_registry_and_keras():
    for name, cls in (("mlp", pmodels.MLP), ("cnn", pmodels.FemnistCNN),
                      ("femnist_cnn", pmodels.FemnistCNN),
                      ("resnet", pmodels.CifarResNet),
                      ("cifar_resnet", pmodels.CifarResNet),
                      ("lstm", pmodels.CharLSTM),
                      ("char_lstm", pmodels.CharLSTM)):
        assert type(pmodels.build_model(name, device="cpu")) is cls
    m = pmodels.build_model("mlp", device="cpu", features=(16, 4))
    pmodels.init_params(m, np.zeros((1, 7), np.float32))
    assert m.params_to_flax()["Dense_0/kernel"].shape == (7, 16)
    define = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Dense", "config": {"name": "d", "units": 3}}]}}
    for name in ("keras", "nn_define"):  # the Keras interpreter
        m = pmodels.build_model(name, device="cpu", nn_define=define)
        pmodels.init_params(m, np.zeros((1, 5), np.float32))
        assert {k: tuple(v.shape) for k, v in m.params_to_flax().items()} \
            == {"d/kernel": (5, 3), "d/bias": (3,)}
        with pytest.raises(ValueError, match="nn_define class"):
            pmodels.build_model(name, device="cpu", nn_define="{}")
    with pytest.raises(ValueError, match="unknown model"):
        pmodels.build_model("vgg", device="cpu")
