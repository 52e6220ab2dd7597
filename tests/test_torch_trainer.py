"""PyTorch port: the local trainer (flashe_tpu_torch/nn/trainer.py) and the
checkpoint (runtime/checkpoint.py) against the JAX package on the CPU.

- The port's optimizers compute optax's rules: adam, sgd and rmsprop
  (decay 0.9, eps inside the square root, no bias correction) over five
  gradients, some near 1e-5 where eps's place matters, at rtol 1e-6.
- The JAX LocalTrainer and the port's, from the same carried MLP params,
  full batch (the permutation only reorders rows inside the one batch), 3
  epochs: the params agree at atol 1e-5 for each optimizer, and evaluate
  at rtol 1e-5.
- _softmax_ce with and without pad_id equals the JAX one.
- A checkpoint round-trips params, optimizer state, aggregate_iter and
  quantizer statistics bit for bit, and load_model restores a client
  (tests/test_checkpoint.py's checks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flashe_tpu.nn import models as jmodels
from flashe_tpu.nn import trainer as jtrainer
from flashe_tpu_torch.nn import models as pmodels
from flashe_tpu_torch.nn.homo_nn import HomoNNGuest
from flashe_tpu_torch.nn.trainer import LocalTrainer, _softmax_ce, \
    make_optimizer
from flashe_tpu_torch.runtime.checkpoint import load_checkpoint, \
    save_checkpoint
from flashe_tpu_torch.runtime.config import HomoNNParam

OPTIMIZERS = ("adam", "sgd", "rmsprop")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(11)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    scales = (1.0, 1e-5, 3e-5, 0.1, 1e-5)
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in p0.items()} for s in scales]

    tx = jtrainer.make_optimizer(name, 1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(name, 1e-2, list(tp.values()))
    for step, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=0, err_msg=f"step {step} {k}")


def test_rmsprop_is_not_torchs():
    """torch.optim.RMSprop (alpha 0.99, eps outside the root) leaves optax's
    rule on small gradients: the port's own optimizer is needed."""
    g = torch.full((4,), 1e-5)
    ours = torch.nn.Parameter(torch.ones(4))
    theirs = torch.nn.Parameter(torch.ones(4))
    a = make_optimizer("rmsprop", 1e-2, [ours])
    b = torch.optim.RMSprop([theirs], lr=1e-2)
    ours.grad, theirs.grad = g.clone(), g.clone()
    a.step()
    b.step()
    assert abs(float(ours.detach()[0]) - float(theirs.detach()[0])) > 1e-3


@pytest.fixture(scope="module")
def mlp_data():
    rng = np.random.RandomState(3)
    y = rng.randint(0, 10, 48).astype(np.int32)
    x = rng.randn(48, 32).astype(np.float32)
    x[np.arange(48), y] += 2.0
    params = jmodels.init_params(jmodels.MLP(), jnp.asarray(x[:1]), seed=0)
    return x, y, params


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_local_trainer_matches_jax(mlp_data, name):
    x, y, params = mlp_data
    jt = jtrainer.LocalTrainer(jmodels.MLP(), params, optimizer=name,
                               learning_rate=5e-3, seed=0)
    model = pmodels.MLP(device="cpu")
    pmodels.init_params(model, x[:1])
    pt = LocalTrainer(model, jax.tree_util.tree_map(np.asarray, params),
                      optimizer=name, learning_rate=5e-3, seed=0,
                      device="cpu")
    jloss = jt.train(x, y, epochs=3, batch_size=len(x))
    ploss = pt.train(x, y, epochs=3, batch_size=len(x))
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    got = pt.get_model_weights()
    for layer, d in jt.params.items():
        for k, v in d.items():
            np.testing.assert_allclose(got[f"{layer}/{k}"].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-5)
    jl, ja = jt.evaluate(x, y)
    pl, pa = pt.evaluate(x, y)
    np.testing.assert_allclose([pl, pa], [jl, ja], rtol=1e-5)
    np.testing.assert_allclose(pt.predict(x[:5]), np.asarray(jt.predict(
        x[:5])), rtol=0, atol=1e-5)


def test_minibatches_drop_the_partial_batch(mlp_data):
    x, y, _ = mlp_data
    model = pmodels.MLP(device="cpu")
    pmodels.init_params(model, x[:1])
    t = LocalTrainer(model, optimizer="sgd", device="cpu")
    seen = []
    forward = model.forward
    model.forward = lambda xb: (seen.append(len(xb)), forward(xb))[1]
    t.train(x, y, epochs=2, batch_size=20)  # 48 rows: 20 + 20, 8 dropped
    assert seen == [20, 20, 20, 20]
    seen.clear()
    t.train(x[:7], y[:7], batch_size=20)  # fewer rows than a batch: all
    assert seen == [7]


def test_set_model_weights_keeps_the_optimizer(mlp_data):
    x, y, params = mlp_data
    model = pmodels.MLP(device="cpu")
    pmodels.init_params(model, x[:1])
    t = LocalTrainer(model, device="cpu")
    t.train(x, y, batch_size=16)
    before = {id(p) for p in model.parameters()}
    moments = [s["mu"].clone() for s in t.optimizer.state.values()]
    t.set_model_weights(jax.tree_util.tree_map(np.asarray, params))
    assert {id(p) for p in model.parameters()} == before
    for got, want in zip([s["mu"] for s in t.optimizer.state.values()],
                         moments):
        assert torch.equal(got, want)
    got = t.modify(lambda p: {k: 2 * v for k, v in p.items()})
    np.testing.assert_array_equal(got["Dense_1/bias"].numpy(),
                                  2 * np.asarray(params["Dense_1"]["bias"]))


@pytest.mark.parametrize("pad_id", [None, 0, 3])
def test_softmax_ce_matches_jax(pad_id):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (4, 6)).astype(np.int32)
    labels[0, :4] = 3
    want = float(jtrainer._softmax_ce(jnp.asarray(logits),
                                      jnp.asarray(labels), pad_id))
    got = float(_softmax_ce(torch.from_numpy(logits),
                            torch.from_numpy(labels), pad_id))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if pad_id is not None:
        # all padding: the weight clamps at one, the loss is zero
        assert float(_softmax_ce(torch.from_numpy(logits),
                                 torch.full((4, 6), pad_id), pad_id)) == 0


def test_checkpoint_roundtrip(tmp_path, mlp_data):
    x, y, _ = mlp_data
    model = pmodels.MLP(features=(8, 4), device="cpu")
    pmodels.init_params(model, x[:1])
    t = LocalTrainer(model, device="cpu")
    t.train(x, y % 4, batch_size=16)
    path = str(tmp_path / "ckpt.bin")
    stats = {"past_mean": np.arange(3, dtype=np.float32),
             "past_std": torch.ones(3)}
    save_checkpoint(path, t.params, aggregate_iter=7,
                    opt_state=t.optimizer.state_dict(),
                    quantizer_stats=stats)
    loaded = load_checkpoint(path)
    assert loaded["aggregate_iter"] == 7
    np.testing.assert_array_equal(loaded["quantizer_stats"]["past_mean"],
                                  stats["past_mean"])
    np.testing.assert_array_equal(loaded["quantizer_stats"]["past_std"],
                                  np.ones(3, np.float32))
    for k, v in t.params.items():
        assert loaded["params"][k].dtype == np.float32
        np.testing.assert_array_equal(loaded["params"][k], v.numpy())

    # a fresh trainer (another init) takes the params and the optimizer
    other = pmodels.MLP(features=(8, 4), device="cpu")
    pmodels.init_params(other, x[:1], seed=99)
    t2 = LocalTrainer(other, device="cpu")
    t2.set_model_weights(loaded["params"])
    t2.optimizer.load_state_dict(loaded["opt_state"])
    want, got = t.optimizer.state_dict(), t2.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        assert set(s) == {"count", "mu", "nu"}
        assert got["state"][i]["count"] == s["count"] == 3
        for k in ("mu", "nu"):
            assert torch.equal(got["state"][i][k], s[k]), (i, k)
    for k, v in t.params.items():
        assert torch.equal(t2.params[k], v)
    # and both take the same next full-batch step
    t.train(x, y % 4, batch_size=len(x))
    t2.train(x, y % 4, batch_size=len(x))
    for k, v in t.params.items():
        np.testing.assert_allclose(t2.params[k].numpy(), v.numpy(), atol=1e-6)


def test_load_model_restores_client(tmp_path):
    param = HomoNNParam.from_dict(
        {"model": "mlp", "max_iter": 1, "secure_aggregate": "plain"})
    x = np.random.RandomState(0).randn(4, 32).astype(np.float32)

    src = HomoNNGuest(param, seed=0, device="cpu")
    src._build(x[:1])
    src.trainer.modify(lambda p: {k: v + 0.5 for k, v in p.items()})
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, src.trainer.params, aggregate_iter=5)

    dst = HomoNNGuest(param, seed=9, device="cpu")
    dst.load_model(path, x[:1])
    assert dst.aggregate_iter == 5
    np.testing.assert_array_equal(dst.predict(x), src.predict(x))
