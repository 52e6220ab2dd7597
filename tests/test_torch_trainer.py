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
- A checkpoint round-trips params, optimizer state (each count a host
  int), aggregate_iter and quantizer statistics bit for bit, and
  load_model restores a client (tests/test_checkpoint.py's checks).
- The step over tensors that stay in place, run eagerly and replayed (a
  CUDA graph's stand-in that reruns the captured function, the optimizer
  seeing a capture), reproduces the trainer as it was before graphs (each
  count's Adam corrections copied from the host) bit for bit over 3
  rounds with an install between them, for each optimizer, on the MLP and
  a small GRU define; Adam's table of corrections holds the per-count
  float32 values across refills; steps are replayed only where the
  device allows it and the step drew no dropout, and each is counted in
  the record open around it; build_model and init_params wait while a
  capture holds the capture lock.
"""

from __future__ import annotations

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flashe_tpu.nn import models as jmodels
from flashe_tpu_torch.device import CAPTURE_LOCK
from flashe_tpu.nn import trainer as jtrainer
from flashe_tpu_torch.nn import models as pmodels
from flashe_tpu_torch.nn import trainer as ptrainer
from flashe_tpu_torch.nn.homo_nn import HomoNNGuest
from flashe_tpu_torch.nn.keras_define import KerasDefineModel
from flashe_tpu_torch.nn.trainer import LocalTrainer, _softmax_ce, \
    make_optimizer
from flashe_tpu_torch.runtime.checkpoint import load_checkpoint, \
    save_checkpoint
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.tracking import Tracker, set_tracker, span, \
    tracker
from flashe_tpu_torch.tools.shakespeare_experiment import gru_define

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
        assert type(got["state"][i]["count"]) is int
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


# -- the step over tensors that stay in place, eager and replayed ------------

class _TodaysAdam(torch.optim.Optimizer):
    """OptaxAdam's step before its table: each count's corrections made on
    the host in float32 and copied to the parameters' device."""

    def __init__(self, params, lr):
        super().__init__(params, dict(lr=lr, b1=0.9, b2=0.999, eps=1e-8))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(count=0, mu=torch.zeros_like(p),
                                 nu=torch.zeros_like(p))
                state["count"] += 1
                g, mu, nu = p.grad, state["mu"], state["nu"]
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * (g * g))
                t = torch.tensor(float(state["count"]))
                bc1, bc2 = [(1 - torch.tensor(b, dtype=torch.float32) ** t)
                            .to(p.device) for b in (b1, b2)]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                p.add_(-group["lr"] * u)


def _todays_train(t, x, y, batch_size):
    """LocalTrainer.train as it was before graphs (one epoch)."""
    n = x.shape[0]
    xs, ys = torch.as_tensor(x), torch.as_tensor(y)
    t.model.train()
    losses = []
    perm = torch.randperm(n, generator=t._perm_gen)
    for b in range(0, n - batch_size + 1, batch_size) or [0]:
        idx = perm[b:b + batch_size]
        t.optimizer.zero_grad(set_to_none=True)
        loss = _softmax_ce(t.model(xs[idx]), ys[idx], t.pad_id)
        loss.backward()
        t.optimizer.step()
        losses.append(loss.detach())
    return float(torch.stack(losses).double().mean())


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Steps replayed on the CPU: a graph's stand-in whose capture runs
    nothing and whose replay reruns the captured function over the static
    batch into the static outputs, the optimizer seeing a capture, as a
    CUDA graph's kernels repeat the step's device work and leave its host
    half to `advance`; every step that draws nothing replays."""
    flag = {"on": False}

    class CpuGraph(ptrainer._StepGraph):
        def _capture(self, fn, stream):
            out = []

            def replay():
                flag["on"] = True
                try:
                    out[:] = fn(self.x, self.y)
                finally:
                    flag["on"] = False
            return types.SimpleNamespace(replay=replay), out

    monkeypatch.setattr(ptrainer, "_StepGraph", CpuGraph)
    monkeypatch.setattr(ptrainer, "_capturing", lambda t: flag["on"])
    monkeypatch.setattr(LocalTrainer, "_replayable",
                        lambda self, drew: not drew)


def _token_rows(seed, rows=32, seq=10, vocab=20):
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (rows, seq + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def _setup(kind, name, seed=5):
    """(trainer, x, y, batch size) of a small model."""
    if kind == "mlp":
        rng = np.random.RandomState(3)
        y = rng.randint(0, 10, 48).astype(np.int32)
        x = rng.randn(48, 32).astype(np.float32)
        model, pad, bs = pmodels.MLP(device="cpu"), None, 16
    else:
        x, y = _token_rows(1)
        model = KerasDefineModel(gru_define(8, 8, vocab=20, seq_len=10),
                                 device="cpu")
        pad, bs = 0, 16
    pmodels.init_params(model, x[:1], seed=0)
    t = LocalTrainer(model, optimizer=name, learning_rate=1e-2, seed=seed,
                     label_pad_id=pad, device="cpu")
    return t, x, y, bs


def _rounds(t, x, y, bs, train, rounds=3):
    """Train, install half way back to the start, evaluate: each round's
    (loss, eval loss, eval accuracy)."""
    w0 = t.params
    out = []
    for _ in range(rounds):
        loss = train(t, x, y, bs)
        t.set_model_weights({k: v * 0.5 + w0[k] * 0.5
                             for k, v in t.params.items()})
        out.append((loss, *t.evaluate(x, y)))
    return out


def _same_state(a, b):
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert set(sa) == set(sb), k
        for key, v in sa.items():
            if torch.is_tensor(v):
                assert torch.equal(v, sb[key]), (k, key)
            else:
                assert type(v) is type(sb[key]) and v == sb[key], (k, key)


@pytest.mark.parametrize("replayed", [False, True], ids=["eager", "replayed"])
@pytest.mark.parametrize("kind", ["mlp", "gru"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_the_step_reproduces_todays_trainer(request, name, kind, replayed):
    if replayed:
        request.getfixturevalue("cpu_graphs")
    t, x, y, bs = _setup(kind, name)
    ref, _, _, _ = _setup(kind, name)
    if name == "adam":
        ref.optimizer = _TodaysAdam(ref.model.parameters(), 1e-2)
    set_tracker(Tracker("trainer_test"))
    with span("local train"):
        got = _rounds(t, x, y, bs, lambda t_, *a: t_.train(*a[:2],
                                                          batch_size=a[2]))
    want = _rounds(ref, x, y, bs, _todays_train)
    assert got == want
    _same_state(t, ref)
    steps = 3 * (len(x) // bs) + 3  # the train steps and 1 eval batch a round
    counts = tracker().read()[0].counts
    if replayed:
        assert counts == {"eager_steps": 2, "graph_steps": steps - 2}
        assert all(isinstance(v, ptrainer._StepGraph)
                   for v in t._steps.values())
    else:
        assert counts == {"eager_steps": steps}
        assert set(t._steps.values()) == {ptrainer._EAGER}


def test_bias_correction_table_keeps_the_float32_bits(monkeypatch):
    """The table's row of each count 1 .. 3 blocks holds today's float32
    corrections bit for bit, refilled in place once a block, each refill
    one host sync."""
    block = 8
    c = ptrainer._Corrections(0.9, 0.999, torch.device("cpu"), block)
    set_tracker(Tracker("table_test"))
    table = c.table
    with span("steps"):
        for t in range(1, 3 * block + 1):
            got = c.take(t, False)
            want = [1 - torch.tensor(b, dtype=torch.float32) ** torch.tensor(
                float(t)) for b in (0.9, 0.999)]
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and g.item() == w.item(), t
    assert c.table is table and c.at == 3 * block + 1
    assert tracker().read()[0].counts is None  # syncs in children
    syncs = [r for r in tracker().read() if r.name == "host sync"]
    assert len(syncs) == 3 and all(r.counts == {"host_syncs": 1}
                                   for r in syncs)
    # a capture takes only the row a seek set
    with pytest.raises(RuntimeError, match="seek"):
        c.take(5, True)
    # and the optimizer at the default block: today's steps bit for bit
    monkeypatch.setattr(ptrainer.OptaxAdam, "BLOCK", block)
    p = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    q = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    a, b = ptrainer.OptaxAdam(p, 1e-2), _TodaysAdam(q, 1e-2)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2 * block + 3):
        for x, z in zip(p, q):
            x.grad = torch.randn(3, generator=gen)
            z.grad = x.grad.clone()
        a.step()
        b.step()
    for x, z in zip(p, q):
        assert torch.equal(x, z)
        assert a.state[x]["count"] == b.state[z]["count"] == 2 * block + 3


def test_only_steps_that_draw_nothing_replay(cpu_graphs):
    """With replays allowed, FemnistCNN's training (dropout) stays eager and
    its evaluation replays from its second batch; each step counts in the
    record open around it."""
    gen = np.random.default_rng(4)
    x = gen.standard_normal((8, 28, 28, 1)).astype(np.float32)
    y = gen.integers(0, 62, 8).astype(np.int32)
    cnn = pmodels.FemnistCNN(device="cpu")
    pmodels.init_params(cnn, x[:1])
    t = LocalTrainer(cnn, device="cpu")
    set_tracker(Tracker("engage_test"))
    for _ in range(2):
        with span("local train"):
            t.train(x, y, batch_size=4)
        with span("evaluate"):
            t.evaluate(x, y)
    recs = [r for r in tracker().read() if r.name != "host sync"]
    assert [r.counts for r in recs] == [
        {"eager_steps": 2}, {"eager_steps": 1},
        {"eager_steps": 2}, {"graph_steps": 1}]
    assert cnn.drew
    assert t._steps[("train", (4, 28, 28, 1), (4,))] is ptrainer._EAGER


def test_the_cpu_steps_stay_eager(mlp_data):
    """Without the stand-in the CPU never replays; a state_dict loaded
    after the graphs are made has them captured anew (with the stand-in,
    below)."""
    x, y, _ = mlp_data
    model = pmodels.MLP(device="cpu")
    pmodels.init_params(model, x[:1])
    t = LocalTrainer(model, device="cpu")
    set_tracker(Tracker("cpu_test"))
    with span("local train"):
        t.train(x, y, batch_size=16)
        t.train(x, y, batch_size=16)
    assert tracker().read()[0].counts == {"eager_steps": 6}
    assert not model.drew


def test_a_loaded_state_is_captured_anew(cpu_graphs, mlp_data):
    """Loading a state_dict replaces Adam's moments, which the graphs
    write: they are dropped, the next step runs eagerly and captures
    again, and the trainer stays with an eager one bit for bit."""
    x, y, _ = mlp_data
    ts = []
    for _ in range(2):
        model = pmodels.MLP(device="cpu")
        pmodels.init_params(model, x[:1])
        ts.append(LocalTrainer(model, device="cpu"))
    ts[1]._replayable = lambda drew: False
    for t in ts:
        t.train(x, y, batch_size=16)
        state = t.optimizer.state_dict()
        t.optimizer.load_state_dict(state)
        t.train(x, y, batch_size=16)
    _same_state(*ts)
    assert isinstance(ts[0]._steps[("train", (16, 32), (16,))],
                      ptrainer._StepGraph)


@pytest.mark.parametrize("build", ["build_model", "init_params"])
def test_model_builds_wait_for_captures(build):
    """Building a model draws its layers from the device's default
    generator, which a capture holds: build_model and init_params wait
    while the capture lock is held, and go on once it is let go."""
    x = np.zeros((1, 32), np.float32)
    model = pmodels.MLP(device="cpu")
    calls = {"build_model": lambda: pmodels.build_model("mlp", device="cpu"),
             "init_params": lambda: pmodels.init_params(model, x)}
    done = threading.Event()

    def work():
        calls[build]()
        done.set()

    with CAPTURE_LOCK:
        th = threading.Thread(target=work)
        th.start()
        assert not done.wait(0.2)
    th.join(30)
    assert done.is_set()
