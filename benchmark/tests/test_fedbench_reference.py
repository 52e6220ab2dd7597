"""The plain reference against the port at small sizes on the CPU: the
models' logits and gradients (FemnistCNN with its dropout draws, the
GRU of a Keras nn_define), Adam's moments and step, and one secure round
through the port's quantizer and its mod-2^m sum."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import codec, femnist_cnn, gru_lm
from benchmark.reference.optim import Adam
from flashe_tpu_torch.nn import trainer as port_trainer
from flashe_tpu_torch.nn.models import build_model, init_params
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.quant.quantizer import QuantizingClient


def _gru_define(v, e, h):
    return {"class_name": "Sequential", "config": {"name": "lstm", "layers": [
        {"class_name": "Embedding", "config": {
            "name": "embedding", "input_dim": v, "output_dim": e,
            "mask_zero": True, "input_length": 6}},
        {"class_name": "GRU", "config": {"name": "gru", "units": h,
                                         "return_sequences": True}},
        {"class_name": "Dense", "config": {"name": "dense", "units": v,
                                           "activation": "linear"}}]}}


def _grads(params, loss_fn):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


@pytest.mark.parametrize("train", [False, True])
def test_femnist_cnn_logits_and_gradients(train):
    cpu = torch.device("cpu")
    model = build_model("femnist_cnn", device="cpu")
    init_params(model, np.zeros((1, 28, 28, 1), np.float32))
    w = inputs.weights(femnist_cnn, {"num_classes": 62}, 5, cpu)
    model.params_from_flax(w)
    assert set(w) == set(model.params_to_flax())
    assert sum(v.numel() for v in w.values()) == 1206590
    x = torch.rand(6, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 62, (6,), generator=torch.Generator().manual_seed(2))
    model.train(train)
    model.generator = torch.Generator().manual_seed(77)
    out = model(x)
    loss_p = port_trainer._softmax_ce(out, y)
    loss_p.backward()
    gen = torch.Generator().manual_seed(77)
    draw = (lambda s: torch.rand(s, generator=gen)) if train else None
    loss_r, g = _grads(w, lambda p: femnist_cnn.loss(
        femnist_cnn.forward(p, x, draw), y))
    assert torch.allclose(loss_p, loss_r, rtol=1e-6, atol=0)
    grads_p = model.flax_view({n: p.grad for n, p in model.named_parameters()})
    for k in w:
        assert torch.allclose(grads_p[k], g[k], rtol=1e-4, atol=1e-7), k


def test_gru_logits_and_gradients():
    cpu = torch.device("cpu")
    cfg = {"vocab": 20, "embed": 8, "hidden": 8, "seq_len": 6}
    model = build_model("nn_define", device="cpu",
                        nn_define=_gru_define(20, 8, 8))
    init_params(model, np.zeros((1, 6), np.int32))
    w = inputs.weights(gru_lm, cfg, 9, cpu)
    model.params_from_flax(w)
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 20, (5, 6), generator=gen)
    y = torch.randint(0, 20, (5, 6), generator=gen)
    loss_p = port_trainer._softmax_ce(model(x), y, 0)
    loss_p.backward()
    loss_r, g = _grads(w, lambda p: gru_lm.loss(gru_lm.forward(p, x), y))
    assert torch.allclose(loss_p, loss_r, rtol=1e-6, atol=0)
    grads_p = model.flax_view({n: p.grad for n, p in model.named_parameters()})
    for k in w:
        assert torch.allclose(grads_p[k], g[k], rtol=1e-4, atol=1e-7), k


def test_adam_follows_the_port():
    torch.manual_seed(0)
    p0 = {"a": torch.randn(7, 3), "b": torch.randn(3)}
    ref = {k: v.clone() for k, v in p0.items()}
    opt_r = Adam(ref, 0.01)
    params = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    opt_p = port_trainer.OptaxAdam(params, 0.01)
    for _ in range(3):
        grads = {k: torch.randn_like(v) for k, v in p0.items()}
        for p, g in zip(params, grads.values()):
            p.grad = g.clone()
        opt_p.step()
        opt_r.step(ref, grads)
    for p, (k, v) in zip(params, ref.items()):
        assert torch.equal(p.detach(), v)
        assert torch.equal(opt_p.state[p]["mu"], opt_r.mu[k])


@pytest.mark.parametrize("degree", [16.0, 100.0])
def test_a_secure_round_lies_within_a_step_of_the_reference(degree):
    cpu = torch.device("cpu")
    shapes = {"k": (64, 32), "b": (32,), "e": (500,)}
    port_codec = WeightsCodec({k: torch.zeros(s) for k, s in shapes.items()},
                              device="cpu")
    layout = codec.Layout(shapes, cpu)
    n, eb, m = 3, 16, 20
    qs = []
    for i in range(n):
        q = QuantizingClient(m, False, eb, True, True, seed=i, device="cpu")
        q.set_codec(port_codec)
        q.set_num_clients(n)
        qs.append(q)
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(layout.total, generator=gen) * 0.05
    stats = None
    for r in range(3):
        ups = [g + torch.randn(g.shape, generator=gen) * 0.01
               for _ in range(n)]
        s = sum(q.quantize(q.normalize(u * degree)).to(torch.int64)
                for q, u in zip(qs, ups)) & ((1 << m) - 1)
        outs = []
        for q in qs:
            x = q.unquantize(s.to(torch.int32), None, n) / n
            outs.append(q.unnormalize(x) / degree)
        ref, _, step = codec.aggregate(layout, ups, degree,
                                       None if r == 0 else stats, eb)
        assert float(((outs[0].double() - ref).abs() / step).max()) < 1.05
        assert all(torch.equal(o, outs[0]) for o in outs)
        g = outs[0]
        stats = codec.layer_stats(layout, g.double() * degree)
