"""Local training harness (port of flashe_tpu/nn/trainer.py; reference
KerasNNModel, jzf_nn_model.py:117-218).

A torch trainer over one client's data: minibatch steps of SGD, Adam or
RMSprop under optax's update rules, loss and accuracy evaluation, params
get/set in the flax layout for the aggregation loop.  The reference's
NNModel interface (nn_model.py:48-51 get/set_model_weights, train,
evaluate, modify) maps 1:1.

Shuffling draws `torch.randperm` from a CPU generator seeded with the
client's `seed`, and dropout from a generator on the model's device seeded
the same; the JAX trainer draws both from threefry keys, so the orders
and masks differ from its, not their distributions.  With the batch at
least the data, the permutation only reorders rows inside the one batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.runtime.tracking import count, span

__all__ = ["LocalTrainer", "make_optimizer", "OptaxAdam", "OptaxRMSprop"]


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam(lr): mu and nu from zero, bias corrections 1 - b^t taken
    in float32 as optax takes them, update -lr mu_hat / (sqrt(nu_hat) +
    eps).  torch.optim.Adam computes the same rule with its corrections in
    float64: 1 - 0.999 in float32 is 1.3e-5 relative off, so its first steps
    differ from optax's by 6e-6 relative."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr, b1=0.9, b2=0.999, eps=1e-8))

    @torch.no_grad()
    def step(self, closure=None):
        corrections = {}
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
                key = (b1, b2, state["count"], p.device)
                if key not in corrections:
                    # float32 tensors on the device, as optax's: torch
                    # divides by a python float as a product with its
                    # reciprocal, which rounds otherwise
                    t = torch.tensor(float(state["count"]))
                    # a copy to the card waits
                    with span("host sync", cpu=True):
                        count("host_syncs", 2)
                        corrections[key] = [
                            (1 - torch.tensor(b, dtype=torch.float32) ** t)
                            .to(p.device) for b in (b1, b2)]
                bc1, bc2 = corrections[key]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                p.add_(-group["lr"] * u)


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr) at its defaults: nu = 0.9 nu + 0.1 g^2 from zero,
    update -lr g / sqrt(nu + eps), eps inside the square root, no bias
    correction, no momentum.  torch.optim.RMSprop differs (alpha 0.99, eps
    outside the root)."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr, decay=0.9, eps=1e-8))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu, g = state["nu"], p.grad
                # optax's operations one by one, each rounded as its are
                nu.mul_(group["decay"]).add_((1 - group["decay"]) * (g * g))
                p.add_(-group["lr"] * (torch.rsqrt(nu + group["eps"]) * g))


def make_optimizer(name: str, learning_rate: float, params):
    """The torch optimizer that computes optax's rule of the same name."""
    name = name.lower()
    if name == "adam":
        return OptaxAdam(params, learning_rate)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name == "rmsprop":
        return OptaxRMSprop(params, learning_rate)
    raise ValueError(f"unknown optimizer {name}")


def _softmax_ce(logits, labels, pad_id=None):
    """Mean softmax CE over integer labels; with pad_id set, positions
    whose label equals pad_id are masked out (Keras Embedding mask_zero
    semantics for the reference's sequence workloads)."""
    labels = labels.long()
    ce = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels.unsqueeze(-1)).squeeze(-1)
    if pad_id is None:
        return ce.mean()
    w = (labels != pad_id).to(ce.dtype)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


class LocalTrainer:
    """Trains `model` (a flashe_tpu_torch.nn.models module that lies on
    `device`) in place; `params`, if given, is a flax params tree loaded
    first."""

    def __init__(self, model, params=None, optimizer: str = "adam",
                 learning_rate: float = 5e-4, seed: int = 0,
                 label_pad_id: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        if params is not None:
            model.params_from_flax(params)
        self.optimizer = make_optimizer(optimizer, learning_rate,
                                        model.parameters())
        self.pad_id = label_pad_id
        self._perm_gen = torch.Generator().manual_seed(seed)
        model.generator = torch.Generator(self.device).manual_seed(seed)

    @property
    def params(self) -> dict:
        return self.model.params_to_flax()

    def get_model_weights(self) -> dict:
        return self.params

    def set_model_weights(self, params):
        # copied into the existing parameters: the optimizer keeps its
        # moments, as the reference resets nothing on modify()
        self.model.params_from_flax(params)

    def modify(self, fn):
        """reference nn_model.modify: params = fn(params)."""
        self.set_model_weights(fn(self.params))
        return self.params

    def _tensor(self, a) -> torch.Tensor:
        # a copy from the host waits for the card
        with span("host sync", cpu=True):
            count("host_syncs")
            return torch.as_tensor(np.asarray(a)).to(self.device)

    def train(self, x: np.ndarray, y: np.ndarray, epochs: int = 1,
              batch_size: int = 128) -> float:
        n = x.shape[0]
        xs, ys = self._tensor(x), self._tensor(y)
        self.model.train()
        losses = []
        for _ in range(epochs):
            perm = torch.randperm(n, generator=self._perm_gen)
            with span("host sync", cpu=True):
                count("host_syncs")
                perm = perm.to(self.device)
            for b in range(0, n - batch_size + 1, batch_size) or [0]:
                idx = perm[b:b + batch_size]
                self.optimizer.zero_grad(set_to_none=True)
                loss = _softmax_ce(self.model(xs[idx]), ys[idx], self.pad_id)
                loss.backward()
                self.optimizer.step()
                losses.append(loss.detach())
        if not losses:
            return 0.0
        mean = torch.stack(losses).double().mean()
        with span("host sync", cpu=True):
            count("host_syncs")
            return float(mean)

    @torch.no_grad()
    def _eval_step(self, xb, yb):
        logits = self.model(xb)
        loss = _softmax_ce(logits, yb, self.pad_id)
        hit = (torch.argmax(logits, -1) == yb).to(torch.float32)
        if self.pad_id is not None:
            w = (yb != self.pad_id).to(torch.float32)
            acc = torch.sum(hit * w) / torch.clamp(torch.sum(w), min=1.0)
        else:
            acc = hit.mean()
        with span("host sync", cpu=True):
            count("host_syncs", 2)
            return float(loss), float(acc)

    def evaluate(self, x: np.ndarray, y: np.ndarray,
                 batch_size: int = 512) -> Tuple[float, float]:
        n = x.shape[0]
        self.model.eval()
        tot_loss, tot_acc, seen = 0.0, 0.0, 0
        for b in range(0, n, batch_size):
            xb, yb = self._tensor(x[b:b + batch_size]), \
                self._tensor(y[b:b + batch_size])
            loss, acc = self._eval_step(xb, yb)
            k = xb.shape[0]
            tot_loss += loss * k
            tot_acc += acc * k
            seen += k
        return tot_loss / max(seen, 1), tot_acc / max(seen, 1)

    @torch.no_grad()
    def predict(self, x: np.ndarray, batch_size: int = 512) -> np.ndarray:
        self.model.eval()
        outs = [torch.softmax(self.model(self._tensor(x[b:b + batch_size])),
                              -1).cpu().numpy()
                for b in range(0, x.shape[0], batch_size)]
        return np.concatenate(outs) if outs else np.zeros((0,))
