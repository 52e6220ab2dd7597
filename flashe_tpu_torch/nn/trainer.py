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

On a CUDA device a step is replayed as a CUDA graph.  Each training and
evaluation step is a function over tensors that stay in place (the
parameters, their gradients, the optimizer's moments, a static batch and
the outputs), keyed by its mode and batch shape: the first step of a key
runs eagerly on the side stream a capture uses (its warm-up), the second
captures the function and replays it, and every later step copies its
batch into the static one and replays, on the thread's current stream.
A replay runs the kernels the
eager step launches, and the host launches them at once instead of one at
a time: the numbers are an eager step's, bit for bit under torch's
deterministic algorithms (under its default ones the embedding's backward
on the card sums in an order that varies from run to run, eager or
replayed).  A key whose eager step drew from the model's generator
(dropout) stays eager, since a replay would repeat the draw, and its later
steps run as they ran before graphs, on the current stream; so does every
step on the CPU.  Each step counts itself as "graph_steps" or
"eager_steps" in the record open around it.  Captures run one at a time in
the process, under device.CAPTURE_LOCK, which the warm-ups, the program's
waits for the whole card and its model builds also take, and in
thread-local capture mode, so that the other threads keep launching the
rest of their work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flashe_tpu_torch.device import CAPTURE_LOCK, resolve_device
from flashe_tpu_torch.runtime.tracking import count, span

__all__ = ["LocalTrainer", "make_optimizer", "OptaxAdam", "OptaxRMSprop"]


def _capturing(t: torch.Tensor) -> bool:
    """True while the calling thread's current stream captures a CUDA graph
    and `t` lies on the card."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _bias_corrections(b1: float, b2: float, t: int):
    """1 - b1^t and 1 - b2^t as float32 tensors on the host, as optax takes
    them: torch divides by a python float as a product with its
    reciprocal, which rounds otherwise."""
    count_ = torch.tensor(float(t))
    return [1 - torch.tensor(b, dtype=torch.float32) ** count_
            for b in (b1, b2)]


class _Corrections:
    """Adam's bias corrections for `block` counts from `first`, a float32
    table on the device, and a row counter on the device that each step
    reads and advances, so that a step copies nothing from the host and a
    CUDA graph of it reads the row of the count it replays.  `at` is the
    count the row points at, as the host knows it."""

    def __init__(self, b1: float, b2: float, device, block: int):
        self.b = (b1, b2)
        self.block = block
        self.table = torch.empty(block, 2, dtype=torch.float32,
                                 device=device)
        self.row = torch.zeros(1, dtype=torch.long, device=device)
        self.first = None
        self.at = None

    def seek(self, t: int):
        """Point the row at count t: host work, outside a capture; a count
        past the block refills the table in place, one copy a block."""
        if self.first is None or not self.first <= t < self.first + \
                self.block:
            host = torch.stack([torch.stack(_bias_corrections(*self.b, c))
                                for c in range(t, t + self.block)])
            # a copy to the card waits
            with span("host sync", cpu=True):
                count("host_syncs")
                self.table.copy_(host)
            self.first, self.at = t, None
        if self.at != t:
            self.row.fill_(t - self.first)
            self.at = t

    def take(self, t: int, capturing: bool):
        """(bc1, bc2) of count t, read on the device by the row, which
        advances; a capture takes the row a `seek` set before it."""
        if not capturing:
            self.seek(t)
        elif self.at != t:
            raise RuntimeError("OptaxAdam.seek() must run before a step "
                               "is captured")
        bc = self.table.index_select(0, self.row)[0]
        self.row.add_(1)
        if not capturing:
            self.at += 1
        return bc[0], bc[1]


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam(lr): mu and nu from zero, bias corrections 1 - b^t taken
    in float32 as optax takes them, update -lr mu_hat / (sqrt(nu_hat) +
    eps).  torch.optim.Adam computes the same rule with its corrections in
    float64: 1 - 0.999 in float32 is 1.3e-5 relative off, so its first steps
    differ from optax's by 6e-6 relative.

    The corrections of BLOCK counts at a time sit on the parameters' device
    (`_Corrections`), each computed on the host as before and copied once a
    block, so that a step waits for no copy and a CUDA graph can replay
    it.  They stay out of `state`: state_dict is optax's state, `count` a
    host int, `mu` and `nu`.  A caller that replays a captured step calls
    `seek()` before the capture and each replay, and `advance()` after each
    replay, which does the host's half of the step."""

    BLOCK = 1024

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr, b1=0.9, b2=0.999, eps=1e-8))
        self._tables = {}  # (b1, b2, device) -> _Corrections

    def _table(self, group, p) -> _Corrections:
        key = (group["b1"], group["b2"], p.device)
        if key not in self._tables:
            self._tables[key] = _Corrections(*key, self.BLOCK)
        return self._tables[key]

    def _leaves(self, stepped: bool):
        """(group, leaf, state) of every leaf with a state, or with a
        gradient if `stepped`."""
        for group in self.param_groups:
            for p in group["params"]:
                if (p.grad is not None) if stepped else p in self.state:
                    yield group, p, self.state[p]

    def seek(self):
        """Point each table's row at the count its leaves' next step
        takes; host work, outside a capture."""
        for group, p, state in self._leaves(False):
            if state:
                self._table(group, p).seek(state["count"] + 1)

    def advance(self):
        """The host's half of a step that a CUDA graph replayed: each
        stepped leaf's count and each table's row, as step() advances
        them."""
        tables = set()
        for group, p, state in self._leaves(True):
            if state:
                state["count"] += 1
                tables.add(self._table(group, p))
        for table in tables:
            table.at += 1

    @torch.no_grad()
    def step(self, closure=None):
        taken, behind = {}, {}
        for group, p, state in list(self._leaves(True)):
            b1, b2 = group["b1"], group["b2"]
            capturing = _capturing(p)
            if not state:
                if capturing:  # the graph would zero the moments each replay
                    raise RuntimeError("capture a step only after an eager "
                                       "one has made the optimizer's state")
                state.update(count=0, mu=torch.zeros_like(p),
                             nu=torch.zeros_like(p))
            t = state["count"] + 1
            if not capturing:  # a replay's count is advance()'s
                state["count"] = t
            g, mu, nu = p.grad, state["mu"], state["nu"]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            table = self._table(group, p)
            if table not in taken:
                taken[table] = t, table.take(t, capturing)
            first, (bc1, bc2) = taken[table]
            if t != first:
                # a leaf that missed a step's gradient: its own count's
                key = (b1, b2, t, p.device)
                if key not in behind:
                    # a copy to the card waits
                    with span("host sync", cpu=True):
                        count("host_syncs", 2)
                        behind[key] = [c.to(p.device) for c in
                                       _bias_corrections(b1, b2, t)]
                bc1, bc2 = behind[key]
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


_EAGER, _CAPTURE_NEXT = "eager", "capture next"


class _StepGraph:
    """A step captured as a CUDA graph over a static batch (x, y) on
    `stream`, then replayed on the calling thread's current stream: each
    call copies its batch into the static one, runs `before` (host work),
    replays, runs `after` and returns copies of the outputs.  The capture
    itself runs nothing on the card."""

    def __init__(self, fn, x, y, stream, before=None, after=None):
        self.x, self.y = x.clone(), y.clone()
        self.before, self.after = before, after
        if before is not None:
            before()
        self.graph, self.out = self._capture(fn, stream)

    def _capture(self, fn, stream):
        """(the graph of fn over the static batch, its static outputs)."""
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_LOCK, torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(self.x, self.y)
            finally:
                graph.capture_end()
        return graph, out

    def __call__(self, x, y):
        if self.before is not None:
            self.before()
        self.x.copy_(x)
        self.y.copy_(y)
        self.graph.replay()
        if self.after is not None:
            self.after()
        return tuple(t.clone() for t in self.out)


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
        # (mode, batch shape) -> _EAGER, _CAPTURE_NEXT or its _StepGraph
        self._steps = {}
        self._bound = None  # the tensors the graphs were captured over
        self._stream = None  # the side stream of eager steps and captures

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

    def _replayable(self, drew: bool) -> bool:
        """Whether a step whose eager run drew (`drew`) from the model's
        generator may be replayed: on a CUDA device, where it drew
        nothing."""
        return self.device.type == "cuda" and not drew

    def _binding(self) -> list:
        """The addresses of the parameters and the optimizer's tensors,
        which a graph reads and writes where they were at its capture."""
        state = self.optimizer.state
        return [t.data_ptr() for p in self.model.parameters()
                for t in (p, *state.get(p, {}).values())
                if torch.is_tensor(t)]

    def _warm_up(self, fn, x, y):
        """fn(x, y) eagerly, as the first step of a key that a capture may
        follow: on the card on the side stream the captures use, and never
        beside another thread's capture."""
        if self.device.type != "cuda":
            return fn(x, y)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with CAPTURE_LOCK:
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                out = fn(x, y)
            torch.cuda.current_stream().wait_stream(self._stream)
        return out

    def _step(self, mode: str, fn, x, y):
        """One step of `mode`, fn(x, y): eager at its key's first step,
        captured at the second and replayed from then on."""
        key = (mode, tuple(x.shape), tuple(y.shape))
        entry = self._steps.get(key)
        if entry not in (None, _EAGER) and self._binding() != self._bound:
            # a tensor the graphs hold was replaced (a state_dict loaded):
            # they are captured anew
            self._steps = {k: v for k, v in self._steps.items()
                           if not isinstance(v, _StepGraph)}
            self._bound = self._binding()
            entry = self._steps.get(key)
        if entry is None:
            self.model.drew = False
            out = self._warm_up(fn, x, y)
            self._steps[key] = (_CAPTURE_NEXT if self._replayable(
                self.model.drew) else _EAGER)
        elif entry is _EAGER:
            out = fn(x, y)
        else:
            if entry is _CAPTURE_NEXT:
                hooks = ((getattr(self.optimizer, "seek", None),
                          getattr(self.optimizer, "advance", None))
                         if mode == "train" else (None, None))
                entry = self._steps[key] = _StepGraph(
                    fn, x, y, self._stream, *hooks)
            count("graph_steps")
            return entry(x, y)
        count("eager_steps")
        return out

    def _train_step(self, x, y):
        """One minibatch step over tensors that stay in place: forward,
        loss, backward and the optimizer's update; the gradients are set
        to None first, so that a capture's backward makes them in the
        graph's own memory, where every replay writes them."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = _softmax_ce(self.model(x), y, self.pad_id)
        loss.backward()
        self.optimizer.step()
        return (loss.detach(),)

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
                losses += self._step("train", self._train_step, xs[idx],
                                     ys[idx])
        if not losses:
            return 0.0
        mean = torch.stack(losses).double().mean()
        with span("host sync", cpu=True):
            count("host_syncs")
            return float(mean)

    @torch.no_grad()
    def _eval_outputs(self, xb, yb):
        """The batch's mean loss and accuracy, as tensors."""
        logits = self.model(xb)
        loss = _softmax_ce(logits, yb, self.pad_id)
        hit = (torch.argmax(logits, -1) == yb).to(torch.float32)
        if self.pad_id is not None:
            w = (yb != self.pad_id).to(torch.float32)
            acc = torch.sum(hit * w) / torch.clamp(torch.sum(w), min=1.0)
        else:
            acc = hit.mean()
        return loss, acc

    def _eval_step(self, xb, yb):
        loss, acc = self._step("eval", self._eval_outputs, xb, yb)
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
