"""The two kinds of traffic, driven through the program's normal path: one
thread a role over the in-memory federation (runtime/simulate.py::
run_roles), as `python -m flashe_tpu_torch submit -c CONFIG` runs a job.

- "train": each role is nn/homo_nn.py's HomoNNGuest / HomoNNHost /
  HomoNNArbiter, and one `fit` of each runs set-up and window.  Rounds 0-2
  are set-up (the rounds the reference follows: the trackers' metric
  callbacks keep each client's losses, its Adam moments after round 0 and
  its model after round 2); the window runs from the first client's "local
  train" of round 3 to the last role's return.  One window round, drawn
  from the seed, is followed too: each client's state before it (model,
  Adam's moments, generators) and its losses and model after it.  The
  arbiter's convergence broadcast ends the fit at the first round that
  finishes after `seconds` (and after that round): the configuration's
  early stop is turned on, on the "abs" rule, with eps at -inf until then
  and at +inf after.  (A second `fit` would start a
  fresh aggregator, whose quantizer begins again from its prior
  statistics.)
- "agg": no local training.  Each client sends its global model plus a
  seeded delta through protocol/aggregator.py's Client.aggregate_then_get,
  then send_loss and the convergence broadcast, as HomoNNClient.fit does;
  the arbiter runs aggregate_and_broadcast, aggregate_loss and
  send_converge_status.  After the warm-up rounds every role meets at a
  barrier, where the window starts; the arbiter's convergence broadcast
  ends it at the first round that finishes after `seconds`.

Every role installs a SpanTracker, which keeps each phase's start and end;
in a traced run it synchronizes the card at each phase's ends.  What the
check needs of the program's outputs is kept in `Outcome.program`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import inputs
from benchmark.cells import Cell, derive_seed, homo_param
from benchmark.reference import model_module
from flashe_tpu_torch.nn.homo_nn import (HomoNNArbiter, HomoNNGuest,
                                         HomoNNHost)
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import flashe_mask
from flashe_tpu_torch.protocol import aggregator
from flashe_tpu_torch.runtime.simulate import run_roles
from flashe_tpu_torch.runtime.tracking import Tracker, set_tracker

__all__ = ["SpanTracker", "Outcome", "drive"]


class SpanTracker(Tracker):
    """A Tracker that also keeps (name, start, end) of every phase, on the
    host's perf_counter clock."""

    def __init__(self, name, synchronize=None):
        super().__init__(name, synchronize)
        self.spans = []
        self.on_metric = None  # called with each callback_metric

    def record_phase(self, name, seconds):
        end = time.perf_counter()
        super().record_phase(name, seconds)
        self.spans.append((name, end - seconds, end))

    def spans_named(self, name):
        return [s for s in self.spans if s[0] == name]

    def callback_metric(self, metric_name, step, value):
        super().callback_metric(metric_name, step, value)
        if self.on_metric is not None:
            self.on_metric(metric_name, step, value)


@dataclass
class Outcome:
    kind: str
    t0: float = 0.0  # window start, perf_counter seconds
    t1: float = 0.0  # window end
    rounds: int = 0
    # the window's rounds: at the arbiter (agg), between the guest's round
    # ends (train)
    round_s: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)  # role -> [(name, b, e)]
    launches: dict = field(default_factory=dict)  # mask launches by mode
    lanes: int = 0
    int_bits: int = 0
    clients: int = 0
    train_rows: int = 0  # rows a round through a training step
    eval_rows: int = 0  # rows a round through an evaluation forward
    program: dict = field(default_factory=dict)  # what the check compares
    inputs: dict = field(default_factory=dict)  # what the reference needs


def _sync(device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def _mask_launches():
    return dict(flashe_mask.mode_launches)


def _delta_launches(before):
    return {k: v - before[k] for k, v in flashe_mask.mode_launches.items()}


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device,
          tracer=None) -> Outcome:
    kind = cell.traffic["kind"]
    if kind == "train":
        return _train(cell, seed, seconds, trace, device, tracer)
    if kind == "agg":
        return _agg(cell, seed, seconds, trace, device, tracer)
    raise ValueError(f"unknown traffic kind {kind!r}")


def _roles(n_clients, guest_fn, host_fn, arbiter_fn, synchronize, traced,
           trackers=None, hooks=None):
    """run_roles with a SpanTracker in each role (kept in `trackers` as
    the roles run, each with its `hooks[role]` as on_metric); returns
    (trackers, results, ends) where ends holds each role's return time
    after a synchronize of the card."""
    trackers = {} if trackers is None else trackers
    hooks = hooks or {}
    ends = {}

    def wrap(name, fn, *args):
        t = SpanTracker(name, synchronize if traced else None)
        t.on_metric = hooks.get(name)
        set_tracker(t)
        trackers[name] = t
        out = fn(*args)
        synchronize()
        ends[name] = time.perf_counter()
        return out

    results = run_roles(
        n_clients - 1,
        lambda trv: wrap("guest", guest_fn, trv),
        lambda trv, h: wrap(f"host{h}", host_fn, trv, h),
        lambda trv: wrap("arbiter", arbiter_fn, trv),
        timeout=300.0)
    return trackers, results, ends


# -- train -------------------------------------------------------------------

def _moment(trainer, key: str) -> dict:
    """Adam's moment `key` ("mu" or "nu") of every leaf, in the flax
    layout (zeros before the first step)."""
    model, state = trainer.model, trainer.optimizer.state
    return model.flax_view({n: state[p][key] if p in state
                            else torch.zeros_like(p)
                            for n, p in model.named_parameters()})


def _client_state(trainer) -> dict:
    """A client's state between two rounds, as the reference's
    federated.restore takes it: its model, Adam's moments and step count,
    and its generators' states."""
    state = trainer.optimizer.state
    count = [s["count"] for s in state.values()]
    return {"params": trainer.params, "mu": _moment(trainer, "mu"),
            "nu": _moment(trainer, "nu"),
            "count": int(count[0]) if count else 0,
            "perm": trainer._perm_gen.get_state(),
            "drop": trainer.model.generator.get_state()}


WARM_TRAIN = 3  # rounds 0-2: set-up, and the rounds the reference follows


def _train(cell, seed, seconds, trace, device, tracer):
    cfg = cell.config
    param = homo_param(cell)
    # one fit runs set-up and window; the program's own convergence
    # broadcast ends it ("abs": converged once the mean loss is below eps)
    param.max_iter = 1 << 30
    param.early_stop_enabled, param.early_stop = True, "abs"
    param.eps = float("-inf")
    n = int(cfg["n_clients"])
    shards = inputs.client_rows(cfg, seed)
    mod = model_module(cfg["reference_model"])
    w0 = inputs.weights(mod, cfg["model_cfg"], seed, device)
    seeds = inputs.client_seeds(seed, n)
    clients = [HomoNNGuest(param, seed=seeds[0], device=device)] + [
        HomoNNHost(param, seed=seeds[i], device=device) for i in range(1, n)]
    arbiter = HomoNNArbiter(param, device=device)
    for c, (x, _) in zip(clients, shards):
        c._build(x[:1])
        c.trainer.set_model_weights(w0)
    sync = _sync(device)
    trackers = {}
    prog = {"train_loss": [[None] * n for _ in range(WARM_TRAIN)],
            "mu": [None] * n, "models": [None] * n,
            "window": {"before": [None] * n, "after": [None] * n,
                       "train_loss": [None] * n, "eval_loss": [None] * n}}
    rng = np.random.default_rng(derive_seed(seed, inputs.SAMPLE))
    state = {"t0": None, "before": None, "picked": None, "ends": []}

    def window_start():
        return min(t.spans_named("local train")[WARM_TRAIN][1]
                   for k, t in trackers.items() if k != "arbiter")

    ends_of_rounds = []  # the guest's rounds, perf_counter at each end

    def client_metric(i):
        def hook(name, it, value):
            win = prog["window"]
            if name == "eval_loss" and it == state["picked"]:
                win["eval_loss"][i] = float(value)
            if name != "train_loss":
                return
            if i == 0:
                ends_of_rounds.append(time.perf_counter())
            picked = state["picked"]
            if picked is not None and it == picked - 1:
                win["before"][i] = _client_state(clients[i].trainer)
            elif it == picked:
                win["after"][i] = clients[i].trainer.params
                win["train_loss"][i] = float(value)
            if it >= WARM_TRAIN:
                return
            prog["train_loss"][it][i] = float(value)
            if it == 0:
                prog["mu"][i] = _moment(clients[i].trainer, "mu")
            if it == WARM_TRAIN - 1:
                prog["models"][i] = clients[i].trainer.params
        return hook

    def arbiter_metric(name, it, value):
        if name != "mean_loss":
            return
        state["ends"].append(time.perf_counter())
        if it == WARM_TRAIN - 1:  # every client has decrypted round 2
            state["before"] = _mask_launches()
            # the window round the check follows, drawn from the seed
            # among the first four fifths of the rounds the window should
            # hold; every client takes its state before it after this
            # broadcast
            est = state["ends"][-1] - state["ends"][-2]
            expect = max(1, int(0.8 * seconds / est))
            state["picked"] = WARM_TRAIN + int(rng.integers(expect))
        elif it >= WARM_TRAIN:
            if state["t0"] is None:
                state["t0"] = window_start()
            if (time.perf_counter() - state["t0"] >= seconds
                    and it >= state["picked"]):
                param.eps = float("inf")

    hooks = {"guest": client_metric(0), "arbiter": arbiter_metric}
    hooks.update({f"host{h}": client_metric(1 + h) for h in range(n - 1)})
    if tracer is not None:
        tracer.start()
    _, _, ends = _roles(
        n, lambda trv: clients[0].fit(trv, *shards[0]),
        lambda trv, h: clients[1 + h].fit(trv, *shards[1 + h]),
        arbiter.fit, sync, trace, trackers, hooks)
    if tracer is not None:
        tracer.stop()
    t0 = window_start()
    rounds = len(arbiter.loss_history) - WARM_TRAIN
    marks = [t0] + ends_of_rounds[WARM_TRAIN:]
    samples = int(cfg["samples_per_client"])
    bs = min(param.batch_size, samples)
    per_epoch = (samples // bs) * bs
    prog["fed_loss"] = [float(v) for v in arbiter.loss_history[:WARM_TRAIN]]
    prog["window"].update(round=state["picked"], fed_loss=float(
        arbiter.loss_history[state["picked"]]))
    return Outcome(
        "train", t0, max(ends.values()), rounds,
        round_s=[b - a for a, b in zip(marks, marks[1:])],
        spans={k: v.spans for k, v in trackers.items()},
        launches=_delta_launches(state["before"]),
        lanes=clients[0].codec.total,
        int_bits=param.secure_aggregate_args.quantize.int_bits,
        clients=n,
        train_rows=n * per_epoch * param.aggregate_every_n_epoch,
        eval_rows=n * samples,
        program=prog,
        inputs={"mod": mod, "model_cfg": cfg["model_cfg"], "w0": w0,
                "shards": shards, "seeds": seeds, "param": param})


# -- agg ---------------------------------------------------------------------

def _agg(cell, seed, seconds, trace, device, tracer):
    cfg, tr = cell.config, cell.traffic
    param = homo_param(cell)
    args = param.secure_aggregate_args.to_dict()
    n = int(cfg["n_clients"])
    mod = model_module(cfg["reference_model"])
    w0 = inputs.weights(mod, cfg["model_cfg"], seed, device)
    codecs = [WeightsCodec(w0, device=device) for _ in range(n)]
    w0flat = codecs[0].flatten(w0)
    degree = float(cfg["samples_per_client"])
    std = float(tr["delta_std"])
    warm = int(tr["warmup_rounds"])
    sync = _sync(device)
    rng = np.random.default_rng(derive_seed(seed, inputs.SAMPLE))
    state = {"sampled": {0}, "t0": None, "before": None}
    round_s = []
    snaps = [dict() for _ in range(n)]  # client -> {round: model}
    prev = {}  # round -> the model the round started from

    def begin():
        """The barrier's action: the window starts with the card idle."""
        sync()
        steady = round_s[1:] or round_s
        expect = max(1, int(0.8 * seconds / float(np.mean(steady))))
        picks = rng.choice(expect, size=min(int(tr["sampled_rounds"]),
                                            expect), replace=False)
        state["sampled"] |= {warm + int(p) for p in picks}
        state["before"] = _mask_launches()
        state["t0"] = time.perf_counter()

    barrier = threading.Barrier(n + 1, action=begin)

    def client(trv, i, role):
        agg = aggregator.with_role(
            role, trv, sparsity=param.sparsity,
            secure_aggregate=param.secure_aggregate,
            secure_aggregate_args=args, device=device)
        agg.set_codec(codecs[i])
        g = w0flat.clone()
        gen = torch.Generator(device)
        r = 0
        while True:
            if r == warm:
                sync()
                barrier.wait()
            flat = inputs.delta(gen, seed, i, r, g, std)
            if i == 0 and r in state["sampled"]:
                prev[r] = g.clone()
            out = agg.aggregate_then_get(flat, iter_index=r, before=g,
                                         degree=degree, suffix=(r,))
            if r in state["sampled"]:
                snaps[i][r] = out.clone()
            g = out
            agg.send_loss(degree, degree=degree, suffix=(r,))
            if agg.get_converge_status(suffix=(r, "conv")):
                return r
            r += 1

    def arbiter(trv):
        agg = aggregator.with_role(
            "arbiter", trv, sparsity=param.sparsity,
            secure_aggregate=param.secure_aggregate,
            secure_aggregate_args=args, device=device)
        r = 0
        while True:
            if r == warm:
                sync()
                barrier.wait()
            ts = time.perf_counter()
            agg.aggregate_and_broadcast(iter_index=r, suffix=(r,))
            agg.aggregate_loss(suffix=(r,))
            stop = r >= warm and time.perf_counter() - state["t0"] >= seconds
            agg.send_converge_status(lambda s=stop: s, (), suffix=(r, "conv"))
            round_s.append(time.perf_counter() - ts)
            if stop:
                return r
            r += 1

    if tracer is not None:
        tracer.start()
    trackers, results, ends = _roles(
        n, lambda trv: client(trv, 0, "guest"),
        lambda trv, h: client(trv, 1 + h, "host"), arbiter, sync, trace)
    t1 = max(ends.values())
    if tracer is not None:
        tracer.stop()
    last = results["arbiter"]
    return Outcome(
        "agg", state["t0"], t1, last - warm + 1, round_s=round_s[warm:],
        spans={k: v.spans for k, v in trackers.items()},
        launches=_delta_launches(state["before"]),
        lanes=codecs[0].total,
        int_bits=param.secure_aggregate_args.quantize.int_bits,
        clients=n,
        program={"snaps": snaps, "prev": prev},
        inputs={"mod": mod, "w0": w0, "w0flat": w0flat, "degree": degree,
                "std": std, "seed": seed, "param": param})
