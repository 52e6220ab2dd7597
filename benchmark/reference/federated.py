"""Federated training rounds, client by client, as the train traffic runs
them: each client trains `epochs` epochs in batches of `batch_size` (its
rows shuffled by torch.randperm from a CPU generator seeded with its seed,
dropout drawn from a generator on the device seeded the same), the secure
round (`codec.aggregate`) gives the model every client installs, and each
client evaluates it on its own rows in batches of 512 and reports that loss
times its degree (its row count).

`start` makes the clients from the initial model and `restore` from a
snapshot of their state between rounds (the check's window round starts
from the state the program held before it); `run_round` runs one round;
`train_rounds` runs the first rounds from the initial model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import codec
from benchmark.reference.optim import Adam

__all__ = ["ClientState", "start", "snapshot", "restore", "local_train",
           "install", "evaluate", "run_round", "train_rounds"]


@dataclass
class ClientState:
    x: torch.Tensor
    y: torch.Tensor
    params: dict  # {leaf: float32 tensor}
    opt: Adam
    perm_gen: torch.Generator  # CPU: the shuffling
    drop_gen: torch.Generator  # on the device: the dropout uniforms


def start(w0: dict, clients, seeds, lr: float) -> list:
    """Each client's state before round 0: the initial model, Adam from
    zero, its generators seeded with its seed."""
    device = next(iter(w0.values())).device
    out = []
    for (x, y), s in zip(clients, seeds):
        params = {k: v.detach().clone().float() for k, v in w0.items()}
        out.append(ClientState(x, y, params, Adam(params, lr),
                               torch.Generator().manual_seed(s),
                               torch.Generator(device).manual_seed(s)))
    return out


def snapshot(st: ClientState) -> dict:
    """The client's state between rounds, as `restore` takes it."""
    return {"params": {k: v.clone() for k, v in st.params.items()},
            "mu": {k: v.clone() for k, v in st.opt.mu.items()},
            "nu": {k: v.clone() for k, v in st.opt.nu.items()},
            "count": st.opt.count, "perm": st.perm_gen.get_state(),
            "drop": st.drop_gen.get_state()}


def restore(x, y, snap: dict, lr: float) -> ClientState:
    """A client on rows (x, y) from a snapshot {"params", "mu", "nu": {leaf:
    tensor}, "count": Adam's steps, "perm", "drop": the states of its CPU
    and device generators}."""
    params = {k: v.detach().clone().float()
              for k, v in snap["params"].items()}
    opt = Adam(params, lr)
    opt.mu = {k: snap["mu"][k].detach().clone().float() for k in params}
    opt.nu = {k: snap["nu"][k].detach().clone().float() for k in params}
    opt.count = int(snap["count"])
    perm = torch.Generator()
    perm.set_state(snap["perm"])
    drop = torch.Generator(x.device)
    drop.set_state(snap["drop"])
    return ClientState(x, y, params, opt, perm, drop)


def local_train(mod, st: ClientState, batch_size: int, epochs: int) -> float:
    """The client's epochs of steps; its mean training loss."""
    n, device = st.x.shape[0], st.x.device
    bs = min(batch_size, n)
    losses = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=st.perm_gen).to(device)
        for b in range(0, n - bs + 1, bs) or [0]:
            idx = perm[b:b + bs]
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in st.params.items()}
            logits = mod.forward(leaves, st.x[idx], lambda shape: torch.rand(
                shape, generator=st.drop_gen, device=device))
            loss = mod.loss(logits.float(), st.y[idx])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            st.opt.step(st.params, dict(zip(leaves, grads)))
            losses.append(loss.detach())
    return float(torch.stack(losses).double().mean())


def install(st: ClientState, model: dict):
    """The client takes the round's model in place of its own."""
    for k, v in model.items():
        st.params[k].copy_(v)


@torch.no_grad()
def evaluate(mod, st: ClientState) -> float:
    """The mean loss of the client's model on its rows, in batches of 512."""
    tot, seen = 0.0, 0
    for b in range(0, st.x.shape[0], 512):
        xb, yb = st.x[b:b + 512], st.y[b:b + 512]
        tot += float(mod.loss(mod.forward(st.params, xb).float(), yb)) \
            * xb.shape[0]
        seen += xb.shape[0]
    return tot / max(seen, 1)


def run_round(mod, layout, states, stats, batch_size: int, epochs: int,
              element_bits: int) -> dict:
    """One round from the clients' `states` (changed in place) and the
    quantizer's `stats` (codec.aggregate's).  Returns {"train_loss",
    "eval_loss": [a client], "fed_loss", "model": the installed model
    (float64 flat), "stats", "step": its quantization step a lane}."""
    train_losses, updates = [], []
    for st in states:
        train_losses.append(local_train(mod, st, batch_size, epochs))
        updates.append(layout.flatten(st.params))
    degree = float(states[0].x.shape[0])
    g, stats, step = codec.aggregate(layout, updates, degree, stats,
                                     element_bits)
    model = layout.unflatten(g.float())
    eval_losses = []
    for st in states:
        install(st, model)
        eval_losses.append(evaluate(mod, st))
    degrees = [float(st.x.shape[0]) for st in states]
    fed = sum(l * d for l, d in zip(eval_losses, degrees)) / sum(degrees)
    return {"train_loss": train_losses, "eval_loss": eval_losses,
            "fed_loss": fed, "model": g, "stats": stats, "step": step}


def train_rounds(mod, w0: dict, clients, seeds, rounds: int, lr: float,
                 batch_size: int, epochs: int, element_bits: int) -> dict:
    """The first `rounds` rounds from w0.  Returns {"train_loss": [[client
    loss] a round], "eval_loss": same, "fed_loss": [a round], "mu": [{leaf:
    first moment} a client, after round 0], "models": [{leaf: tensor} a
    client, after the last round], "states": the clients' states, "stats":
    the quantizer's after the last round}."""
    device = next(iter(w0.values())).device
    layout = codec.Layout({k: v.shape for k, v in w0.items()}, device)
    states = start(w0, clients, seeds, lr)
    stats = None
    out = {"train_loss": [], "eval_loss": [], "fed_loss": [], "mu": None}
    for r in range(rounds):
        got = run_round(mod, layout, states, stats, batch_size, epochs,
                        element_bits)
        stats = got["stats"]
        if r == 0:
            out["mu"] = [{k: v.clone() for k, v in st.opt.mu.items()}
                         for st in states]
        for k in ("train_loss", "eval_loss", "fed_loss"):
            out[k].append(got[k])
    out["models"] = [st.params for st in states]
    out["states"], out["stats"] = states, stats
    return out
