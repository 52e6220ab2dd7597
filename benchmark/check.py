"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference (benchmark/reference).

train traffic: rounds 0-2 of set-up (the same role objects and the same
`fit` the window drives), followed from the seed's model:
- loss_gap: the largest relative gap of a client's training loss or the
  arbiter's federated loss, over the three rounds;
- grad_gap: Adam's first moment after round 0, the worst leaf of the worst
  client: |norm(program) - norm(reference)| over the larger of the
  reference leaf's norm and the median leaf's.  Leaves whose reference
  moment is under a thousandth of the median leaf's are left out here and
  in change_gap (their gradient is nought to rounding);
- change_gap: the model's change after round 2 from the initial one, the
  worst leaf, measured as grad_gap;
and one window round drawn from the seed, followed from the state every
client held before it (its model, Adam's moments and count, its
generators; the quantizer's statistics are worked out again from the
model):
- window_loss_gap: the largest relative gap of a client's training or
  evaluation loss or the federated loss in that round;
- window_gap_steps: the largest gap of the model the guest installs after
  it from the reference's expected-value round, in quantization steps;
- clients_differ: the largest difference of any client's model from the
  guest's after round 2 and after the window round (every client installs
  the same aggregate).

agg traffic (round 0 from the seed's model, and rounds drawn from the seed
among the window's, each from the model the program held before it):
- gap_steps: the largest gap of the model the guest installs from the
  reference's, in quantization steps (below 1 in a sound round);
- clients_differ: as above, at the compared rounds.
"""

from __future__ import annotations

import statistics

import torch

from benchmark import inputs
from benchmark.reference import codec, federated

__all__ = ["check", "compare_train", "compare_window", "window_reference",
           "agg_updates", "check_agg_round"]


def _norm(t) -> float:
    return float(t.detach().double().norm())


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    norms = {k: _norm(ref[k]) for k in ref}
    med = statistics.median(norms.values())
    return max(abs(_norm(prog[k]) - norms[k]) / max(norms[k], med)
               for k in keep)


def _differ(models) -> float:
    """The largest difference of any model (flat) from the first."""
    return max([0.0] + [float((m - models[0]).abs().max())
                        for m in models[1:]])


def compare_train(prog: dict, ref: dict, w0: dict) -> dict:
    """The numbers of rounds 0-2 of a train cell, for a run `prog` against
    the reference run `ref` (both as federated.train_rounds returns them,
    or the program's readings in that shape)."""
    loss_gap = max(_rel(p, r) for pr, rr in zip(prog["train_loss"],
                                                ref["train_loss"])
                   for p, r in zip(pr, rr))
    loss_gap = max([loss_gap] + [_rel(p, r) for p, r in
                                 zip(prog["fed_loss"], ref["fed_loss"])])
    grad_gap, kept = 0.0, set()
    for pm, rm in zip(prog["mu"], ref["mu"]):
        norms = {k: _norm(rm[k]) for k in rm}
        med = statistics.median(norms.values())
        keep = [k for k in rm if norms[k] >= 1e-3 * med]
        kept |= set(keep)
        grad_gap = max(grad_gap, _leaf_gap(pm, rm, keep))
    change_p = {k: prog["models"][0][k] - w0[k] for k in w0}
    change_r = {k: ref["models"][0][k] - w0[k] for k in w0}
    differ = max(float((m[k] - prog["models"][0][k]).abs().max())
                 for m in prog["models"][1:] for k in w0)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": _leaf_gap(change_p, change_r, sorted(kept)),
            "clients_differ": differ}


def compare_window(prog: dict, ref: dict) -> dict:
    """The numbers of a train cell's window round: `prog` is {"train_loss",
    "eval_loss": [a client], "fed_loss", "models": [each client's installed
    model, flat]}, `ref` federated.run_round's result from the same
    state."""
    gap = max(_rel(p, r) for k in ("train_loss", "eval_loss")
              for p, r in zip(prog[k], ref[k]))
    gap = max(gap, _rel(prog["fed_loss"], ref["fed_loss"]))
    steps = float(((prog["models"][0].double() - ref["model"]).abs()
                   / ref["step"]).max())
    return {"window_loss_gap": gap, "window_gap_steps": steps,
            "clients_differ": _differ(prog["models"])}


def _rows(inp, device):
    return [(torch.as_tensor(x).to(device), torch.as_tensor(y).to(device))
            for x, y in inp["shards"]]


def _train_reference(out, device):
    inp = out.inputs
    param = inp["param"]
    return federated.train_rounds(
        inp["mod"], inp["w0"], _rows(inp, device), inp["seeds"], rounds=3,
        lr=param.learning_rate, batch_size=param.batch_size,
        epochs=param.aggregate_every_n_epoch,
        element_bits=param.secure_aggregate_args.quantize.element_bits)


def window_reference(mod, layout, states, degree: float, param) -> dict:
    """federated.run_round from the clients' `states`, with the quantizer's
    statistics worked out from the guest's model (every client holds the
    model the last round installed)."""
    before = layout.flatten(states[0].params).double() * degree
    return federated.run_round(
        mod, layout, states, codec.layer_stats(layout, before),
        param.batch_size, param.aggregate_every_n_epoch,
        param.secure_aggregate_args.quantize.element_bits)


def _check_window(out, device) -> dict:
    inp, win = out.inputs, out.program["window"]
    param = inp["param"]
    layout = codec.Layout({k: v.shape for k, v in inp["w0"].items()}, device)
    states = [federated.restore(x, y, snap, param.learning_rate)
              for (x, y), snap in zip(_rows(inp, device), win["before"])]
    ref = window_reference(inp["mod"], layout, states,
                           float(states[0].x.shape[0]), param)
    prog = {k: win[k] for k in ("train_loss", "eval_loss", "fed_loss")}
    prog["models"] = [layout.flatten(m) for m in win["after"]]
    return compare_window(prog, ref)


def agg_updates(gen, seed, clients, r, base, std) -> list:
    """The agg traffic's updates of `clients` in round r from `base`."""
    return [inputs.delta(gen, seed, i, r, base, std) for i in clients]


def check_agg_round(layout, base, seed, n, r, degree, std, element_bits,
                    gen):
    """The reference's model after agg round r from `base`, the model the
    round started from, with its quantization step: (G, step)."""
    stats = None if r == 0 else codec.layer_stats(layout,
                                                  base.double() * degree)
    g, _, step = codec.aggregate(
        layout, agg_updates(gen, seed, range(n), r, base, std), degree,
        stats, element_bits)
    return g, step


def _check_agg(out, device) -> dict:
    inp = out.inputs
    q = inp["param"].secure_aggregate_args.quantize
    w0 = inp["w0"]
    layout = codec.Layout({k: v.shape for k, v in w0.items()}, device)
    snaps, prev = out.program["snaps"], out.program["prev"]
    gen = torch.Generator(device)
    gap, differ = 0.0, 0.0
    for r in sorted(snaps[0]):
        g, step = check_agg_round(layout, prev[r], inp["seed"], out.clients,
                                  r, inp["degree"], inp["std"],
                                  q.element_bits, gen)
        gap = max(gap, float(((snaps[0][r].double() - g).abs()
                              / step).max()))
        differ = max(differ, _differ([s[r] for s in snaps]))
    return {"gap_steps": gap, "clients_differ": differ}


def check(out, limits: dict, device):
    """[(name, value, limit)] of every compared number; correct when each
    value is at most its limit.  A number without a limit is an error."""
    if out.kind == "train":
        nums = compare_train(out.program, _train_reference(out, device),
                             out.inputs["w0"])
        window = _check_window(out, device)
        window["clients_differ"] = max(window["clients_differ"],
                                       nums["clients_differ"])
        nums.update(window)
    else:
        nums = _check_agg(out, device)
    missing = sorted(set(nums) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [(k, v, limits[k]) for k, v in nums.items()]
