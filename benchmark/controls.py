"""Readings of the control and of the faults, which set the upper end of
each limit (limits/<cell>.json): the reference put in the program's place,
computed in the nearest precision below the configuration's (bfloat16 for
its float32), or with one fault planted in it, at the cell's own size and
on the cell's own inputs for a seed.  Each is planted here, by swapping one
function of the reference for the length of a run, so the reference that
decides `correct` stays plain.  benchmark/tests/test_fedbench_control.py
runs them on the card; the benchmark's own runs do not.

train cells: the control runs the models' forward and backward in
bfloat16; the faults are "frozen" (the optimizer step leaves the state
unchanged), "half_batch" (each loss is the mean over the first half of the
batch), "no_exchange" (each client keeps its own model in place of the
aggregate) and "lane" (one lane of the decrypted sum off by half the
modulus).  Each is read over rounds 0-2 from the seed's model, and over
round 3 from the sound reference's state after round 2 (the window
round's numbers).  agg cells: the control encodes each client's update in
bfloat16; the faults are "half_batch" (the mean over the first half of the
clients), "frozen" (the round returns the model it started from) and
"lane"."""

from __future__ import annotations

import contextlib

import torch

from benchmark import check, inputs
from benchmark.cells import homo_param
from benchmark.reference import (codec, federated, model_module, optim,
                                 strict_fp32)

__all__ = ["readings", "planted"]

TRAIN_FAULTS = ("frozen", "half_batch", "no_exchange", "lane")
AGG_FAULTS = ("frozen", "half_batch", "lane")


@contextlib.contextmanager
def _swap(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _cast(x, dtype):
    return x.to(dtype) if x.is_floating_point() else x


def planted(what: str, mod, int_bits: int):
    """A context in which the reference's train rounds run as `what` (the
    control or a fault) says."""
    if what == "control":
        forward = mod.forward

        def low(p, x, draw=None):
            return forward({k: v.to(torch.bfloat16) for k, v in p.items()},
                           _cast(x, torch.bfloat16), draw).float()
        return _swap(mod, "forward", low)
    if what == "frozen":
        return _swap(optim.Adam, "step", lambda self, params, grads: None)
    if what == "half_batch":
        loss = mod.loss
        return _swap(mod, "loss", lambda logits, y: loss(
            logits[:max(1, logits.shape[0] // 2)],
            y[:max(1, y.shape[0] // 2)]))
    if what == "no_exchange":
        return _swap(federated, "install", lambda st, model: None)
    if what == "lane":
        aggregate = codec.aggregate

        def wrong(layout, updates, degree, stats, element_bits):
            g, stats, step = aggregate(layout, updates, degree, stats,
                                       element_bits)
            g[0] += (1 << (int_bits - 1)) * step[0] / len(updates)
            return g, stats, step
        return _swap(codec, "aggregate", wrong)
    raise ValueError(what)


def _window_reading(got, states, layout) -> dict:
    """A planted run's window round in compare_window's shape: what each
    client holds after it (its own model where the exchange was left
    out)."""
    return {"train_loss": got["train_loss"], "eval_loss": got["eval_loss"],
            "fed_loss": got["fed_loss"],
            "models": [layout.flatten(st.params) for st in states]}


def _train(cell, seed, device):
    cfg, param = cell.config, homo_param(cell)
    q = param.secure_aggregate_args.quantize
    mod = model_module(cfg["reference_model"])
    w0 = inputs.weights(mod, cfg["model_cfg"], seed, device)
    rows = [(torch.as_tensor(x).to(device), torch.as_tensor(y).to(device))
            for x, y in inputs.client_rows(cfg, seed)]
    seeds = inputs.client_seeds(seed, int(cfg["n_clients"]))
    layout = codec.Layout({k: v.shape for k, v in w0.items()}, device)
    degree = float(rows[0][0].shape[0])

    def run():
        return federated.train_rounds(
            mod, w0, rows, seeds, rounds=3, lr=param.learning_rate,
            batch_size=param.batch_size,
            epochs=param.aggregate_every_n_epoch,
            element_bits=q.element_bits)

    def window(snaps):
        states = [federated.restore(x, y, s, param.learning_rate)
                  for (x, y), s in zip(rows, snaps)]
        return check.window_reference(mod, layout, states, degree,
                                      param), states

    truth = run()
    snaps = [federated.snapshot(st) for st in truth["states"]]
    ref_window, _ = window(snaps)
    out = {}
    for what in ("control",) + TRAIN_FAULTS:
        with planted(what, mod, q.int_bits):
            nums = check.compare_train(run(), truth, w0)
            got, states = window(snaps)
        win = check.compare_window(_window_reading(got, states, layout),
                                   ref_window)
        nums["clients_differ"] = max(nums["clients_differ"],
                                     win.pop("clients_differ"))
        out[what] = {**nums, **win}
    return out


def _agg(cell, seed, device, rounds=(0, 3, 10)):
    cfg, tr, param = cell.config, cell.traffic, homo_param(cell)
    q = param.secure_aggregate_args.quantize
    n, degree = int(cfg["n_clients"]), float(cfg["samples_per_client"])
    std = float(tr["delta_std"])
    mod = model_module(cfg["reference_model"])
    w0 = inputs.weights(mod, cfg["model_cfg"], seed, device)
    layout = codec.Layout({k: v.shape for k, v in w0.items()}, device)
    gen = torch.Generator(device)
    base = layout.flatten(w0)
    encode = codec.encode

    def low(u, d, mu, a, levels):
        return encode(u, d, mu.to(torch.bfloat16), a.to(torch.bfloat16),
                      levels).to(torch.float64)

    out = {k: {"gap_steps": 0.0} for k in ("control",) + AGG_FAULTS}
    for r in range(max(rounds) + 1):
        truth, step = check.check_agg_round(layout, base, seed, n, r, degree,
                                            std, q.element_bits, gen)
        if r in rounds:
            stats = None if r == 0 else codec.layer_stats(
                layout, base.double() * degree)
            with _swap(codec, "encode", low):
                control = check.check_agg_round(
                    layout, base, seed, n, r, degree, std, q.element_bits,
                    gen)[0]
            half = codec.aggregate(
                layout, check.agg_updates(gen, seed, range(n // 2), r, base,
                                          std),
                degree, stats, q.element_bits)[0]
            tries = {"control": control, "half_batch": half,
                     "frozen": base.double(), "lane": truth.clone()}
            tries["lane"][0] += (1 << (q.int_bits - 1)) * step[0] / n
            for k, g in tries.items():
                gap = float(((g - truth).abs() / step).max())
                out[k]["gap_steps"] = max(out[k]["gap_steps"], gap)
        base = truth.float()
    return out


def readings(cell, seed: int, device) -> dict:
    """{"control" or a fault: {number: reading}} for one seed."""
    strict_fp32()
    device = torch.device(device)
    if cell.traffic["kind"] == "train":
        return _train(cell, seed, device)
    return _agg(cell, seed, device)
