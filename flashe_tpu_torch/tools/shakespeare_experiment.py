"""Convergence-parity and overhead experiment on the Shakespeare workload
(port of examples/shakespeare_experiment.py).

Trains the Shakespeare next-char GRU (the reference's lstm_* workload:
Embedding 83->512 mask_zero, GRU 256 return_sequences, Dense 83 — the
nn_define of examples/configs/lstm_flashe_q16_b1_pad, 654,675 parameters)
federatedly over 9 clients + arbiter with secure aggregation, under both
`flashe` and `plain`, and reports:

- per-round federated train loss and held-out (b.csv) loss/accuracy,
- per-round wall time per scheme -> the flashe-vs-plaintext overhead
  (the reference claims <=6% time overhead, README.md:21),
- a results JSON + markdown table (docs/CONVERGENCE_TORCH.md via
  --write-docs).

    python -m flashe_tpu_torch.tools.shakespeare_experiment --cpu --small \\
        --rounds 2 --limit 64
    python -m flashe_tpu_torch.tools.shakespeare_experiment --rounds 20 \\
        --reps 4 --write-docs                       # on the card

Arguments, defaults, the arm order and the statistics are the JAX
script's.  What differs from it:
- every phase runs on the card unless --cpu asks for the CPU; without
  --cpu and without a card, main raises;
- each client's round_s is host time from the start of its local training
  to the end of get_converge_status, ending in a torch.cuda.synchronize()
  on the card (none on the CPU); the guest's evaluation falls outside it,
  as in JAX.  Each client's record also holds train_s, the local training
  share of the round (the trainer's loss read back ends it);
- `secure_aggregate_args.precompute` is passed as JAX passes it, but the
  port's FLASHE block makes its masks in the kernel's launch (a no-op
  precompute): the flashe arm encrypts inside the round;
- each scheme's record keeps every rep's federated losses
  (fed_loss_reps) and the kernel launches of every rep's run
  (launches_reps, tools/timing.launches_since);
- config records the device, the card's name and power limit as
  nvidia-smi gives them, and the corpus the run read;
- --out defaults to build/flashe_tpu_torch/shakespeare_results.json and
  --write-docs writes docs/CONVERGENCE_TORCH.md; neither touches the JAX
  run's examples/shakespeare_results.json or docs/CONVERGENCE.md.

The dataset (`shakespeare_10`, nine `{i}_a.csv` shards and `b.csv`) is not
in this repository: pass --dataset, or put it at
data/shakespeare.DEFAULT_ROOT.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from flashe_tpu_torch.data import shakespeare
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.nn.keras_define import (count_params_define,
                                              from_nn_define)
from flashe_tpu_torch.nn.models import build_model, init_params
from flashe_tpu_torch.nn.trainer import LocalTrainer
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.protocol import aggregator
from flashe_tpu_torch.runtime.simulate import run_roles
from flashe_tpu_torch.tools.compare_schemes import card_description
from flashe_tpu_torch.tools.timing import (launch_counts, launches_since,
                                           sync)

__all__ = ["gru_define", "run_scheme", "run_experiment", "overhead_stats",
           "write_docs", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOCS = os.path.join(_REPO, "docs", "CONVERGENCE_TORCH.md")
OUT = os.path.join(_REPO, "build", "flashe_tpu_torch",
                   "shakespeare_results.json")


def gru_define(embed: int, hidden: int, vocab: int = 83,
               seq_len: int = 80) -> dict:
    """The reference LSTM-workload architecture as an nn_define dict
    (equivalent to lstm_flashe_q16_b1_pad's, parameterized so --small
    can shrink it)."""
    return {
        "class_name": "Sequential",
        "config": {
            "name": "lstm",
            "layers": [
                {"class_name": "Embedding",
                 "config": {"name": "embedding", "input_dim": vocab,
                            "output_dim": embed, "mask_zero": True,
                            "input_length": seq_len}},
                {"class_name": "GRU",
                 "config": {"name": "gru", "units": hidden,
                            "return_sequences": True}},
                {"class_name": "Dense",
                 "config": {"name": "dense", "units": vocab,
                            "activation": "linear"}},
            ],
        },
    }


def run_scheme(scheme, shards, eval_xy, define, rounds, lr, batch_size,
               n_hosts, device="cuda"):
    """One federated training run; returns the guest's record dict.  Every
    client starts from init_params(seed=0)."""
    dev = resolve_device(device)
    args = {
        "quantize": {"int_bits": 20, "batch": False, "element_bits": 16,
                     "padding": True, "secure": True},
        "precompute": {"enable": scheme == "flashe"},
        "mode": "parallel", "num_partitions": 1,
    }
    xe, ye = eval_xy

    def client_loop(agg, x, y, seed, record_eval):
        model = build_model("nn_define", device=dev, nn_define=define)
        codec = WeightsCodec(init_params(model, x[:1], seed=0), device=dev)
        agg.set_codec(codec)
        trainer = LocalTrainer(model, optimizer="adam",
                               learning_rate=lr, seed=seed,
                               label_pad_id=0, device=dev)
        degree = float(len(x))
        rec = {"train_loss": [], "eval_loss": [], "eval_acc": [],
               "round_s": [], "train_s": []}
        for r in range(rounds):
            t0 = time.perf_counter()
            tl = trainer.train(x, y, epochs=1,
                               batch_size=min(batch_size, len(x)))
            rec["train_s"].append(time.perf_counter() - t0)
            flat = codec.flatten(trainer.params)
            out = agg.aggregate_then_get(flat, iter_index=r, degree=degree,
                                         suffix=(r,))
            trainer.set_model_weights(codec.unflatten(out))
            agg.send_loss(tl * degree, degree=degree, suffix=(r,))
            agg.get_converge_status(suffix=(r, "conv"))
            sync(dev)
            rec["round_s"].append(time.perf_counter() - t0)
            rec["train_loss"].append(float(tl))
            if record_eval:
                el, ea = trainer.evaluate(xe, ye)
                rec["eval_loss"].append(float(el))
                rec["eval_acc"].append(float(ea))
                print(f"  [{scheme}] round {r}: train={tl:.4f} "
                      f"eval={el:.4f} acc={ea:.4f} "
                      f"({rec['round_s'][-1]:.1f}s)", flush=True)
        return rec

    def guest(trv):
        agg = aggregator.Guest(dev).register_aggregator(
            trv, secure_aggregate=scheme, secure_aggregate_args=args)
        x, y = shards[0]
        return client_loop(agg, x, y, seed=0, record_eval=True)

    def host(trv, hid):
        agg = aggregator.Host(dev).register_aggregator(
            trv, secure_aggregate=scheme, secure_aggregate_args=args)
        x, y = shards[1 + hid]
        return client_loop(agg, x, y, seed=1 + hid, record_eval=False)

    def arbiter(trv):
        agg = aggregator.Arbiter(dev).register_aggregator(
            trv, secure_aggregate=scheme, secure_aggregate_args=args)
        losses = []
        for r in range(rounds):
            agg.aggregate_and_broadcast(iter_index=r, suffix=(r,))
            losses.append(agg.aggregate_loss(suffix=(r,)))
            agg.send_converge_status(lambda: False, (), suffix=(r, "conv"))
        return losses

    results = run_roles(n_hosts, guest, host, arbiter)
    rec = results["guest"]
    rec["fed_loss"] = results["arbiter"]
    return rec


def run_experiment(shards, eval_xy, define, rounds=20,
                   schemes=("plain", "flashe"), reps=1, lr=0.01,
                   batch_size=128, small=False, device="cuda",
                   corpus=None) -> dict:
    """main's runs: `reps` paired repetitions of the schemes, the arm
    order alternating per rep (plain, flashe, flashe, plain, ...); returns
    the results dict that main writes (config, schemes, and the overhead
    statistics where both plain and flashe ran)."""
    dev = resolve_device(device)
    n_params = count_params_define(from_nn_define(define, device=dev),
                                   np.zeros((1, shakespeare.SEQ_LEN),
                                            np.int32))
    print(f"model parameters: {n_params:,}")
    card, source = card_description(dev)
    out = {"config": {"rounds": rounds, "small": small,
                      "clients": len(shards), "params": n_params,
                      "batch_size": batch_size, "learning_rate": lr,
                      "reps": reps, "device": str(dev), "card": card,
                      "card_source": source, "corpus": corpus},
           "schemes": {}}
    schemes = list(schemes)
    for rep in range(reps):
        # alternate arm order per rep: both arms share one process, so
        # the second arm always inherits warm cuBLAS handles / allocator
        # state — a fixed order would bias the comparison toward
        # whichever scheme runs second
        order = schemes if rep % 2 == 0 else list(reversed(schemes))
        for scheme in order:
            print(f"== scheme {scheme} (rep {rep + 1}/{reps})")
            before = launch_counts()
            rec = run_scheme(scheme, shards, eval_xy, define, rounds, lr,
                             batch_size, n_hosts=len(shards) - 1,
                             device=dev)
            launched = launches_since(before)
            # drop round 0 from the time stats (each thread's first
            # cuBLAS calls)
            steady = rec["round_s"][1:] or rec["round_s"]
            mean_s = float(np.mean(steady))
            if rep == 0:
                rec["mean_round_s"] = mean_s
                rec["mean_round_s_reps"] = [mean_s]
                rec["round_s_reps"] = [list(map(float, steady))]
                rec["fed_loss_reps"] = [list(rec["fed_loss"])]
                rec["launches_reps"] = [launched]
                out["schemes"][scheme] = rec
            else:
                s = out["schemes"][scheme]
                s["mean_round_s_reps"].append(mean_s)
                s["round_s_reps"].append(list(map(float, steady)))
                s["fed_loss_reps"].append(list(rec["fed_loss"]))
                s["launches_reps"].append(launched)

    if {"plain", "flashe"} <= set(out["schemes"]):
        out.update(overhead_stats(out["schemes"]["plain"],
                                  out["schemes"]["flashe"]))
        print(f"flashe vs plain round time: overhead median "
              f"{out['flashe_overhead_pct']}% "
              f"[{out['flashe_overhead_ci'][0]}%, "
              f"{out['flashe_overhead_ci'][1]}%] 95% CI over "
              f"{out['flashe_overhead_n_pairs']} round pairs "
              f"(rep-level pairs: {out['flashe_overhead_reps']})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None,
                    help="shakespeare_10 root (default: "
                         "data/shakespeare.DEFAULT_ROOT)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--schemes", default="plain,flashe")
    ap.add_argument("--clients", type=int, default=9)
    ap.add_argument("--limit", type=int, default=None,
                    help="rows per client shard")
    ap.add_argument("--eval-limit", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--learning-rate", type=float, default=0.01)
    ap.add_argument("--small", action="store_true",
                    help="embed 64 / GRU 64 instead of 512/256")
    ap.add_argument("--reps", type=int, default=1,
                    help="paired repetitions: schemes alternate per rep "
                         "(plain, flashe, flashe, plain, ...) so drift "
                         "hits both arms; overhead reported as the median "
                         "of per-round pairs with a bootstrap CI")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--write-docs", action="store_true",
                    help="render docs/CONVERGENCE_TORCH.md from the results")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else "cuda")
    root = args.dataset or shakespeare.DEFAULT_ROOT
    shards = shakespeare.load_clients(root, args.clients, args.limit)
    eval_xy = shakespeare.load_eval(root, args.eval_limit)
    sizes = [len(x) for x, _ in shards]
    print(f"clients={len(shards)} shard sizes={sizes} "
          f"eval={len(eval_xy[0])}")

    define = (gru_define(64, 64) if args.small else gru_define(512, 256))
    out = run_experiment(shards, eval_xy, define, args.rounds,
                         args.schemes.split(","), args.reps,
                         args.learning_rate, args.batch_size, args.small,
                         dev, corpus=f"shakespeare_10 CSVs at {root}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    if args.write_docs:
        write_docs(out)
    return 0


def overhead_stats(pl: dict, fl: dict) -> dict:
    """Round-level paired overhead statistics.

    A host's speed drifts between minutes of one run (other work on its
    cores, clocks), so rep-level means can swing and run-level pairing
    cannot cancel it.  Round r of the two arms within one rep runs close
    in time, so the per-round ratio (tf_r - tp_r)/tp_r is drift-paired;
    with R rounds x N reps there are R*N such pairs.  The reported figure
    is their MEDIAN (robust to a stall on one round) with a 95% bootstrap
    confidence interval (2,000 draws from RandomState(0)), plus the
    rep-level pairs for transparency."""
    tps_all = pl.get("round_s_reps") or [pl["round_s"][1:]]
    tfs_all = fl.get("round_s_reps") or [fl["round_s"][1:]]
    ratios = []
    for tp_r, tf_r in zip(tps_all, tfs_all):
        for tp, tf in zip(tp_r, tf_r):
            ratios.append(100.0 * (tf - tp) / tp)
    ratios = np.asarray(ratios)
    med = float(np.median(ratios))
    rng = np.random.RandomState(0)
    boots = [float(np.median(ratios[rng.randint(0, len(ratios),
                                                len(ratios))]))
             for _ in range(2000)]
    lo, hi = np.percentile(boots, [2.5, 97.5])
    rep_ohs = [100.0 * (np.mean(tf_r) - np.mean(tp_r)) / np.mean(tp_r)
               for tp_r, tf_r in zip(tps_all, tfs_all)]
    return {
        "flashe_overhead_pct": round(med, 2),
        "flashe_overhead_ci": [round(float(lo), 2), round(float(hi), 2)],
        "flashe_overhead_n_pairs": len(ratios),
        "flashe_overhead_reps": [round(float(o), 2) for o in rep_ohs],
    }


def write_docs(out, path=DOCS):
    """Render the convergence table and the overhead paragraph of a
    results dict into `path` (docs/CONVERGENCE_TORCH.md)."""
    cfg = out["config"]
    scale = "toy (--small)" if cfg["small"] else "full reference scale"
    where = cfg.get("card") or cfg.get("device", "cpu")
    lines = [
        "# Convergence: Shakespeare next-char GRU, flashe vs plain "
        "(PyTorch port)",
        "",
        f"Federated training on {cfg.get('corpus') or 'shakespeare_10'} "
        "(`python -m flashe_tpu_torch.tools.shakespeare_experiment`) on "
        f"{where}: {cfg['clients']} clients + arbiter, "
        f"{cfg['params']:,}-param GRU (the lstm_flashe_q16_b1_pad "
        f"nn_define), {cfg['rounds']} rounds, batch {cfg['batch_size']}, "
        f"Adam lr={cfg['learning_rate']} — **{scale}**.",
        "",
        "| Round | plain eval loss | plain acc | flashe eval loss "
        "| flashe acc |",
        "|---|---|---|---|---|",
    ]
    pl = out["schemes"].get("plain", {})
    fl = out["schemes"].get("flashe", {})
    n_rounds = max(len(pl.get("eval_loss", [])),
                   len(fl.get("eval_loss", [])))
    for r in range(n_rounds):
        def g(rec, k):
            v = rec.get(k, [])
            return f"{v[r]:.4f}" if r < len(v) else "—"
        lines.append(f"| {r} | {g(pl, 'eval_loss')} | {g(pl, 'eval_acc')} "
                     f"| {g(fl, 'eval_loss')} | {g(fl, 'eval_acc')} |")
    if "flashe_overhead_pct" in out:
        tps = pl.get("mean_round_s_reps", [pl.get("mean_round_s")])
        tfs = fl.get("mean_round_s_reps", [fl.get("mean_round_s")])
        oh = out["flashe_overhead_pct"]
        ci = out.get("flashe_overhead_ci")
        reps = out.get("flashe_overhead_reps", [oh])
        if ci and out.get("flashe_overhead_n_pairs", 0) > len(reps):
            verdict = ("comfortably inside" if ci[1] <= 6.0 else
                       "inside" if oh <= 6.0 else "OUTSIDE")
            lines += [
                "",
                f"Round time (steady state, round 0 excluded; "
                f"{len(reps)} interleaved plain/flashe reps, arm order "
                f"alternating per rep so warm-process bias cancels): "
                f"plain {np.mean(tps):.3f} s, flashe {np.mean(tfs):.3f} s "
                f"-> overhead **{oh:+.2f}%**, 95% bootstrap CI "
                f"[{ci[0]:+.2f}%, {ci[1]:+.2f}%] over "
                f"{out['flashe_overhead_n_pairs']} round-level pairs "
                f"(median of per-round paired ratios, which pairs out the "
                f"host's drift between reps: per-rep overheads "
                f"{', '.join(f'{o:+.1f}%' for o in reps)}).  The CI is "
                f"{verdict} the reference's <=6% claim (README.md:21).",
            ]
        else:
            lines += [
                "",
                f"Round time (steady state, round 0 excluded): plain "
                f"{tps[0]:.3f} s, flashe {tfs[0]:.3f} s -> overhead "
                f"**{oh}%** (single pair — run --reps 3 for error "
                f"bars; reference claim: <=6%, README.md:21).",
            ]
        lines += [
            "",
            "The port's precompute is a no-op: the flashe arm makes its "
            "masks in the kernel's launch, inside the round.",
        ]
    lines += ["", "Raw data: the results JSON of the run (`--out`).", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {os.path.normpath(path)}")


if __name__ == "__main__":
    raise SystemExit(main())
