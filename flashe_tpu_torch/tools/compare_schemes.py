"""Paper-claims experiment harness on the card: multi-scheme iteration
time / network / economic cost comparison (port of
examples/compare_schemes.py).

Reproduces, from measurements on this machine, the reference's headline
experiment figures (README.md:21-27; produced there by geo-distributed
EC2 runs driven by utils/batch_launch.py + experiments/exp_manager):

- iteration-time speedup of FLASHE vs batched Paillier/BFV/CKKS
  (reference claim: 3.2x-15.1x),
- per-iteration network footprint reduction (claim: 2.1x-42.4x),
- overhead vs plaintext training (claim: <=6% time, 0% traffic),
- economic cost vs plaintext / savings vs batched baselines
  (claim: <=5% / 73%-94%, EC2 pricing model).

Method: for the configured model size (default 1,206,590 params — the
FEMNIST CNN of cnn_flashe_q16_b1_pad) measure on this card
  (a) one local training pass per aggregation round (the real FemnistCNN
      under LocalTrainer, batches_per_round x batch 128),
  (b) per-scheme encode+encrypt / server-add(10) / decrypt+decode wall
      times over quantized 20-bit lanes (16-bit elements +
      ceil(log2(11)) padding bits),
  (c) exact per-client ciphertext bytes on the wire (`wire_bytes`),
then model the WAN with a configurable client<->server bandwidth (default
100 Mbit/s) and price the result with the reference's instance fleet (10x
c5.4xlarge clients + 1x r5.4xlarge server, on-demand us-east) plus
inter-region transfer pricing (`row`, `claims`).

    python -m flashe_tpu_torch.tools.compare_schemes --out results.json
    python -m flashe_tpu_torch.tools.compare_schemes --cpu --params 20000 \\
        --schemes plain,flashe --batches-per-round 2    # CI-sized

Arguments, defaults, constants and formulas are the JAX harness's.  What
differs from it:
- every phase runs on the card unless --cpu asks for the CPU; a timing is
  the host clock around the call with a torch.cuda.synchronize() after
  it (none on the CPU), after one warm call;
- config.platform is the device type, and config.card the card's name and
  power limit as nvidia-smi gives them (torch.cuda.get_device_name where
  nvidia-smi is absent, which config.card_source then says);
- the `flashe` and `flashe+sparse` rows' `correct` is a real check of
  the timed decrypt: ten clients' ciphers (idx 0-9, one seed) encrypt
  their own q (nine of them once, outside the timed region), the server
  add sums the ten ciphertexts through lane_add, and the decrypt must
  equal the sum of the q mod 2^20 lane for lane.  The JAX harness adds one
  client's ciphertext to itself ten times, which no decrypt can verify:
  the same nine lane_adds, so that the times compare;
- each scheme's cipher, calls and check are `tools/schemes.py`'s, which
  bench.py's table2 (`tools/bench.py`) runs too; Paillier packs on the
  host (`batch_lanes_np`), where its big ints live;
- `flashe+sparse` is timed as the JAX harness times it: the dense kernel
  on n/10 lanes, plus the bytes of 21-bit locations.  It does not run the
  sparse round's path S (top-k, the single mask, the scatter decrypt);
- each row carries the kernel launches it made (ops/flashe_mask.py,
  ops/montgomery.py), its timed flow and its check together;
- --write-docs writes docs/COMPARISON_TORCH.md, never docs/COMPARISON.md,
  which holds the JAX run; reference_claims names its source without the
  JAX run's local path.

Emits one JSON document (stdout or --out) and an optional markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.tools import schemes
# the harness's constants, BFV_T among them, are names of this module too
from flashe_tpu_torch.tools.schemes import (BFV_N, BFV_T, CKKS_N, EB,  # noqa: F401
                                            KEY_BITS, M, N_CLIENTS)
from flashe_tpu_torch.tools.timing import launch_counts, timeit

# ---- the reference deployment's price book (on-demand us-east, USD) ----
PRICE_CLIENT_H = 0.68        # c5.4xlarge (reference clients)
PRICE_SERVER_H = 1.008       # r5.4xlarge (reference arbiter)
PRICE_TRANSFER_GB = 0.02     # inter-region transfer (geo-distributed)

SCHEMES = ("plain", "flashe", "flashe+sparse", "paillier+batch", "bfv+batch",
           "ckks+batch")
LOC_BITS = 21                # a sparse location, bit-packed (log2(n) bits)
DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "COMPARISON_TORCH.md")

REFERENCE_CLAIMS = {
    "speedup_vs_batched_baselines": "3.2x-15.1x",
    "traffic_reduction_vs_batched_baselines": "2.1x-42.4x",
    "overhead_vs_plain": "<=6% time, 0% traffic",
    "cost_savings_vs_batched_baselines": "73%-94%",
    "sparse_vs_general_he": ">=13x-63x compute / >=48x traffic",
    "source": "the reference's README.md:21-27",
}


# -- the pure parts: bytes, rows, claims ---------------------------------

def paillier_lanes(n: int, key_bits: int = KEY_BITS) -> int:
    """Ciphertexts a client: n M-bit fields, key_bits // M to a lane."""
    return -(-n // (key_bits // M))


def wire_bytes(scheme: str, n: int, key_bits: int = KEY_BITS,
               q_bits: int | None = None) -> int:
    """Exact bytes one client sends one way (up = down) for n values.
    q_bits: the bit length of the BFV or CKKS ciphertext modulus q."""
    if scheme == "plain":
        return 4 * n  # the raw float32 weights
    if scheme == "flashe":
        return n * M // 8
    if scheme == "flashe+sparse":
        eff = max(1, n // 10)  # top-10%
        return eff * M // 8 + eff * LOC_BITS // 8
    if scheme == "paillier+batch":
        return paillier_lanes(n, key_bits) * (2 * key_bits) // 8
    if scheme in ("bfv+batch", "ckks+batch"):
        degree = BFV_N if scheme == "bfv+batch" else CKKS_N
        slots = degree if scheme == "bfv+batch" else degree // 2
        return -(-n // slots) * 2 * degree * ((q_bits + 7) // 8)
    raise SystemExit(f"unknown scheme {scheme!r}")


def row(scheme: str, meas: dict, t_train: float, bandwidth_mbps: float,
        rounds: int) -> dict:
    """One table row: the measured crypto, the modeled WAN, the fleet's
    cost over `rounds` iterations."""
    bw = bandwidth_mbps * 1e6 / 8  # bytes/s
    t_up = meas["up_bytes"] / bw
    t_down = meas["down_bytes"] / bw
    t_iter = (t_train + meas["client_crypto_s"] + t_up
              + meas["server_add_s"] + t_down)
    gb_iter = (meas["up_bytes"] + meas["down_bytes"]) * N_CLIENTS / 1e9
    # fleet cost for `rounds` iterations: instance-hours + transfer
    hours = t_iter * rounds / 3600
    cost = (hours * (N_CLIENTS * PRICE_CLIENT_H + PRICE_SERVER_H)
            + gb_iter * rounds * PRICE_TRANSFER_GB)
    return {
        "scheme": scheme,
        "client_crypto_s": round(meas["client_crypto_s"], 4),
        "server_add_s": round(meas["server_add_s"], 4),
        "wire_mb_per_client": round(
            (meas["up_bytes"] + meas["down_bytes"]) / 1e6, 3),
        "iteration_s": round(t_iter, 4),
        "cost_usd": round(cost, 2),
        "correct": meas["correct"],
    }


def claims(rows: list) -> dict:
    """The paper's claims from the rows (FLASHE against the batched
    baselines and plaintext; the sparse row against general HE)."""
    by = {r["scheme"]: r for r in rows}
    out = {}
    if "flashe" in by:
        f = by["flashe"]
        for b in ("paillier+batch", "bfv+batch", "ckks+batch"):
            if b in by:
                out[f"speedup_vs_{b}"] = round(
                    by[b]["iteration_s"] / f["iteration_s"], 2)
                out[f"traffic_reduction_vs_{b}"] = round(
                    by[b]["wire_mb_per_client"]
                    / f["wire_mb_per_client"], 2)
                out[f"cost_savings_vs_{b}_pct"] = round(
                    100 * (1 - f["cost_usd"] / by[b]["cost_usd"]), 1)
        if "plain" in by:
            p = by["plain"]
            out["overhead_vs_plain_time_pct"] = round(
                100 * (f["iteration_s"] / p["iteration_s"] - 1), 2)
            out["overhead_vs_plain_traffic_pct"] = round(
                100 * (f["wire_mb_per_client"]
                       / p["wire_mb_per_client"] - 1), 2)
            out["overhead_vs_plain_cost_pct"] = round(
                100 * (f["cost_usd"] / p["cost_usd"] - 1), 2)
    if "flashe+sparse" in by:
        # README.md:22 — sparsification vs general HE: compute = client
        # crypto wall time, traffic = wire bytes
        fs = by["flashe+sparse"]
        for b in ("paillier+batch", "bfv+batch", "ckks+batch"):
            if b in by and fs["client_crypto_s"] > 0:
                out[f"sparse_compute_reduction_vs_{b}"] = round(
                    by[b]["client_crypto_s"] / fs["client_crypto_s"], 1)
                out[f"sparse_traffic_reduction_vs_{b}"] = round(
                    by[b]["wire_mb_per_client"]
                    / fs["wire_mb_per_client"], 1)
    return out


# -- training ---------------------------------------------------------------

def measure_train_step(batches_per_round: int, batch_size: int = 128,
                       device="cuda") -> float:
    """Wall time of one aggregation round's local training: the real
    FemnistCNN (1,206,590 params) under LocalTrainer, like the reference's
    aggregate_every_n_epoch=1 over a client shard.  No TF32: torch's
    defaults stand."""
    from flashe_tpu_torch.nn.models import build_model, init_params
    from flashe_tpu_torch.nn.trainer import LocalTrainer

    dev = resolve_device(device)
    model = build_model("femnist_cnn", device=dev)
    rng = np.random.RandomState(0)
    x = rng.rand(batch_size * batches_per_round, 784).astype(np.float32)
    y = rng.randint(0, 62, x.shape[0]).astype(np.int32)
    params = init_params(model, x[:1])
    tr = LocalTrainer(model, params, device=dev)
    secs, _ = timeit(lambda: tr.train(x, y, epochs=1, batch_size=batch_size),
                     dev)
    return secs


# -- the schemes ----------------------------------------------------------

def check_flashe_sum(n: int, device="cuda", tamper=None) -> bool:
    """The FLASHE rows' check on its own: ten clients (idx 0-9) encrypt q
    of their own (M-bit values from a seed), the ciphertexts are summed
    through lane_add, client 0 decrypts: True iff the decrypt equals the
    sum of the q mod 2^M lane for lane.  `tamper` (tests) may alter the
    aggregate first."""
    dev = resolve_device(device)
    q = np.random.RandomState(1).randint(0, 1 << M, (N_CLIENTS, n))
    cell = schemes.flashe_cell(q, dev)
    agg = cell.add10(cell.encrypt())
    if tamper is not None:
        agg = tamper(agg)
    return cell.check(cell.decrypt(agg))


def measure_scheme(scheme: str, n: int, rng, device="cuda",
                   key_bits: int = KEY_BITS) -> dict:
    """Per-round crypto cost + exact wire bytes for one client.

    Returns {client_crypto_s, server_add_s, up_bytes, down_bytes, correct,
    launches}.  key_bits is the Paillier key's (the tests pass a small
    one; the harness runs the JAX harness's 2048)."""
    dev = resolve_device(device)
    before = launch_counts()
    q_bits = count = None
    if scheme == "plain":
        # plaintext FATE sends the raw float32 weights (no quantization
        # needed, but we charge the same codec flatten cost: ~0)
        meas = {"client_crypto_s": 0.0, "server_add_s": 0.0,
                "correct": True}
    else:
        if scheme in ("flashe", "flashe+sparse"):
            eff_n = n if scheme == "flashe" else max(1, n // 10)  # top-10%
            cell = schemes.flashe_cell(
                rng.randint(0, 1 << EB, (N_CLIENTS, eff_n)), dev)
        elif scheme == "paillier+batch":
            pail = schemes.paillier_cipher(dev, key_bits)
            cell = schemes.paillier_batch_cell(pail,
                                               rng.randint(0, 1 << EB, n))
            count = paillier_lanes(n, key_bits)
        elif scheme == "bfv+batch":
            bfv = schemes.bfv_cipher(dev)
            cell = schemes.bfv_cell(bfv, rng.randint(0, 1 << EB, n))
            count, q_bits = -(-n // BFV_N), bfv.q.bit_length()
        elif scheme == "ckks+batch":
            ck = schemes.ckks_cipher(dev)
            cell = schemes.ckks_cell(ck, rng.randn(n))
            count, q_bits = -(-n // (CKKS_N // 2)), ck.q.bit_length()
        else:
            raise SystemExit(f"unknown scheme {scheme!r}")
        ((t_enc,), (t_add,), (t_dec,)), ct, ok = schemes.run_cell(
            cell, lambda f: timeit(f, dev)[::-1])
        if count is not None:
            _same_count(scheme, len(ct), count)
        meas = {"client_crypto_s": t_enc + t_dec, "server_add_s": t_add,
                "correct": ok}
    nbytes = wire_bytes(scheme, n, key_bits, q_bits)
    after = launch_counts()
    meas.update(up_bytes=nbytes, down_bytes=nbytes, launches={
        k: after[k] - before[k] for k in after if after[k] != before[k]})
    return meas


def _same_count(scheme: str, got: int, want: int):
    if got != want:
        raise AssertionError(f"{scheme}: {got} ciphertexts a client, "
                             f"wire_bytes counts {want}")


# -- the card -------------------------------------------------------------

def card_description(device: torch.device) -> tuple:
    """(card, source): the card's name and power limit as nvidia-smi gives
    them, or torch's name for it where nvidia-smi is absent; (None, None)
    on the CPU."""
    if device.type != "cuda":
        return None, None
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0], "nvidia-smi"
    return (torch.cuda.get_device_name(device),
            "torch.cuda.get_device_name (no nvidia-smi: power limit not "
            "read)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", type=int, default=1_206_590,
                    help="model size in elements (default = FEMNIST CNN)")
    ap.add_argument("--schemes", default=",".join(SCHEMES))
    ap.add_argument("--bandwidth-mbps", type=float, default=100.0,
                    help="client<->server WAN bandwidth model")
    ap.add_argument("--batches-per-round", type=int, default=24,
                    help="local batches per aggregation round (FEMNIST "
                         "shard ~3,000 samples / batch 128)")
    ap.add_argument("--train-s", type=float, default=None,
                    help="skip the training measurement; use this wall "
                         "time per round instead")
    ap.add_argument("--rounds", type=int, default=500,
                    help="training length used for the cost projection")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", help="write the JSON here instead of stdout")
    ap.add_argument("--write-docs", action="store_true",
                    help="render docs/COMPARISON_TORCH.md")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else "cuda")
    n = args.params
    rng = np.random.RandomState(0)

    t_train = (args.train_s if args.train_s is not None
               else measure_train_step(args.batches_per_round, device=dev))

    rows = []
    for scheme in args.schemes.split(","):
        meas = measure_scheme(scheme, n, rng, dev)
        r = row(scheme, meas, t_train, args.bandwidth_mbps, args.rounds)
        r["launches"] = meas["launches"]
        rows.append(r)

    card, source = card_description(dev)
    doc = {
        "config": {"params": n, "clients": N_CLIENTS,
                   "element_bits": EB, "int_bits": M,
                   "bandwidth_mbps": args.bandwidth_mbps,
                   "train_s_per_round": round(t_train, 4),
                   "rounds_for_cost": args.rounds,
                   "platform": dev.type,
                   "card": card, "card_source": source},
        "rows": rows,
        "claims": claims(rows),
        "reference_claims": dict(REFERENCE_CLAIMS),
    }
    out = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(out + "\n")
    else:
        print(out)

    if args.write_docs:
        _write_docs(doc, DOCS)
    return 0


def _write_docs(doc, path):
    cfg = doc["config"]
    where = cfg["card"] or cfg["platform"]
    lines = [
        "# Scheme comparison on the PyTorch port (paper-claims harness)",
        "",
        "Produced by `python -m flashe_tpu_torch.tools.compare_schemes "
        "--write-docs` — the analogue of the reference's EC2 experiment "
        "fleet (`utils/batch_launch.py`, `experiments/`), with crypto and "
        "training phases *measured* on this machine "
        f"(platform: {cfg['platform']}; {where}) and the WAN + pricing "
        f"*modeled* ({cfg['bandwidth_mbps']:.0f} Mbit/s; 10x c5.4xlarge + "
        "r5.4xlarge on-demand + $0.02/GB transfer).",
        "",
        f"Model: {cfg['params']:,} params; local training "
        f"{cfg['train_s_per_round']:.2f} s/round (measured, FemnistCNN); "
        f"cost over {cfg['rounds_for_cost']} rounds.",
        "",
        "| Scheme | client crypto s (measured) | server add s (measured) "
        "| wire MB/client (exact) | iteration s (MODELED WAN) "
        "| fleet cost $ (MODELED) |",
        "|---|---|---|---|---|---|",
    ]
    for r in doc["rows"]:
        lines.append(
            f"| {r['scheme']} | {r['client_crypto_s']} | "
            f"{r['server_add_s']} | {r['wire_mb_per_client']} | "
            f"{r['iteration_s']} | {r['cost_usd']} |")
    lines += [
        "", "## Claims vs the reference", "",
        "The reference column is *measured* on its geo-distributed EC2 "
        "fleet (README.md:21-27); this framework's column combines "
        "measured crypto/training with the modeled WAN/pricing above — "
        "the `basis` column marks which inputs each figure rests on.",
        "",
        "| Claim | reference (measured) | this framework | basis |",
        "|---|---|---|---|"]
    ref = doc["reference_claims"]
    cl = doc["claims"]
    spd = [v for k, v in cl.items() if k.startswith("speedup_vs_")]
    trf = [v for k, v in cl.items()
           if k.startswith("traffic_reduction_vs_")]
    sav = [v for k, v in cl.items() if k.startswith("cost_savings_vs_")]
    if spd:
        lines.append(f"| iteration-time speedup vs batched baselines | "
                     f"{ref['speedup_vs_batched_baselines']} | "
                     f"{min(spd)}x-{max(spd)}x "
                     f"| measured crypto + modeled WAN |")
    if trf:
        lines.append(f"| network footprint reduction | "
                     f"{ref['traffic_reduction_vs_batched_baselines']} | "
                     f"{min(trf)}x-{max(trf)}x | exact byte counts |")
    if "overhead_vs_plain_time_pct" in cl:
        lines.append(
            f"| overhead vs plaintext | {ref['overhead_vs_plain']} | "
            f"{cl['overhead_vs_plain_time_pct']}% time, "
            f"{cl['overhead_vs_plain_traffic_pct']}% traffic "
            f"| measured crypto + modeled WAN |")
    if sav:
        lines.append(f"| economic savings vs batched baselines | "
                     f"{ref['cost_savings_vs_batched_baselines']} | "
                     f"{min(sav)}%-{max(sav)}% | modeled price book |")
    sc = [v for k, v in cl.items()
          if k.startswith("sparse_compute_reduction_vs_")]
    st = [v for k, v in cl.items()
          if k.startswith("sparse_traffic_reduction_vs_")]
    if sc and st:
        lines.append(
            f"| sparsification (s=10%) vs general HE | "
            f"{ref['sparse_vs_general_he']} | "
            f"{min(sc)}x-{max(sc)}x compute / {min(st)}x-{max(st)}x "
            f"traffic | measured crypto + exact byte counts |")
    lines += ["", "Full measurements: the JSON that `--out` names.", ""]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    print(f"# wrote {os.path.normpath(path)}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
