"""A copy of the benchmark at a size the CPU holds, in a temporary folder:
the harness as it is, with the shakespeare_gru configuration at small
widths (`tiny_gru`) and cells of it under the agg and train traffic.  A
run goes through `run_cell` in a child process whose `benchmark` package
is the copy's, with an optional fault planted in the program first."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHILD = r"""
import json, sys, time
root, cell, fault, trace = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
sys.path[:0] = [root, REPO]
t = time.perf_counter()
import torch
from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.nn import trainer
from flashe_tpu_torch.protocol import aggregator
if fault == "frozen":
    trainer.OptaxAdam.step = lambda self, closure=None: None
elif fault == "half_batch":
    ce = trainer._softmax_ce
    trainer._softmax_ce = lambda lg, lb, pad=None: ce(
        lg[: lg.shape[0] // 2], lb[: lb.shape[0] // 2], pad)
    reduce = aggregator.arbiter_reduce
    aggregator.arbiter_reduce = lambda lanes, *a, **k: reduce(
        lanes[: max(1, len(lanes) // 2)], *a, **k)
elif fault == "no_exchange":
    get = aggregator.Client.aggregate_then_get
    def own(self, flat, *a, **k):
        get(self, flat, *a, **k)
        return flat
    aggregator.Client.aggregate_then_get = own
elif fault == "lane":
    dec = FlasheCipher.decrypt
    def wrong(self, value, idx_list=None):
        out = dec(self, value, idx_list).clone()
        m = (1 << self.int_bits) - 1
        out[0] = (out[0] + (1 << (self.int_bits - 1))) & m
        return out
    FlasheCipher.decrypt = wrong
from benchmark.run import run_cell, forbidden_modules
res, _, _ = run_cell(root, cell, 987654321012, 0.5, trace == "1", "cpu", t)
print(json.dumps({"forbidden": forbidden_modules(), **res}))
""".replace("REPO", repr(REPO))


def make_root(tmp) -> str:
    """A benchmark root under tmp with the tiny cells; returns its path."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "shakespeare_gru.json")) as f:
        cfg = json.load(f)
    layers = cfg["param"]["model_kwargs"]["nn_define"]["config"]["layers"]
    layers[0]["config"].update(input_dim=20, output_dim=8, input_length=10)
    layers[1]["config"]["units"] = 8
    layers[2]["config"]["units"] = 20
    cfg["param"]["batch_size"] = 8
    cfg.update(n_clients=3, samples_per_client=16)
    cfg["data"].update(vocab=20, seq_len=10, min_len=4)
    cfg["model_cfg"] = {"vocab": 20, "embed": 8, "hidden": 8, "seq_len": 10}
    with open(os.path.join(b, "configs", "tiny_gru.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_gru", "source": "test",
                         "file": "benchmark/configs/tiny_gru.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": f"tiny_gru.{t}", "config": "tiny_gru", "traffic": t,
         "chips": 1, "why": "test"} for t in ("agg", "train")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted(
                {w.replace("femnist_cnn.agg", "tiny_gru.agg")
                 .replace("shakespeare_gru.train", "tiny_gru.train")
                 for w in m["workloads"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for t, src in (("agg", "femnist_cnn.agg"),
                   ("train", "shakespeare_gru.train")):
        shutil.copy(os.path.join(b, "limits", f"{src}.json"),
                    os.path.join(b, "limits", f"tiny_gru.{t}.json"))
    return root


def run(root: str, cell: str, fault: str = "none", trace: bool = False):
    """The result line of one CPU run of `cell` under `root`."""
    p = subprocess.run([sys.executable, "-c", CHILD, root, cell, fault,
                        "1" if trace else "0"], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
