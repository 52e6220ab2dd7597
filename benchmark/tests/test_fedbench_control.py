"""The control and the faults, each of which must fail one of a cell's
numbers under its committed limits (controls.py says what each is): on the
card at each cell's own size on three seeds, printing every reading as a
JSON line (`python -m pytest benchmark/tests -m chip -s -q`), and on the
CPU at the tiny cells' size."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import controls
from benchmark.cells import load_cell
from tiny import REPO, make_root

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_each_fault_fail(card, name):
    cell = load_cell(REPO, name)
    missed = []
    for seed in SEEDS:
        got = controls.readings(cell, seed, card)
        print(json.dumps({"cell": name, "seed": seed, "readings": got}))
        for what, nums in got.items():
            if not any(v > cell.limits[k] for k, v in nums.items()
                       if k in cell.limits):
                missed.append((seed, what, nums))
    assert not missed, missed


@pytest.mark.parametrize("name", ["tiny_gru.agg", "tiny_gru.train"])
def test_the_control_and_each_fault_fail_at_a_small_size(tmp_path, name):
    root = make_root(tmp_path)
    code = (f"import json, sys; sys.path[:0] = [{root!r}, {REPO!r}]\n"
            "from benchmark import controls\n"
            "from benchmark.cells import load_cell\n"
            f"cell = load_cell({root!r}, {name!r})\n"
            "print(json.dumps(controls.readings(cell, 2 ** 31 + 11, 'cpu')))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    with open(os.path.join(root, "benchmark", "limits", f"{name}.json")) as f:
        limits = json.load(f)
    assert set(got) == {"control", *(controls.TRAIN_FAULTS
                                     if name.endswith("train")
                                     else controls.AGG_FAULTS)}
    for what, nums in got.items():
        assert any(v > limits[k] for k, v in nums.items()), (what, nums)
