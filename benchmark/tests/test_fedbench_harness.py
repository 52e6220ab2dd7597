"""The harness on the CPU at a small size: it runs a cell that only data
files add (a configuration, a traffic mix, limits and a metric reader),
reports what the contract asks for, refuses to run without a card, and
reads `correct` false when the timed path is broken underneath."""

import json
import os
import subprocess
import sys

import pytest

from tiny import REPO, make_root, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def test_a_cell_of_new_files_runs_with_no_code_edit(tmp_path):
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"kind": "agg", "warmup_rounds": 1, "delta_std": 1e-3,
                   "sampled_rounds": 2, "why": "test"}, f)
    with open(os.path.join(b, "metrics", "dummy_rounds.py"), "w") as f:
        f.write("def read(run):\n    return float(run.out.rounds)\n")
    with open(os.path.join(b, "limits", "tiny_gru.dummy_mix.json"), "w") as f:
        json.dump({"gap_steps": 1.5, "clients_differ": 0.0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny_gru.dummy_mix",
                               "config": "tiny_gru", "traffic": "dummy_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "dummy_rounds", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "round_ms",
        "workloads": ["tiny_gru.dummy_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = run(root, "tiny_gru.dummy_mix", trace=True)
    assert res["correct"] is True
    assert res["metrics"]["dummy_rounds"]["value"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"dummy_rounds"}
    assert res["forbidden"] == []


@pytest.mark.parametrize("cell", ["tiny_gru.agg", "tiny_gru.train"])
def test_result_line(root, cell):
    res = run(root, cell)
    traced = run(root, cell, trace=True)
    agg = cell.endswith("agg")
    sfx = ".agg" if agg else ""
    assert traced["correct"] is True
    assert {f"codec_ms{sfx}", f"crypto_ms{sfx}",
            f"arbiter_aggregate_ms{sfx}"} <= set(traced["metrics"])
    assert ("round_p95_ms" in traced["metrics"]) == agg
    assert ("round_ms.agg" in traced["metrics"]) == agg
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    # round_device_ms, the agg cell's time, needs the card's records
    assert set(res["metrics"]) == ({"setup_s"} if agg
                                   else {"round_ms", "setup_s"})
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["forbidden"] == []


@pytest.mark.parametrize("cell,fault", [
    ("tiny_gru.agg", "half_batch"), ("tiny_gru.agg", "no_exchange"),
    ("tiny_gru.agg", "lane"), ("tiny_gru.train", "frozen"),
    ("tiny_gru.train", "half_batch"), ("tiny_gru.train", "no_exchange"),
    ("tiny_gru.train", "lane")])
def test_a_broken_timed_path_reads_incorrect(root, cell, fault):
    res = run(root, cell, fault)
    assert res["correct"] is False, res["checks"]


def test_round_device_ms_reads_the_union_of_device_records():
    import types

    from benchmark import metrics
    from benchmark.devtrace import DeviceTrace

    out = types.SimpleNamespace(t0=1.0, t1=11.0, rounds=4)
    ops = [("a", 0.5, 2.0), ("b", 1.5, 3.0), ("a", 5.0, 6.0),
           ("b", 10.5, 12.0)]  # busy 1-3, 5-6 and 10.5-11 in the window
    run = types.SimpleNamespace(out=out, trace=DeviceTrace(ops))
    assert metrics.read("round_device_ms", run) == pytest.approx(875.0)
    assert metrics.read("round_device_ms", types.SimpleNamespace(
        out=out, trace=None)) is None


def test_a_dotted_metric_reads_as_its_base():
    import types

    from benchmark import metrics

    run = types.SimpleNamespace(out=types.SimpleNamespace(
        t0=0.0, t1=2.0, rounds=4))
    assert metrics.read("round_ms.agg", run) == metrics.read(
        "round_ms", run) == 500.0


def test_no_card_no_result(tmp_path):
    """With the cards hidden, as on a host that has none."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "femnist_cnn.agg", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    import shutil

    shutil.copytree(os.path.join(REPO, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "femnist_cnn.agg", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
