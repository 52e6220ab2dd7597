"""The readers of the program's records (benchmark/spans.py): on the CPU,
the idle split and the other readings on records laid out by hand, None
from a program that keeps no records, and every new reader on the tiny
cells; on the card (marker `chip`), the clock the records and the
profiler's device records share."""

import json
import subprocess
import sys
import types

import pytest

from tiny import REPO, make_root, run

from benchmark import metrics
from benchmark.devtrace import DeviceTrace
from flashe_tpu_torch.runtime import tracking
from flashe_tpu_torch.runtime.tracking import Tracker

NEW = ("local_train_cpu_ms", "codec_cpu_ms", "host_sync_ms",
       "broker_wakeups_per_wait", "idle_waiting_share",
       "idle_unspanned_share", "host_syncs_per_round")
NEEDS_CARD = ("idle_waiting_share", "idle_unspanned_share")


def _tracker(name, spans):
    """A Tracker holding closed top-level records (name, start s, end s,
    cpu s, counts[, round]) on perf_counter's clock in ns, as
    tracking.Tracker.close leaves them."""
    t = Tracker(name)
    for rec_name, b, e, cpu, counts, *round_ in spans:
        t.records.append((rec_name, int(b * 1e9), int(e * 1e9),
                          int(cpu * 1e9), -1, round_[0] if round_ else 0,
                          *[x for kv in (counts or {}).items() for x in kv]))
    return t


@pytest.fixture
def laid_out():
    """Two roles over a window of 100-110 s, the card busy 100-101 and
    109-110: of the 8 s idle, both roles wait 103-105, one waits while the
    other has returned 108-109 (3 s waiting), one is outside every record
    105-106 (1 s unspanned), and one works in a span the rest."""
    guest = _tracker("spans_guest", [
        ("encoding", 100, 103, 1.0, None),
        ("fed.get", 103, 107, 0.001, {"wakeups": 3}),
        ("decoding", 107, 108, 0.25, None)])
    host = _tracker("spans_host0", [
        ("fed.get", 100, 105, 0.001, {"wakeups": 1}),
        ("encoding", 106, 107.5, 0.5, None),
        ("fed.get", 107.5, 109.5, 0.001, None)])
    out = types.SimpleNamespace(
        t0=100.0, t1=110.0, rounds=2,
        spans={"spans_guest": [], "spans_host0": []})
    ops = [("k", 99.5, 101.0), ("k", 109.0, 111.0)]
    yield types.SimpleNamespace(out=out, trace=DeviceTrace(ops)), guest, host


def test_the_idle_split_on_laid_out_records(laid_out):
    from benchmark import spans

    run_, guest, host = laid_out
    waiting, unspanned, idle = spans.idle_split(run_)
    assert (waiting, unspanned, idle) == pytest.approx((3.0, 1.0, 8.0),
                                                        abs=1e-6)
    assert spans.wakeups_per_wait(run_) == 2.0  # (3 + 1) / 2 gets that waited
    assert spans.role_ms(run_, "spans_guest", ("encoding", "decoding"),
                         "cpu") == pytest.approx(625.0)
    assert spans.role_ms(run_, "spans_host0", ("fed.get",),
                         "wall") == pytest.approx(3500.0)
    assert spans.role_ms(run_, "spans_guest", ("local train",), "cpu") \
        is None
    assert spans.idle_split(types.SimpleNamespace(out=run_.out,
                                                  trace=None)) is None


def test_host_syncs_per_round_is_the_median_over_stamped_rounds():
    """Counts add up within a round by the round stamped on each record,
    whatever its order; a round cut by the window's edge is outvoted."""
    from benchmark import spans

    guest = _tracker("spans_guest", [
        ("host sync", 100.0, 100.1, 0, {"host_syncs": 1}, 3),  # cut short
        ("host sync", 100.2, 100.3, 0, {"host_syncs": 2}, 4),
        ("decoding", 100.3, 101.0, 0, None, 4),
        ("host sync", 101.0, 101.1, 0, {"host_syncs": 4}, 5),
        ("host sync", 101.2, 101.3, 0, {"host_syncs": 2}, 4),
        ("host sync", 101.5, 101.6, 0, {"host_syncs": 4}, 6),
        ("fed.get", 101.6, 101.7, 0, {"wakeups": 9}, 6),
        ("host sync", 101.8, 101.9, 0, {"host_syncs": 5}, -1)])  # unstamped
    out = types.SimpleNamespace(t0=100.05, t1=110.0, rounds=4,
                                spans={"spans_guest": []})
    run_ = types.SimpleNamespace(out=out, trace=None)
    assert spans.count_per_round(run_, "spans_guest", "host sync",
                                 "host_syncs") == 4.0  # of 1, 4, 4, 4
    assert spans.count_per_round(run_, "spans_guest", "host sync",
                                 "wakeups") is None
    assert spans.count_per_round(run_, "guest", "host sync",
                                 "host_syncs") is None


def test_a_record_counts_where_it_ends(laid_out):
    """A record that starts before the window and ends inside it is the
    window's; one that ends after it is not."""
    from benchmark import spans

    run_, guest, host = laid_out
    run_.out.t0, run_.out.t1 = 101.0, 107.2
    names = [r.name for r, _, _ in spans.window_records(run_, guest)]
    assert names == ["encoding", "fed.get"]


def test_no_records_read_as_none(laid_out, monkeypatch):
    """The parent program's Tracker has no `latest`: every reader leaves
    its metric out."""
    run_, _, _ = laid_out
    assert metrics.read("idle_waiting_share", run_) == pytest.approx(37.5)
    assert metrics.read("idle_unspanned_share.agg", run_) == \
        pytest.approx(12.5)
    monkeypatch.delattr(tracking, "latest")
    for name in NEW:
        assert metrics.read(name, run_) is None
        if name != "local_train_cpu_ms":
            assert metrics.read(name + ".agg", run_) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell", ["tiny_gru.agg", "tiny_gru.train"])
def test_each_new_reader_reads_on_the_tiny_cells(root, cell):
    res = run(root, cell, trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    sfx = ".agg" if cell.endswith("agg") else ""
    for name in NEW:
        if name == "local_train_cpu_ms" and sfx:
            continue
        # the idle split needs the card's records; the CPU has none
        assert (name + sfx in got) == (name not in NEEDS_CARD), name
    value = {k: v["value"] for k, v in got.items()}
    assert 0 < value["codec_cpu_ms" + sfx] <= value["codec_ms" + sfx]
    assert value["host_sync_ms" + sfx] > 0
    assert value["host_syncs_per_round" + sfx] >= 1
    assert value["broker_wakeups_per_wait" + sfx] >= 1.0
    if not sfx:
        assert 0 < value["local_train_cpu_ms"] <= value["local_train_ms"]


CLOCK_CHILD = r"""
import json, sys
import numpy as np
root = sys.argv[1]
sys.path[:0] = [root, REPO]
import torch
from benchmark import drive
from benchmark.cells import load_cell
from benchmark.devtrace import Tracer
from flashe_tpu_torch.runtime import tracking
tracer = Tracer()
out = drive.drive(load_cell(root, "tiny_gru.agg"), 2 ** 31 + 77, 2.0, True,
                  torch.device("cuda", 0), tracer)
trace = tracer.device_trace()
found = tracking.latest()
recs = np.array([(r.start_ns, r.end_ns) for role in out.spans
                 for r in found[role].read()
                 if r.name in ("encryption", "decryption")
                 and r.end_ns is not None], dtype=float) * 1e-9
kern = np.array([(b, e) for n, b, e in trace.ops
                 if "flashe_mask_kernel" in n and out.t0 <= b
                 and e <= out.t1], dtype=float)
# each kernel against the record that holds it best: how far it overhangs
over = np.maximum(np.maximum(recs[None, :, 0] - kern[:, None, 0],
                             kern[:, None, 1] - recs[None, :, 1]), 0.0)
best = over.min(axis=1)
print(json.dumps({"kernels": len(kern), "records": len(recs),
                  "worst_s": float(best.max()),
                  "median_s": float(np.median(best))}))
""".replace("REPO", repr(REPO))


@pytest.mark.chip
def test_mask_kernels_lie_inside_the_crypto_records(card, tmp_path):
    """A traced phase ends after a synchronize, so each mask launch runs
    inside the "encryption" or "decryption" record that launched it, on
    the clock the records and the profiler share."""
    root = make_root(tmp_path)
    p = subprocess.run([sys.executable, "-c", CLOCK_CHILD, root],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    print("clock test:", res)
    assert res["kernels"] >= 20 and res["records"] >= res["kernels"]
    assert res["worst_s"] <= 50e-6
