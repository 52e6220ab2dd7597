"""The reader of `train_graph_share` on records laid out by hand: 100%
where every step of the guest's window replayed, 0% where none did, the
share between, and None where no step was counted or the program keeps
no records; on the tiny train cell on the CPU, which never replays, 0%."""

import types

import pytest

from tiny import make_root, run

from benchmark import metrics
from flashe_tpu_torch.runtime import tracking
from flashe_tpu_torch.runtime.tracking import Tracker


def _run(records, name="graph_share_guest"):
    """A window of 100-110 s over a guest whose closed records are
    (name, start s, end s, counts)."""
    t = Tracker(name)
    for rec, b, e, counts in records:
        t.records.append((rec, int(b * 1e9), int(e * 1e9), None, -1, 3,
                          *[x for kv in (counts or {}).items() for x in kv]))
    out = types.SimpleNamespace(t0=100.0, t1=110.0, rounds=2,
                                spans={name: []})
    return types.SimpleNamespace(out=out, trace=None), t


@pytest.fixture
def guest_name(monkeypatch):
    """The reader reads the role named "guest": the laid-out Tracker takes
    its place among the newest Trackers."""
    def use(t):
        monkeypatch.setitem(tracking._latest, "guest", t)
    return use


@pytest.mark.parametrize("counts, share", [
    ([{"graph_steps": 2}, {"graph_steps": 1}], 100.0),
    ([{"eager_steps": 2}, {"eager_steps": 1}], 0.0),
    ([{"eager_steps": 1, "graph_steps": 1}, {"graph_steps": 2}], 75.0),
    ([None, {"host_syncs": 2}], None)])
def test_the_share_of_replayed_steps(guest_name, counts, share):
    run_, t = _run([("local train", 101, 102, counts[0]),
                    ("evaluate", 103, 104, counts[1]),
                    # outside the window, or in another record: not read
                    ("local train", 99, 99.5, {"eager_steps": 9}),
                    ("host sync", 105, 106, {"eager_steps": 9})])
    run_.out.spans = {"guest": []}
    guest_name(t)
    got = metrics.read("train_graph_share", run_)
    assert got == (None if share is None else pytest.approx(share))


def test_no_records_read_as_none(guest_name, monkeypatch):
    run_, t = _run([("local train", 101, 102, {"graph_steps": 2})])
    run_.out.spans = {"guest": []}
    guest_name(t)
    assert metrics.read("train_graph_share", run_) == 100.0
    monkeypatch.delattr(tracking, "latest")
    assert metrics.read("train_graph_share", run_) is None


def test_the_tiny_train_cell_reads_no_replay_on_the_cpu(tmp_path):
    res = run(make_root(tmp_path), "tiny_gru.train", trace=True)
    assert res["correct"] is True
    assert res["metrics"]["train_graph_share"] == {"value": 0.0, "unit": "%"}
