"""PyTorch port: the records of runtime/tracking.py on the CPU.

A phase and a span each keep a record (start and end in perf_counter ns,
thread CPU, parent, round, counts), a plain tuple that the garbage
collector stops tracking once it has closed; a phase's two synchronizes
are child records named "sync", taken under the capture lock, and its
(name, seconds), phase_log and summary are what they were before records.  `count` lands on the
innermost open record, `latest` finds each name's newest Tracker, and the
in-memory broker's gets count every wake on their "fed.get" records.
"""

from __future__ import annotations

import gc
import threading
import time

import pytest

from flashe_tpu_torch.device import CAPTURE_LOCK
from flashe_tpu_torch.fed.consts import ARBITER
from flashe_tpu_torch.fed.inmem import InMemBroker, InMemFederation
from flashe_tpu_torch.fed.transport import default_parties
from flashe_tpu_torch.runtime import tracking
from flashe_tpu_torch.runtime.tracking import (Tracker, count, latest, phase,
                                               set_round, set_tracker, span)


@pytest.fixture
def fresh():
    """A Tracker installed in this thread for the test, then removed."""
    def make(name="t", synchronize=None):
        t = Tracker(name, synchronize)
        set_tracker(t)
        return t
    yield make
    set_tracker(Tracker())


def _spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_nested_records_parent_and_round(fresh):
    calls = []
    t = fresh(synchronize=lambda: calls.append(1))
    with span("before"):
        pass
    set_round(4)
    with phase("outer"):
        with span("inner"):
            with span("leaf"):
                pass
    set_round(5)
    with span("after"):
        pass
    recs = t.read()
    got = [(r.name, r.parent, r.round) for r in recs]
    assert got == [("before", -1, -1), ("outer", -1, 4), ("sync", 1, 4),
                   ("inner", 1, 4), ("leaf", 3, 4), ("sync", 1, 4),
                   ("after", -1, 5)]
    assert len(calls) == 2
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_a_phase_waits_for_the_card_outside_captures(fresh):
    """A phase's two synchronizes run under the capture lock, so that
    neither waits for a stream another thread is capturing."""
    held = []
    fresh(synchronize=lambda: held.append(CAPTURE_LOCK.locked()))
    with phase("work"):
        assert not CAPTURE_LOCK.locked()
    assert held == [True, True]


@pytest.mark.parametrize("child_s", [0.0, 0.02])
def test_self_time_and_self_cpu(fresh, child_s):
    t = fresh()
    with span("outer", cpu=True):
        _spin(0.01)
        with span("child", cpu=True):
            _spin(child_s)
            with span("grandchild", cpu=True):
                _spin(0.005)
    outer, child, grand = t.read()
    wall, cpu = t.self_times()

    def dur(r):
        return r.end_ns - r.start_ns

    # only a record's own children are taken off it
    assert wall == [dur(outer) - dur(child), dur(child) - dur(grand),
                    dur(grand)]
    assert cpu == [outer.cpu_ns - child.cpu_ns, child.cpu_ns - grand.cpu_ns,
                   grand.cpu_ns]
    assert wall[0] >= 0.01e9 and wall[1] >= child_s * 1e9
    # a spinning record's CPU is its wall time, less the reads of the
    # clocks at its ends; its self CPU may pass its self time by the
    # microseconds a child's own reads take
    assert 0 <= cpu[2] <= wall[2]
    assert 0 <= cpu[0] <= wall[0] + 50_000


def test_a_sleeping_span_takes_wall_time_not_cpu(fresh):
    t = fresh()
    with span("sleep", cpu=True):
        time.sleep(0.05)
    (r,) = t.read()
    assert r.end_ns - r.start_ns >= 0.05e9
    assert 0 <= r.cpu_ns <= r.end_ns - r.start_ns
    assert r.cpu_ns < 0.025e9


def test_a_span_reads_the_thread_clock_only_when_asked(fresh):
    """A span without cpu=True reads no thread clock: its CPU stays in
    its parent's self CPU, as a phase's own work."""
    t = fresh()
    with phase("outer"):
        with span("fed.get"):
            _spin(0.01)
        with span("host sync", cpu=True):
            pass
    outer, get, sync = t.read()
    assert get.cpu_ns is None and sync.cpu_ns is not None
    wall, cpu = t.self_times()
    assert cpu[1] is None and wall[1] >= 0.01e9
    assert cpu[0] == outer.cpu_ns - sync.cpu_ns


def test_an_open_record_has_no_self_time(fresh):
    t = fresh()
    with span("open"):
        with span("done"):
            pass
        wall, cpu = t.self_times()
        assert wall[0] is None and cpu[0] is None and wall[1] >= 0


@pytest.mark.parametrize("counted", [False, True])
def test_closed_records_leave_the_collector(fresh, counted):
    """A closed record holds only names and numbers, so one collection
    stops tracking it, and a job's records never lengthen a full
    collection; an open record is a tuple as well."""
    t = fresh()
    with span("outer"):
        with span("inner"):
            if counted:
                count("host_syncs", 2)
        gc.collect()
        assert all(type(r) is tuple for r in t.records)
        assert not gc.is_tracked(t.records[1])
        assert t.read()[0].end_ns is None
    gc.collect()
    assert not any(gc.is_tracked(r) for r in t.records)
    assert t.read()[1].counts == ({"host_syncs": 2} if counted else None)


@pytest.mark.parametrize("where", ["innermost", "no record open"])
def test_count_lands_on_the_innermost_record(fresh, where):
    t = fresh()
    if where == "innermost":
        with span("outer"):
            count("a")
            with span("inner"):
                count("b", 3)
                count("b")
        assert [r.counts for r in t.read()] == [{"a": 1}, {"b": 4}]
    else:
        # dropped: the path counts only inside its spans
        count("b", 2)
        with span("closed"):
            pass
        count("b")
        assert [r.counts for r in t.read()] == [None]


def test_latest_is_the_newest_tracker_of_each_name():
    first = Tracker("latest_a")
    other = Tracker("latest_b")
    assert latest()["latest_a"] is first
    second = Tracker("latest_a")
    found = latest()
    assert found["latest_a"] is second and found["latest_b"] is other
    found.clear()  # a copy: the registry keeps its names
    assert tracking.latest()["latest_a"] is second


@pytest.mark.parametrize("sync_s", [None, 0.03])
def test_phase_keeps_its_seconds_log_and_summary(fresh, sync_s):
    calls = []

    def synchronize():
        calls.append(time.perf_counter())
        time.sleep(sync_s)

    seen = []

    class Seeing(Tracker):
        def record_phase(self, name, seconds):
            seen.append((name, seconds, time.perf_counter()))
            super().record_phase(name, seconds)

    t = Seeing("phase_t", synchronize if sync_s else None)
    set_tracker(t)
    try:
        t_in = time.perf_counter()
        with phase("encoding"):
            body = time.perf_counter()
            time.sleep(0.01)
        t_out = time.perf_counter()
    finally:
        set_tracker(Tracker())
    ((name, seconds, at),) = seen
    assert name == "encoding"
    assert t.phase_log == [("encoding", seconds)]
    assert t.summary() == {"encoding": {"total_s": seconds, "count": 1}}
    assert dict(t.phase_counts) == {"encoding": 1}
    # from after the opening synchronize to after the closing one
    assert at - seconds <= body + 2e-3 and seconds >= 0.01
    names = [r.name for r in t.read()]
    if sync_s:
        assert len(calls) == 2
        assert at - seconds >= calls[0] + sync_s
        assert seconds >= 0.01 + sync_s
        assert names == ["encoding", "sync", "sync"]
        outer, s0, s1 = t.read()
        assert s0.end_ns - s0.start_ns >= sync_s * 1e9
        assert outer.start_ns <= s0.start_ns and s1.end_ns <= outer.end_ns
    else:
        assert calls == [] and names == ["encoding"]
        assert seconds <= t_out - t_in


def _await_waiters(broker, n, timeout=10.0):
    """Until n gets wait on the broker's condition."""
    end = time.monotonic() + timeout
    while len(broker._cond._waiters) != n:
        assert time.monotonic() < end, "the gets never waited"
        time.sleep(0.001)


def test_broker_wakeups_land_on_each_get():
    broker = InMemBroker()
    parties = default_parties(n_hosts=1)
    guest, host, arbiter = parties
    feds = {p.role: InMemFederation(broker, "job", p, parties)
            for p in parties}
    trackers, got = {}, {}

    def waiter(role, tag):
        def run():
            trackers[role] = t = Tracker(f"wake_{role}")
            set_tracker(t)
            got[role] = feds[role].get(f"arbiter_to_{role}", tag, arbiter,
                                      timeout=30)
        return run

    def arbiter_role():
        trackers[ARBITER] = t = Tracker("wake_arbiter")
        set_tracker(t)
        got[ARBITER] = feds[ARBITER].get("guest_to_arbiter", "early", guest,
                                         timeout=30)

    feds["guest"].remote("e", "guest_to_arbiter", "early", arbiter)
    threads = [threading.Thread(target=waiter("guest", "g"), daemon=True),
               threading.Thread(target=waiter("host", "h"), daemon=True)]
    for th in threads:
        th.start()
    _await_waiters(broker, 2)
    # a put for neither wakes both; then each one's own put
    feds[ARBITER].remote("x", "arbiter_to_guest", "neither", guest)
    _await_waiters(broker, 2)
    feds[ARBITER].remote("g", "arbiter_to_guest", "g", guest)
    _await_waiters(broker, 1)
    feds[ARBITER].remote("h", "arbiter_to_host", "h", host)
    third = threading.Thread(target=arbiter_role, daemon=True)
    third.start()
    for th in threads + [third]:
        th.join(timeout=30)
        assert not th.is_alive()
    assert got == {"guest": "g", "host": "h", ARBITER: "e"}
    recs = {role: t.read() for role, t in trackers.items()}
    assert [(r.name, r.counts) for r in recs["guest"]] == [
        ("fed.get", {"wakeups": 2})]
    assert [(r.name, r.counts) for r in recs["host"]] == [
        ("fed.get", {"wakeups": 3})]
    # the arbiter's message was there: no wait, nothing counted
    assert [(r.name, r.counts) for r in recs[ARBITER]] == [
        ("fed.get", None)]
