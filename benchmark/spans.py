"""The program's own records of a window, for the readers that split a
role's time into its own work, host syncs and waits.

Each role's Tracker (flashe_tpu_torch/runtime/tracking.py) keeps a record
a phase or span: start and end on perf_counter's clock in ns, thread CPU
time, parent, round and counts (`Tracker.read()` names the fields).  The
readers find the roles' Trackers after the run by the role names of
`run.out.spans` through `tracking.latest()`; a program that keeps no
records (no `latest`) reads as None, as does a role with none.  A record belongs to the window when
it ends inside [t0, t1]: a phase's record opens before its opening
synchronize, so the window's first "local train" in the train cell, whose
synchronized start is t0, starts that synchronize earlier.
"""

from __future__ import annotations

import numpy as np

__all__ = ["trackers", "window_records", "role_ms", "count_per_round",
           "wakeups_per_wait", "idle_split"]


def trackers(run) -> dict | None:
    """{role: Tracker} of the run's roles, or None where there are none."""
    from flashe_tpu_torch.runtime import tracking

    latest = getattr(tracking, "latest", None)
    if latest is None:
        return None
    found = latest()
    out = {role: found[role] for role in run.out.spans
           if role in found and getattr(found[role], "records", None)}
    return out or None


def window_records(run, tracker):
    """(record, self ns, self CPU ns) of each closed record of `tracker`
    that ends inside the window."""
    lo, hi = run.out.t0 * 1e9, run.out.t1 * 1e9
    recs = tracker.read()
    wall, cpu = tracker.self_times()
    return [(r, w, c) for r, w, c in zip(recs, wall, cpu)
            if r.end_ns is not None and lo < r.end_ns <= hi]


def role_ms(run, role: str, names, what: str) -> float | None:
    """Milliseconds a window round of `role`'s records named in `names`:
    what="cpu" their self CPU, "wall" their whole duration; None where
    the window holds none (that read the thread clock, for "cpu")."""
    found = trackers(run)
    if found is None or role not in found:
        return None
    total, n = 0, 0
    for r, wall, cpu in window_records(run, found[role]):
        value = cpu if what == "cpu" else r.end_ns - r.start_ns
        if r.name in names and value is not None:
            total += value
            n += 1
    if not n:
        return None
    return total / run.out.rounds * 1e-6


def count_per_round(run, role: str, name: str, key: str) -> float | None:
    """The median over the window's rounds of `key` counted on `role`'s
    records named `name`, each record taken in the round it was stamped
    with, so that a round the window holds only in part moves nothing;
    None where the window holds none."""
    found = trackers(run)
    if found is None or role not in found:
        return None
    rounds = {}
    for r, _, _ in window_records(run, found[role]):
        if r.round >= 0:
            n = (r.counts or {}).get(key, 0) if r.name == name else 0
            rounds[r.round] = rounds.get(r.round, 0) + n
    if not any(rounds.values()):
        return None
    return float(np.median(list(rounds.values())))


def wakeups_per_wait(run) -> float | None:
    """All roles' wakeups over their "fed.get" records that waited (one
    wakeup or more) in the window; 1.0 means no get was woken in vain."""
    found = trackers(run)
    if found is None:
        return None
    wakes, waits = 0, 0
    for t in found.values():
        for r, _, _ in window_records(run, t):
            n = (r.counts or {}).get("wakeups", 0) if r.name == "fed.get" \
                else 0
            if n:
                wakes += n
                waits += 1
    return wakes / waits if waits else None


def _depth(starts, ends, at):
    """How many of the intervals (starts, ends; each sorted) hold `at`."""
    return (np.searchsorted(starts, at, "right")
            - np.searchsorted(ends, at, "right"))


def idle_split(run):
    """(waiting s, unspanned s, idle s) of the window's device-idle time.

    Of the roles that have not returned (a role returns when its last
    record ends; at least one must remain), unspanned where one or more is
    outside every record, else waiting where every one is inside a
    "fed.get".  None without device records or program records."""
    if run.trace is None:
        return None
    found = trackers(run)
    if found is None:
        return None
    t0, t1 = run.out.t0, run.out.t1
    busy = np.asarray(run.trace.busy(t0, t1), dtype=float).reshape(-1, 2)
    roles = []
    points = [np.array([t0, t1]), busy.ravel()]
    for t in found.values():
        recs = [r for r in t.read() if r.end_ns is not None]
        if not recs:
            continue
        se = np.array([(r.start_ns, r.end_ns) for r in recs],
                      dtype=float) * 1e-9
        gets = se[[r.name == "fed.get" for r in recs]]
        roles.append((np.sort(se[:, 0]), np.sort(se[:, 1]),
                      np.sort(gets[:, 0]), np.sort(gets[:, 1]),
                      se[:, 1].max()))
        points.append(se.ravel())
    grid = np.unique(np.clip(np.concatenate(points), t0, t1))
    mids = (grid[:-1] + grid[1:]) / 2
    lens = np.diff(grid)
    idle = _depth(busy[:, 0], busy[:, 1], mids) == 0
    unspanned = np.zeros(mids.shape, bool)
    waiting = np.ones(mids.shape, bool)
    anyone = np.zeros(mids.shape, bool)
    for starts, ends, gs, ge, last in roles:
        active = mids < last
        anyone |= active
        unspanned |= active & (_depth(starts, ends, mids) == 0)
        waiting &= ~active | (_depth(gs, ge, mids) > 0)
    waiting &= anyone & ~unspanned
    return (float(lens[idle & waiting].sum()),
            float(lens[idle & unspanned].sum()), float(lens[idle].sum()))
