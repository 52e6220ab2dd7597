"""Phase tracking, span records and metrics (port of
flashe_tpu/runtime/tracking.py).

Reproduces the reference's observability surface in library form:
- paired begin/end phase timing (the reference's LOGGER.info("begin X") /
  ("end X") instrumentation across jzf_aggregator.py / jzf_quantize.py,
  which produced the paper's phase breakdown: encoding / encryption /
  upload / download / decryption / decoding),
- a per-thread metrics sink (`Tracker`) standing in for fate_flow's
  MySQL-backed Tracking (fate_flow/manager/tracking.py): components call
  `callback_metric`, runners read `tracker().metrics`.

A phase is timed on the host clock.  Work on a CUDA device is asynchronous:
a phase that only enqueues kernels ends before they run, so without a
synchronize it measures the enqueue, and the device time lands in whichever
later phase waits on it.  A Tracker made with `synchronize` (for example
torch.cuda.synchronize) calls it when each phase begins and ends, so that
a phase holds its own device work; it waits for the whole device, the other
threads' work included, and never while another thread captures a CUDA
graph (device.outside_captures).  `phase_log` keeps every phase in the
order it ended, so that a run's phases can be read an iteration at a
time.

Every Tracker also keeps `records`, one a phase or `span`, always: its
name, start and end on `time.perf_counter_ns()`, the thread CPU time spent
inside it (`time.thread_time_ns()`; a phase, its synchronizes and a span
opened with cpu=True read it, other spans leave it None, since on a host
where that clock is a system call, as on the H100 machine's, reading it
around every federation get lengthened a round), the index of the record
that encloses it in the same thread (`parent`, -1 at the top), the round
the role was in (`set_round`, -1 before the first) and the events `count`ed
inside it. perf_counter is CLOCK_MONOTONIC on Linux: the clock the
benchmark places the profiler's device records on, so a record and a kernel
compare directly. A record is a plain tuple of names and numbers,
`Record`'s first six fields and then its counts flat, key and number in
turn (`Tracker.read()` makes each a `Record`), so that the garbage
collector stops tracking it at its first collection once it has closed: a
job's records never lengthen a full collection. A record's self time is its
duration minus its children's, its self CPU its cpu_ns minus those of its
children that read the clock (`Tracker.self_times`). A count made while no
record is open is dropped: the path counts only inside its spans. A phase
opens its record before its opening synchronize, and each synchronize is a
child record named "sync", so a traced run's wait on the card is neither
the phase's own CPU nor outside every record. A `span` only adds a record:
no synchronize, no phase total, no log line. `latest()` finds each name's
newest Tracker once its thread has returned.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict, namedtuple
from itertools import chain
from typing import Callable

from flashe_tpu_torch.device import outside_captures

__all__ = ["phase", "span", "count", "set_round", "tracker", "Tracker",
           "Record", "set_tracker", "latest"]

LOGGER = logging.getLogger("flashe_tpu_torch")

_local = threading.local()
_latest = {}  # name -> the newest Tracker of that name
_ident = threading.get_ident
_perf_ns = time.perf_counter_ns
_thread_ns = time.thread_time_ns


Record = namedtuple(
    "Record", "name start_ns end_ns cpu_ns parent round counts")
Record.__doc__ = """One phase or span; end_ns is None while it is open, and
cpu_ns holds the thread time at its start until it closes (None
throughout where the record does not read the thread clock)."""


class _Span:
    __slots__ = ("tracker", "name", "cpu")

    def __init__(self, tracker_, name, cpu):
        self.tracker = tracker_
        self.name = name
        self.cpu = cpu

    def __enter__(self):
        self.tracker.open(self.name, self.cpu)
        return self

    def __exit__(self, *exc):
        self.tracker.close()


class Tracker:
    def __init__(self, name: str = "",
                 synchronize: Callable[[], None] | None = None):
        self.name = name
        self.synchronize = synchronize
        self.phase_totals = defaultdict(float)
        self.phase_counts = defaultdict(int)
        self.phase_log = []  # list of (name, seconds)
        self.metrics = []  # list of (name, step, value)
        self.records = []  # plain tuples, as they opened (see `read`)
        self.round = -1
        self._open = {}  # thread ident -> [index, counts] of its open records
        self._lock = threading.Lock()
        _latest[name] = self

    def record_phase(self, name: str, seconds: float):
        self.phase_totals[name] += seconds
        self.phase_counts[name] += 1
        self.phase_log.append((name, seconds))

    def callback_metric(self, metric_name: str, step, value):
        self.metrics.append((metric_name, step, value))

    def summary(self) -> dict:
        return {
            k: {"total_s": v, "count": self.phase_counts[k]}
            for k, v in sorted(self.phase_totals.items())
        }

    # -- records -------------------------------------------------------------

    def open(self, name: str, cpu: bool = True) -> int:
        """Open a record in this thread, reading the thread clock if
        `cpu`; returns its index."""
        stack = self._open.get(_ident())
        if stack is None:
            stack = self._open[_ident()] = []
        start = _perf_ns()  # the thread time is read inside the wall time
        cpu0 = _thread_ns() if cpu else None
        with self._lock:
            index = len(self.records)
            self.records.append((name, start, None, cpu0,
                                 stack[-1][0] if stack else -1, self.round))
        stack.append([index, None])
        return index

    def close(self):
        """Close this thread's innermost open record."""
        index, counts = self._open[_ident()].pop()
        name, start, _, cpu0, parent, round_ = self.records[index]
        cpu = None if cpu0 is None else _thread_ns() - cpu0
        end = _perf_ns()
        # the counts follow flat, key, n, key, n...: a tuple that holds a
        # dict or another tuple may stay tracked
        self.records[index] = (name, start, end, cpu, parent,
                               round_, *chain(*(counts or {}).items()))

    def count(self, key: str, n: int = 1):
        """Add n to `key` of this thread's innermost open record; a count
        made while none is open is dropped (the path counts only inside
        its spans)."""
        stack = self._open.get(_ident())
        if not stack:
            return
        top = stack[-1]
        if top[1] is None:
            top[1] = {}
        top[1][key] = top[1].get(key, 0) + n

    def read(self) -> list:
        """The records so far, each a `Record` with its counts a dict."""
        return [Record(*r[:6], dict(zip(r[6::2], r[7::2])) or None)
                for r in list(self.records)]

    def self_times(self):
        """(self ns, self CPU ns) of every record, in `records`' order;
        (None, None) for a record still open, and a self CPU of None
        where the record read no thread clock."""
        recs = self.read()
        wall = [None if r.end_ns is None else r.end_ns - r.start_ns
                for r in recs]
        cpu = [None if r.end_ns is None else r.cpu_ns for r in recs]
        for r in recs:
            if r.end_ns is not None and r.parent >= 0 and \
                    wall[r.parent] is not None:
                wall[r.parent] -= r.end_ns - r.start_ns
                if cpu[r.parent] is not None and r.cpu_ns is not None:
                    cpu[r.parent] -= r.cpu_ns
        return wall, cpu


def tracker() -> Tracker:
    t = getattr(_local, "tracker", None)
    if t is None:
        t = Tracker()
        _local.tracker = t
    return t


def set_tracker(t: Tracker):
    _local.tracker = t


def latest() -> dict:
    """{name: Tracker}: the newest Tracker made under each name in this
    process (one reference a name, so a long-lived process holds as many
    as it has party names; a Tracker made later under a name takes the
    earlier one's place)."""
    return dict(_latest)


def span(name: str, cpu: bool = False) -> _Span:
    """A record of the block in this thread's Tracker, and nothing else;
    with its thread CPU time if `cpu`, for a span whose CPU an enclosing
    record's self CPU must leave out."""
    return _Span(tracker(), name, cpu)


def count(key: str, n: int = 1):
    tracker().count(key, n)


def set_round(i: int):
    """The round this thread's role is in, stamped on its next records."""
    tracker().round = i


@contextlib.contextmanager
def phase(name: str):
    """Paired begin/end wall timing, accumulated per thread, inside a
    record of the same name."""
    t = tracker()
    LOGGER.debug("begin %s", name)
    with _Span(t, name, True):
        if t.synchronize is not None:
            with _Span(t, "sync", True):
                outside_captures(t.synchronize)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if t.synchronize is not None:
                with _Span(t, "sync", True):
                    outside_captures(t.synchronize)
            dt = time.perf_counter() - t0
            t.record_phase(name, dt)
            LOGGER.debug("end %s (%.4fs)", name, dt)
