"""Phase tracking and metrics (port of flashe_tpu/runtime/tracking.py).

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
threads' work included.  `phase_log` keeps every phase in the order it
ended, so that a run's phases can be read an iteration at a time.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Callable

__all__ = ["phase", "tracker", "Tracker", "set_tracker"]

LOGGER = logging.getLogger("flashe_tpu_torch")

_local = threading.local()


class Tracker:
    def __init__(self, name: str = "",
                 synchronize: Callable[[], None] | None = None):
        self.name = name
        self.synchronize = synchronize
        self.phase_totals = defaultdict(float)
        self.phase_counts = defaultdict(int)
        self.phase_log = []  # list of (name, seconds)
        self.metrics = []  # list of (name, step, value)

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


def tracker() -> Tracker:
    t = getattr(_local, "tracker", None)
    if t is None:
        t = Tracker()
        _local.tracker = t
    return t


def set_tracker(t: Tracker):
    _local.tracker = t


@contextlib.contextmanager
def phase(name: str):
    """Paired begin/end wall timing, accumulated per thread."""
    t = tracker()
    LOGGER.debug("begin %s", name)
    if t.synchronize is not None:
        t.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if t.synchronize is not None:
            t.synchronize()
        dt = time.perf_counter() - t0
        t.record_phase(name, dt)
        LOGGER.debug("end %s (%.4fs)", name, dt)
