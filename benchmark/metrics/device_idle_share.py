"""The share of the window in which no operation runs on the card, %,
from the union of the profiler's device records."""


def read(run):
    if run.trace is None:
        return None
    busy = sum(e - b for b, e in run.trace.busy(run.out.t0, run.out.t1))
    return (1.0 - busy / (run.out.t1 - run.out.t0)) * 100.0
