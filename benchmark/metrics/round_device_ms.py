"""The card's busy time a window round, ms: the union of the profiler's
device records over the window, over the rounds completed in it.  What a
round costs the card, and the floor of the round once the host's work is
cut.  Read wherever the run holds the device's records (the profiler runs
in untraced runs of a cell that reports this metric)."""


def read(run):
    if run.trace is None:
        return None
    out = run.out
    busy = sum(e - b for b, e in run.trace.busy(out.t0, out.t1))
    return busy / out.rounds * 1e3
