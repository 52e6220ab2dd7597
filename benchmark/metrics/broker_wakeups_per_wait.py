"""Wakeups a waiting federation get takes, over every role in the window:
the in-memory broker wakes every waiting get on every put, so a get that
waited for one message but was woken by others counts each wake.  1.0
means no wake was wasted (roles layer: fed/inmem.py)."""

from benchmark.spans import wakeups_per_wait


def read(run):
    return wakeups_per_wait(run)
