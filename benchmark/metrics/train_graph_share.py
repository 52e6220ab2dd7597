"""The share of the guest's training and evaluation steps in the window
that ran as CUDA graph replays, %: the "graph_steps" counted on its "local
train" and "evaluate" records over those and their "eager_steps" (trainer
layer).  None where the window counts no step, as from a program that
counts none."""

from benchmark.spans import trackers, window_records

NAMES = ("local train", "evaluate")


def read(run):
    found = trackers(run)
    if found is None or "guest" not in found:
        return None
    graph = eager = 0
    for r, _, _ in window_records(run, found["guest"]):
        if r.name in NAMES and r.counts:
            graph += r.counts.get("graph_steps", 0)
            eager += r.counts.get("eager_steps", 0)
    if not graph + eager:
        return None
    return graph / (graph + eager) * 100.0
