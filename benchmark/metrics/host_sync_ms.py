"""The guest's wall time in "host sync" spans a window round, ms: the
copies to the host of a round's path (the trainer's losses, the codec's
layer statistics), each of which waits for every thread's work queued on
the card before it (device layer, seen from the host)."""

from benchmark.spans import role_ms


def read(run):
    return role_ms(run, "guest", ("host sync",), "wall")
