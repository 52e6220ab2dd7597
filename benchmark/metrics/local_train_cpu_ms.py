"""The guest's own CPU time in "local train" a window round, ms: the
record's thread CPU less its children's (its host syncs, and in a traced
run the phase's synchronizes).  Beside `local_train_ms`, the phase's wall
time, the rest is waiting: for the GIL, mostly (trainer layer)."""

from benchmark.spans import role_ms


def read(run):
    return role_ms(run, "guest", ("local train",), "cpu")
