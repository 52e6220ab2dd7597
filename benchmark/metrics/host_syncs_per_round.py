"""The guest's copies between host and card that wait for the card, a
window round: the `host_syncs` counted on its "host sync" spans, the
median over the rounds the records are stamped with (device layer, seen
from the host).  Beside `host_sync_ms`, the wall time of the same spans,
it tells a few long waits from many short ones."""

from benchmark.spans import count_per_round


def read(run):
    return count_per_round(run, "guest", "host sync", "host_syncs")
